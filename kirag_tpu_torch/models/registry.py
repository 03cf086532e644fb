"""Model alias resolution and the LLM loader (port of
:mod:`kirag_tpu.models.registry`).

There is no network, so aliases and HF repo names resolve to LOCAL mirror
directories: ``$KIRAG_MODEL_DIR/<hf-repo-basename>`` (or pass a path).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

MODEL_MAP = {
    # llama
    "llama2_instruct": "meta-llama/Llama-2-7b-chat-hf",
    "llama3": "meta-llama/Meta-Llama-3-8B-Instruct",
    "llama3_8b": "meta-llama/Meta-Llama-3-8B",
    "llama3_70b_instruct": "meta-llama/Meta-Llama-3-70B-Instruct",
    "llama3.1_8b_instruct": "meta-llama/Llama-3.1-8B-Instruct",
    "llama3.1_70b_instruct": "meta-llama/Llama-3.1-70B-Instruct",
    # mistral
    "mistral_7b": "mistralai/Mistral-7B-v0.1",
    "mistral_7b_instruct": "mistralai/Mistral-7B-Instruct-v0.2",
    # qwen
    "qwen2_7b_instruct": "Qwen/Qwen2-7B-Instruct",
    "qwen2.5_7b_instruct": "Qwen/Qwen2.5-7B-Instruct",
    "qwen2.5_14b_instruct": "Qwen/Qwen2.5-14B-Instruct",
    "qwen2.5_32b_instruct": "Qwen/Qwen2.5-32B-Instruct",
    # encoders
    "e5": "intfloat/e5-large-v2",
    "bge": "BAAI/bge-large-en-v1.5",
    "contriever": "facebook/contriever",
    "bge_reranker": "BAAI/bge-reranker-large",
}


def resolve_model_path(name_or_path: str, model_dir: Optional[str] = None) -> str:
    """Resolve an alias or HF repo name to a local checkpoint directory.

    Order: existing local path as-is -> $KIRAG_MODEL_DIR/<basename of the
    mapped repo> -> $KIRAG_MODEL_DIR/<basename of the given name>.
    """
    if os.path.isdir(name_or_path):
        return name_or_path
    model_dir = model_dir or os.environ.get("KIRAG_MODEL_DIR", "")
    repo = MODEL_MAP.get(name_or_path, name_or_path)
    candidate = os.path.join(model_dir, os.path.basename(repo))
    if model_dir and os.path.isdir(candidate):
        return candidate
    raise FileNotFoundError(
        f"cannot resolve model '{name_or_path}': not a local directory and "
        f"'{candidate}' does not exist. There is no network; mirror checkpoints "
        "under $KIRAG_MODEL_DIR or pass a local path.")


def load_llm_params(name_or_path: str, compute_dtype=None, int8_weights: bool = False,
                    quant_bits: Optional[int] = None, kv_quant_bits: Optional[int] = None,
                    model_dir: Optional[str] = None, device=None):
    """The ``(params, config)`` of a Llama-architecture checkpoint named by an
    alias or a path (:func:`resolve_model_path`), in ``compute_dtype``
    (default bf16), its projections quantized with ``int8_weights`` /
    ``quant_bits`` (4: NF4), on ``device`` (default: the GPU)."""
    from kirag_tpu_torch.models.llm import load_llama

    return load_llama(resolve_model_path(name_or_path, model_dir),
                      compute_dtype=compute_dtype or torch.bfloat16, int8_weights=int8_weights,
                      quant_bits=quant_bits, kv_quant_bits=kv_quant_bits, device=device)


def load_llm(name_or_path: str, tokenizer=None, max_length: int = 4096,
             max_new_tokens: int = 128, batch_size: int = 4, compute_dtype=None,
             model_dir: Optional[str] = None, int8_weights: bool = False,
             quant_bits: Optional[int] = None, device=None) -> Tuple[object, object]:
    """``(tokenizer, Generator)`` for a Llama-architecture chat model: the
    checkpoint through :func:`load_llm_params`, decoded by a
    ``TorchLlamaBackend`` (K6 for 4-bit weights on the GPU). ``tokenizer``
    is injected (the HuggingFace tokenizer of the checkpoint when None,
    which needs ``transformers``); its pad token is set to eos where it has
    none."""
    from kirag_tpu_torch.generation.interface import Generator
    from kirag_tpu_torch.models.llm import TorchLlamaBackend

    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(resolve_model_path(name_or_path, model_dir))
    if getattr(tokenizer, "pad_token_id", None) is None:
        tokenizer.pad_token = tokenizer.eos_token
    params, config = load_llm_params(name_or_path, compute_dtype, int8_weights, quant_bits,
                                     model_dir=model_dir, device=device)
    backend = TorchLlamaBackend(params, config, eos_token_id=tokenizer.eos_token_id)
    generator = Generator(tokenizer, backend, model_name=MODEL_MAP.get(name_or_path, name_or_path),
                          max_length=max_length, max_new_tokens=max_new_tokens,
                          batch_size=batch_size)
    return tokenizer, generator

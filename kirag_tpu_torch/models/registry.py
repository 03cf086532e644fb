"""Model alias resolution (port of ``resolve_model_path`` from
:mod:`kirag_tpu.models.registry`).

There is no network, so aliases and HF repo names resolve to LOCAL mirror
directories: ``$KIRAG_MODEL_DIR/<hf-repo-basename>`` (or pass a path).
"""

from __future__ import annotations

import os
from typing import Optional

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

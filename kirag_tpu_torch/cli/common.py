"""Shared CLI plumbing: tokenizer, encoder, collator and corpus construction
(port of :mod:`kirag_tpu.cli.common`)."""

from __future__ import annotations

import argparse
import logging

import torch

logger = logging.getLogger(__name__)


def add_encoder_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--retriever_name", type=str, default="E5Retriever",
                        choices=["E5Retriever", "BGERetriever", "ContrieverRetriever"])
    parser.add_argument("--retriever_model_name_or_path", type=str, required=True,
                        help="LOCAL path to an HF-format or kirag_tpu-format encoder checkpoint")
    parser.add_argument("--tokenizer_name_or_path", type=str, default=None,
                        help="defaults to retriever_model_name_or_path")
    parser.add_argument("--query_maxlength", type=int, default=512)
    parser.add_argument("--doc_maxlength", type=int, default=512)
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["float32", "bfloat16"])


def add_corpus_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--corpus", type=str, default="2wikimultihopqa",
                        choices=["wikipedia", "hotpotqa", "2wikimultihopqa", "musique"])
    parser.add_argument("--corpus_path", type=str, default=None,
                        help="override the default corpus file location")


def add_mesh_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--mesh_data", type=int, default=None,
                        help="data-axis size: the ranks the index's rows (and a training "
                             "batch's rows) shard over (default: every rank that "
                             "--mesh_model leaves)")
    parser.add_argument("--mesh_model", type=int, default=1,
                        help="model (TP) axis size: the ranks the encoder's weights shard "
                             "over; the index is replicated over it")


def build_mesh(args):
    """The device mesh of ``--mesh_data``/``--mesh_model`` over the ranks that
    torchrun started (``distributed_init`` joins them, NCCL on GPUs), or None
    for one process without mesh flags (port of
    ``kirag_tpu.cli.common.build_mesh``)."""
    from kirag_tpu_torch.parallel import create_mesh, distributed_init

    distributed_init()
    if args.mesh_model == 1 and args.mesh_data is None and not (
            torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1):
        return None  # one process: no mesh machinery
    return create_mesh(data=args.mesh_data, model=args.mesh_model)


def rank_device(mesh, device=None):
    """An entry point's device under ``mesh``: ``device`` when given, else
    the rank's GPU (``distributed_init`` made it current) over a mesh on a
    GPU machine, else None (the entry point's own default)."""
    if device is None and mesh is not None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def build_tokenizer(args):
    """A HuggingFace tokenizer from the checkpoint directory (needs
    ``transformers``)."""
    from transformers import AutoTokenizer

    path = args.tokenizer_name_or_path or args.retriever_model_name_or_path
    tokenizer = AutoTokenizer.from_pretrained(path)
    if tokenizer.pad_token is None or tokenizer.pad_token_id is None:
        logger.warning("Missing padding token, adding a new pad token!")
        tokenizer.add_special_tokens({"pad_token": "[PAD]"})
    return tokenizer


def build_llm_tokenizer(path: str):
    """An LLM's HuggingFace tokenizer (needs ``transformers``), its pad token
    set to eos where it has none."""
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(path)
    if tokenizer.pad_token is None:
        tokenizer.pad_token = tokenizer.eos_token
    return tokenizer


def build_encoder(args, device=None):
    """The encoder named by the arguments, on ``device`` (default: the GPU)."""
    from kirag_tpu_torch.models.encoders import RETRIEVER_NAME_TO_ENCODER, load_encoder

    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    encoder_type = RETRIEVER_NAME_TO_ENCODER[args.retriever_name]
    return load_encoder(args.retriever_model_name_or_path, encoder_type, compute_dtype=dtype,
                        device=device)


def build_collator(args, tokenizer):
    from kirag_tpu_torch.data import COLLATOR_MAP

    return COLLATOR_MAP[args.retriever_name](
        tokenizer=tokenizer, query_maxlength=args.query_maxlength,
        doc_maxlength=args.doc_maxlength)


def build_corpus(args):
    from kirag_tpu_torch.data import CORPUS_MAP

    kwargs = {"title_prefix": "title:", "passage_prefix": "text:"}
    if args.corpus_path:
        kwargs["corpus_path"] = args.corpus_path
    return CORPUS_MAP[args.corpus](**kwargs)

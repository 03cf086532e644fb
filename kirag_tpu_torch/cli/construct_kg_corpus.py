"""Offline knowledge-triple extraction for a whole corpus (port of
:mod:`kirag_tpu.cli.construct_kg_corpus`).

Runs the KGGenerator (the KG LLM over
:class:`~kirag_tpu_torch.models.llm.TorchLlamaBackend`, 512 new tokens a
document) over every corpus document with the triple cache enabled, saving
the cache every ``--save_every`` batches. The LLM's weights load in bf16
from ``--llm``; a loaded ``(params, config)`` pair can be handed in instead,
whose 4-bit projections decode through K6 on the GPU.

Usage:
  python -m kirag_tpu_torch.cli.construct_kg_corpus \\
    --corpus 2wikimultihopqa --llm /ckpts/Meta-Llama-3-8B-Instruct \\
    --cached_kg_triples_file out/kg_cache.pkl
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

import torch

from kirag_tpu_torch.cli.common import add_corpus_args, build_corpus
from kirag_tpu_torch.utils.logging import setup_logger

logger = logging.getLogger(__name__)


def setup_parser(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_corpus_args(parser)
    parser.add_argument("--dataset", type=str, default=None,
                        help="examplar type (defaults to --corpus)")
    parser.add_argument("--llm", type=str, required=True)
    parser.add_argument("--llm_tokenizer", type=str, default=None)
    parser.add_argument("--cached_kg_triples_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--save_every", type=int, default=1000,
                        help="save the cache every N batches")
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--end", type=int, default=None)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, *, llm_tokenizer=None, llm=None,
         device=None) -> str:
    """Run the CLI on ``argv`` (default: the command line). ``llm_tokenizer``
    and ``llm`` (a loaded ``(params, config)`` pair) replace the tokenizer
    and weights that the arguments name; ``device`` is the LLM's (default:
    the GPU). Returns the path of the cache file."""
    from kirag_tpu_torch.cli.common import build_llm_tokenizer
    from kirag_tpu_torch.device import require_cuda
    from kirag_tpu_torch.generation.interface import Generator
    from kirag_tpu_torch.kg import KGGenerator
    from kirag_tpu_torch.models.llm import TorchLlamaBackend, load_llama

    args = setup_parser(argv)
    setup_logger()
    device = require_cuda() if device is None else torch.device(device)
    tokenizer = (llm_tokenizer if llm_tokenizer is not None
                 else build_llm_tokenizer(args.llm_tokenizer or args.llm))
    if llm is None:
        llm = load_llama(args.llm, compute_dtype=torch.bfloat16, device=device)
    params, config = llm
    backend = TorchLlamaBackend(params, config, eos_token_id=tokenizer.eos_token_id)
    generator = Generator(tokenizer, backend, model_name=args.llm, max_length=4096,
                          max_new_tokens=512, batch_size=args.batch_size)

    kg = KGGenerator(generator, examplar_type=args.dataset or args.corpus,
                     adaptive_examplars=False, batch_size=args.batch_size)
    kg.load_cached_kg_triples(args.cached_kg_triples_file)

    corpus = build_corpus(args)
    end = args.end or len(corpus)
    docs = [dict(corpus.data[i]) for i in range(args.start, end)]
    logger.info(f"extracting triples for {len(docs)} documents ...")
    for n, start in enumerate(range(0, len(docs), args.batch_size)):
        kg(docs[start: start + args.batch_size])
        if (n + 1) % args.save_every == 0:
            kg.save_cached_kg_triples(args.cached_kg_triples_file)
            logger.info(f"cache saved at batch {n + 1} ({len(kg.cached_kg_triples)} docs)")
    kg.save_cached_kg_triples(args.cached_kg_triples_file)
    logger.info(f"done: {len(kg.cached_kg_triples)} docs cached")
    return args.cached_kg_triples_file


if __name__ == "__main__":
    main()

"""KiRAG iterative retrieval entry point (port of :mod:`kirag_tpu.cli.retrieve`).

Loads the encoder, the index and the corpus, the constructor/KG LLM
(:class:`~kirag_tpu_torch.models.llm.TorchLlamaBackend`; 4-bit weights run
their decode projections through the K6 kernel on the GPU) and the Aligner,
runs ``KiRAG.retrieve`` per question (or ``retrieve_batch`` over
``--concurrent_questions``) and writes QA-format results (``ctxs`` +
``paths``). Same arguments and defaults as the JAX CLI. ``--mesh_data`` and
``--mesh_model`` build a device mesh over the ranks torchrun starts, one GPU
a rank (NCCL): as in the JAX CLI the mesh goes to the index only, whose rows
shard over the data axis (replicated over the model axis); every rank runs
the whole loop with a replicated LLM, and only the mesh's first rank writes
``--save_file``, the KG cache and the log.
``--draft_llm`` adds a bf16 draft model (greedy speculative decoding) and
``--llm_prefix_cache_groups`` the prefix-KV pool.

Usage:
  python -m kirag_tpu_torch.cli.retrieve \\
    --dataset 2wikimultihopqa --query_file dev.json --corpus 2wikimultihopqa \\
    --index_folder out/e5_2wiki \\
    --retriever_model_name_or_path /ckpts/e5-large-v2 \\
    --llm /ckpts/Meta-Llama-3-8B-Instruct --llm_quant_bits 4 \\
    --aligner_model_name_or_path /ckpts/aligner \\
    --save_dir out --name kirag --save_file results.json

  torchrun --nproc_per_node 4 -m kirag_tpu_torch.cli.retrieve --mesh_data 4 ...
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import Optional, Sequence

from kirag_tpu_torch.cli.common import (
    add_corpus_args,
    add_encoder_args,
    add_mesh_args,
    build_collator,
    build_corpus,
    build_encoder,
    build_llm_tokenizer,
    build_mesh,
    build_tokenizer,
    rank_device,
)
from kirag_tpu_torch.kg.triples import sent_tokenize
from kirag_tpu_torch.utils.io import load_json, save_json
from kirag_tpu_torch.utils.logging import setup_logger

logger = logging.getLogger(__name__)


def setup_parser(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--dataset", required=True, type=str)
    parser.add_argument("--query_file", required=True, type=str)
    parser.add_argument("--num_queries", type=int, default=None,
                        help="optionally truncate the query set")
    add_corpus_args(parser)
    add_encoder_args(parser)
    add_mesh_args(parser)
    parser.add_argument("--index_folder", type=str, required=True)
    parser.add_argument("--embedding_size", type=int, default=1024)
    parser.add_argument("--search_mode", type=str, default="exact", choices=["exact", "approx"],
                        help="approx = the group-sampled search (K5); composes with int8 "
                             "and int4 indexes")
    parser.add_argument("--approx_winners", type=int, default=1,
                        help="approx mode's candidates per 128-row group (1 = one winner a "
                             "group, 2 removes the dominant same-group miss, 128 = exact)")
    parser.add_argument("--llm", type=str, required=True,
                        help="LOCAL path to a Llama-architecture chat model")
    parser.add_argument("--llm_tokenizer", type=str, default=None,
                        help="tokenizer path (defaults to --llm)")
    parser.add_argument("--cached_kg_triples_file", type=str, default=None)
    parser.add_argument("--llm_quant_bits", type=int, default=None, choices=[4, 8],
                        help="weight-only LLM quantization: 8 (per-channel int8) or 4 "
                             "(block-64 NF4, the reference's 4-bit format)")
    parser.add_argument("--llm_kv_quant_bits", type=int, default=None, choices=[8],
                        help="int8 KV cache (per-token, per-KV-head scales): about half the "
                             "cache's bytes; not composable with --draft_llm")
    parser.add_argument("--llm_prefix_cache_groups", type=int, default=0,
                        help="prefix KV cache slots; 0 disables")
    parser.add_argument("--llm_prefix_cache_tokens", type=int, default=2048,
                        help="cached prefix length cap per slot")
    parser.add_argument("--draft_llm", type=str, default=None,
                        help="LOCAL path to a draft model for speculative decoding, loaded "
                             "in bf16 (same vocab as --llm)")
    parser.add_argument("--spec_gamma", type=int, default=4,
                        help="speculative fed-window length per round")
    parser.add_argument("--llm_int8", action="store_true",
                        help="weight-only int8 LLM")
    parser.add_argument("--aligner_model", type=str, default="e5", choices=["e5", "bge"])
    parser.add_argument("--aligner_model_name_or_path", type=str, required=True)
    parser.add_argument("--num_beams", type=int, default=1, choices=[1, 2])
    parser.add_argument("--concurrent_questions", type=int, default=1,
                        help="process N questions in lockstep turns, coalescing decode, "
                             "embed and search batches across them (KiRAG.retrieve_batch); "
                             "1 = the reference-shaped sequential loop")
    parser.add_argument("--num_turns", type=int, default=5)
    parser.add_argument("--topk", type=int, default=10)
    parser.add_argument("--num_candidate_triples", type=int, default=20)
    parser.add_argument("--per_device_batch_size", type=int, default=8)
    parser.add_argument("--save_dir", type=str, default="checkpoint")
    parser.add_argument("--name", type=str, default="e5_retriever")
    parser.add_argument("--save_file", required=True, type=str)
    return parser.parse_args(argv)


def setup_retriever_model(args, tokenizer=None, device=None, mesh=None):
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.retrieval import DenseRetriever

    tokenizer = tokenizer if tokenizer is not None else build_tokenizer(args)
    collator = build_collator(args, tokenizer)
    encoder = build_encoder(args, device=device)
    corpus = build_corpus(args)
    indexer = TorchIndexer(args.embedding_size, metric="inner_product", device=device,
                           mesh=mesh, approx_winners=args.approx_winners)
    indexer.deserialize_from(args.index_folder)
    retriever = DenseRetriever(encoder, collator, indexer=indexer, corpus=corpus,
                               batch_size=args.per_device_batch_size,
                               search_mode=args.search_mode)
    return retriever, corpus


def load_llm_tokenizer(args):
    """The LLM's HuggingFace tokenizer (``--llm_tokenizer``, else ``--llm``)."""
    return build_llm_tokenizer(args.llm_tokenizer or args.llm)


def load_draft_llm(args, draft_llm=None, device=None):
    """The ``(params, config)`` pair of ``--draft_llm`` in bf16, unquantized
    (or ``draft_llm``, a loaded pair); None without a draft."""
    from kirag_tpu_torch.models.registry import load_llm_params

    if draft_llm is not None:
        return draft_llm
    if not args.draft_llm:
        return None
    return load_llm_params(args.draft_llm, device=device)


def load_llm(args, llm=None, device=None):
    """The ``(params, config)`` pair of ``--llm`` in bf16 (or ``llm``, a loaded
    pair), its config given ``--llm_kv_quant_bits`` where set: the loader of
    :func:`kirag_tpu_torch.models.registry.load_llm`."""
    from kirag_tpu_torch.models.registry import load_llm_params

    if llm is None:
        return load_llm_params(args.llm, int8_weights=args.llm_int8,
                               quant_bits=args.llm_quant_bits,
                               kv_quant_bits=args.llm_kv_quant_bits, device=device)
    params, config = llm
    if args.llm_kv_quant_bits is not None:
        config = dataclasses.replace(config, kv_quant_bits=args.llm_kv_quant_bits)
    return params, config


def setup_llm_generator(args, llm_tokenizer=None, llm=None, device=None, draft_llm=None):
    """The constructor and KG Generators over one TorchLlamaBackend. ``llm``
    and ``draft_llm``: loaded ``(params, config)`` pairs used instead of
    reading ``--llm`` (whose name still picks the chat family) and
    ``--draft_llm``; ``--llm_kv_quant_bits`` applies to ``llm`` too."""
    from kirag_tpu_torch.generation.interface import Generator
    from kirag_tpu_torch.models.llm import TorchLlamaBackend

    tokenizer = llm_tokenizer if llm_tokenizer is not None else load_llm_tokenizer(args)
    params, config = load_llm(args, llm, device)
    draft_params, draft_config = load_draft_llm(args, draft_llm, device) or (None, None)
    backend = TorchLlamaBackend(params, config, eos_token_id=tokenizer.eos_token_id,
                                draft_params=draft_params, draft_config=draft_config,
                                spec_gamma=args.spec_gamma,
                                prefix_cache_groups=args.llm_prefix_cache_groups,
                                prefix_cache_tokens=args.llm_prefix_cache_tokens)
    constructor = Generator(tokenizer, backend, model_name=args.llm,
                            max_length=4096, max_new_tokens=64, batch_size=4)
    kg_llm = Generator(tokenizer, backend, model_name=args.llm,
                       max_length=4096, max_new_tokens=512, batch_size=4)
    return constructor, kg_llm


def setup_kirag_model(args, retriever, llm_tokenizer=None, aligner_tokenizer=None, llm=None,
                      device=None, draft_llm=None):
    from kirag_tpu_torch.data import COLLATOR_MAP
    from kirag_tpu_torch.kg import KGGenerator
    from kirag_tpu_torch.models.encoders import load_encoder
    from kirag_tpu_torch.pipeline import KiRAG
    from kirag_tpu_torch.retrieval import DenseRetriever

    constructor, kg_llm = setup_llm_generator(args, llm_tokenizer, llm, device, draft_llm)
    aligner_encoder = load_encoder(args.aligner_model_name_or_path, args.aligner_model,
                                   device=device)
    if aligner_tokenizer is None:
        from transformers import AutoTokenizer

        aligner_tokenizer = AutoTokenizer.from_pretrained(args.aligner_model_name_or_path)
    aligner_collator = COLLATOR_MAP[args.aligner_model](
        tokenizer=aligner_tokenizer, query_maxlength=256, doc_maxlength=64)
    aligner = DenseRetriever(aligner_encoder, aligner_collator,
                             batch_size=args.per_device_batch_size)
    kg_generator = KGGenerator(kg_llm, examplar_type=args.dataset, embedder=aligner,
                               batch_size=4)
    if args.cached_kg_triples_file is not None:
        kg_generator.load_cached_kg_triples(args.cached_kg_triples_file)
    return KiRAG(retriever=retriever, kg_generator=kg_generator, constructor=constructor,
                 aligner=aligner, examplar_type=args.dataset, num_turns=args.num_turns,
                 topk=args.topk, num_candidate_triples=args.num_candidate_triples)


def convert_chains_to_qa_format(example, reasoning_chains, documents):
    ctxs = []
    for doc in documents:
        if "sentences" not in doc:
            doc = dict(doc)
            doc["sentences"] = sent_tokenize(doc["text"])
        ctxs.append(doc)
    example["ctxs"] = ctxs
    example["paths"] = reasoning_chains
    return example


def retrieve(args, questions, kirag, retriever, writer: bool = True):
    results = []
    wave = max(1, args.concurrent_questions)
    for start in range(0, len(questions), wave):
        batch = questions[start: start + wave]
        if wave == 1:
            outs = [kirag.retrieve(question=batch[0]["question"], num_beams=args.num_beams)]
        else:
            outs = kirag.retrieve_batch([ex["question"] for ex in batch],
                                        num_beams=args.num_beams)
        for example, (chains, docids_to_scores) in zip(batch, outs):
            documents = retriever.get_documents(docids_to_scores)
            results.append(convert_chains_to_qa_format(example, chains, documents))
        logger.info(f"[{min(start + wave, len(questions))}/{len(questions)}] "
                    f"retrieved (wave={wave})")
    if args.cached_kg_triples_file is not None and writer:
        kirag.kg_generator.save_cached_kg_triples(args.cached_kg_triples_file)
    return results


def main(argv: Optional[Sequence[str]] = None, *, tokenizer=None, llm_tokenizer=None,
         aligner_tokenizer=None, llm=None, draft_llm=None, device=None) -> str:
    """Run the CLI on ``argv`` (default: the command line). ``tokenizer``,
    ``llm_tokenizer`` and ``aligner_tokenizer`` replace the HuggingFace
    tokenizers the arguments name; ``llm`` and ``draft_llm`` are loaded
    ``(params, config)`` pairs used instead of reading ``--llm`` and
    ``--draft_llm`` (a ``draft_llm`` turns speculative decoding on);
    ``device`` is the models' and the index's (default: the GPU, over a mesh
    the rank's own). Returns the path of the results json, which only the
    mesh's first rank writes."""
    args = setup_parser(argv)
    mesh = build_mesh(args)
    device = rank_device(mesh, device)
    writer = mesh is None or mesh.rank == 0
    checkpoint_path = os.path.join(args.save_dir, args.name)
    if writer:
        os.makedirs(checkpoint_path, exist_ok=True)
        setup_logger(os.path.join(checkpoint_path, "kg_adaptive_retrieve.log"))

    retriever, _ = setup_retriever_model(args, tokenizer, device, mesh)
    kirag = setup_kirag_model(args, retriever, llm_tokenizer, aligner_tokenizer, llm, device,
                              draft_llm)

    questions = load_json(args.query_file)
    if args.num_queries:
        questions = questions[: args.num_queries]
    logger.info(f"retrieving for {len(questions)} questions ...")
    results = retrieve(args, questions, kirag, retriever, writer)
    save_path = os.path.join(checkpoint_path, args.save_file)
    if writer:
        save_json(results, save_path, use_indent=True)
        logger.info(f"wrote {save_path}")
    return save_path


if __name__ == "__main__":
    main()

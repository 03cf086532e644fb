"""Embed a whole corpus and write embedding shards (port of
:mod:`kirag_tpu.cli.compute_corpus_embeddings`).

Passages are embedded ``--per_device_batch_size`` at a time (the tail batch
zero-padded to full size, as the reference does) and written as ``.npz``
shards ``corpus_embeddings_{start}_{end}.npz`` holding ``embeddings`` (f32)
and ``passage_ids`` (object array) of ``--num_passage_per_index_file`` rows
each. The encoder runs on the GPU; on the card every batch whose bucket
length is a multiple of 128 goes through the flash attention kernel.

``--mesh_data`` and ``--mesh_model`` build a device mesh over the ranks
torchrun starts, one GPU a rank (NCCL): as in the JAX CLI, a model axis of
more than one rank shards the encoder's weights (tensor parallelism) and the
data axis replicates the work; every rank runs the whole loop and only the
mesh's first rank writes the shards. ``--process_index``/``--process_count``
split the corpus between separate jobs, as before.

Usage:
  python -m kirag_tpu_torch.cli.compute_corpus_embeddings \\
    --retriever_model_name_or_path /ckpts/e5-large-v2 \\
    --corpus 2wikimultihopqa --save_dir out --name e5_2wiki
  torchrun --nproc_per_node 2 -m kirag_tpu_torch.cli.compute_corpus_embeddings \\
    --mesh_model 2 ...
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np

from kirag_tpu_torch.cli.common import (
    add_corpus_args,
    add_encoder_args,
    add_mesh_args,
    build_collator,
    build_corpus,
    build_encoder,
    build_mesh,
    build_tokenizer,
    rank_device,
)
from kirag_tpu_torch.utils.logging import setup_logger

logger = logging.getLogger(__name__)


def setup_parser(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_encoder_args(parser)
    add_corpus_args(parser)
    add_mesh_args(parser)
    parser.add_argument("--per_device_batch_size", type=int, default=128)
    parser.add_argument("--num_passage_per_index_file", type=int, default=1_000_000)
    parser.add_argument("--process_index", type=int, default=0,
                        help="this worker's index (multi-host corpus sharding)")
    parser.add_argument("--process_count", type=int, default=1,
                        help="total workers; each embeds a contiguous corpus slice")
    parser.add_argument("--save_dir", type=str, default="checkpoint")
    parser.add_argument("--name", type=str, default="e5_retriever")
    return parser.parse_args(argv)


def cal_doc_embeddings(args, encoder, collator, corpus, save_path: str,
                       writer: bool = True) -> None:
    """Embed this process's slice of ``corpus`` and write its shards (only
    where ``writer``: under a mesh every rank embeds, the first writes)."""
    if writer:
        os.makedirs(save_path, exist_ok=True)
    batch_size = args.per_device_batch_size
    shard_rows = args.num_passage_per_index_file

    # contiguous per-process slice: shard filenames carry GLOBAL offsets, so
    # build_index's offset-sorted discovery reassembles the corpus in order
    per_proc = -(-len(corpus) // args.process_count)
    lo = args.process_index * per_proc
    hi = min(len(corpus), lo + per_proc)

    buf_emb, buf_ids, shard_start, done = [], [], lo, lo
    t0 = time.time()
    for start in range(lo, hi, batch_size):
        items = [corpus[i] for i in range(start, min(start + batch_size, hi))]
        texts = [it["passage"] for it in items]
        enc_args = collator.encode_doc(texts)
        n_real = len(texts)
        if n_real < batch_size:  # the reference's fixed batch shape on the tail batch
            pad = batch_size - n_real
            enc_args = {k: np.pad(v, ((0, pad), (0, 0))) for k, v in enc_args.items()}
        emb = encoder(enc_args["input_ids"], enc_args["attention_mask"])[:n_real]
        buf_emb.append(emb.float().cpu().numpy())
        buf_ids.extend(it["passage_id"] for it in items)
        done += n_real
        if done - shard_start >= shard_rows or done == hi:
            emb_arr = np.concatenate(buf_emb, axis=0)
            shard_file = os.path.join(save_path, f"corpus_embeddings_{shard_start}_{done}.npz")
            if writer:
                np.savez(shard_file, embeddings=emb_arr,
                         passage_ids=np.asarray(buf_ids, dtype=object))
            logger.info(f"wrote {shard_file} ({len(emb_arr)} rows, "
                        f"{(done - lo) / max(time.time() - t0, 1e-9):.1f} psg/s cumulative)")
            buf_emb, buf_ids, shard_start = [], [], done


def main(argv: Optional[Sequence[str]] = None, *, tokenizer=None, device=None) -> str:
    """Run the CLI on ``argv`` (default: the command line). ``tokenizer``
    replaces the HF tokenizer the arguments name; ``device`` is the
    encoder's (default: the GPU, over a mesh the rank's own). Returns the
    shard directory, which only the mesh's first rank writes."""
    args = setup_parser(argv)
    mesh = build_mesh(args)
    device = rank_device(mesh, device)
    writer = mesh is None or mesh.rank == 0
    save_path = os.path.join(args.save_dir, args.name)
    if writer:
        os.makedirs(save_path, exist_ok=True)
        setup_logger(os.path.join(save_path, "compute_corpus_embeddings.log"))

    tokenizer = tokenizer if tokenizer is not None else build_tokenizer(args)
    encoder = build_encoder(args, device=device)
    if mesh is not None and mesh.size("model") > 1:
        encoder.shard_params(mesh)
    collator = build_collator(args, tokenizer)
    corpus = build_corpus(args)
    logger.info(f"embedding {len(corpus)} passages ...")
    cal_doc_embeddings(args, encoder, collator, corpus, save_path, writer)
    return save_path


if __name__ == "__main__":
    main()

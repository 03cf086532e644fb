"""Build the exact index from embedding shards (port of
:mod:`kirag_tpu.cli.build_index`).

Discovers ``corpus_embeddings_{start}_{end}.npz`` shards (sorted by start
offset), feeds them into :class:`kirag_tpu_torch.index.TorchIndexer` and
serializes the index (+ id map) in the reference's layout, which
``TPUIndexer`` and ``TorchIndexer`` both read. ``--metric`` and
``--compression int8|int4`` are recorded in the config (the shards stay raw
f32; the index is augmented and quantized when it is loaded);
``--shuffle_rows --shuffle_seed S`` writes the rows in a seeded permuted
order, which the approximate search (``retrieve --search_mode approx``)
wants for corpora whose similar passages sit together.

Usage:
  python -m kirag_tpu_torch.cli.build_index \\
    --embeddings_dir out/e5_2wiki --embedding_size 1024 --save_dir out/e5_2wiki
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import re
from typing import List, Optional, Sequence

import numpy as np

from kirag_tpu_torch.index import TorchIndexer
from kirag_tpu_torch.utils.logging import setup_logger

logger = logging.getLogger(__name__)


def setup_parser(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--embeddings_dir", type=str, required=True)
    parser.add_argument("--embedding_size", type=int, default=1024)
    parser.add_argument("--metric", type=str, default="inner_product",
                        choices=["inner_product", "l2"])
    parser.add_argument("--compression", type=str, default="none",
                        choices=["none", "int8", "int4"])
    parser.add_argument("--shuffle_rows", action="store_true",
                        help="seeded global row permutation before indexing (ids move "
                             "with rows); serves the approximate search")
    parser.add_argument("--shuffle_seed", type=int, default=0)
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--delete_shards", action="store_true",
                        help="remove embedding shards after indexing (reference behavior)")
    return parser.parse_args(argv)


def discover_shards(embeddings_dir: str) -> List[str]:
    shards = []
    for path in glob.glob(os.path.join(embeddings_dir, "corpus_embeddings_*_*.npz")):
        m = re.search(r"corpus_embeddings_(\d+)_(\d+)\.npz$", path)
        if m:
            shards.append((int(m.group(1)), path))
    shards.sort()
    return [p for _, p in shards]


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> str:
    """Run the CLI on ``argv`` (default: the command line); ``device`` is the
    index's (default: the GPU). Returns the index directory."""
    args = setup_parser(argv)
    os.makedirs(args.save_dir, exist_ok=True)
    setup_logger(os.path.join(args.save_dir, "build_index.log"))

    indexer = TorchIndexer(args.embedding_size, metric=args.metric,
                           compression=args.compression, shuffle_rows=args.shuffle_rows,
                           shuffle_seed=args.shuffle_seed, device=device)
    shard_files = discover_shards(args.embeddings_dir)
    if not shard_files:
        raise FileNotFoundError(f"no embedding shards under {args.embeddings_dir}")
    for path in shard_files:
        with np.load(path, allow_pickle=True) as data:  # shards this CLI wrote
            indexer.index_data(list(data["passage_ids"]), data["embeddings"])
        logger.info(f"indexed {path}: total {len(indexer)}")
    indexer.serialize(args.save_dir)
    logger.info(f"index serialized to {args.save_dir}")
    if args.delete_shards:
        for path in shard_files:
            os.remove(path)
    return args.save_dir


if __name__ == "__main__":
    main()

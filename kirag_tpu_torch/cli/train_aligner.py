"""Train the Reasoning Chain Aligner, the contrastive bi-encoder (port of
:mod:`kirag_tpu.cli.train_aligner`).

The reference's defaults: lr 2e-5, weight decay 0.01, accumulation 2, clip
1.0, 10 epochs, warmup 0.1, batch 8 examples of 2 positive chains and 10
negatives each, temperature 0.01, query/doc max lengths 256/64, bf16
compute over f32 master weights, ``--remat dots``. The encoder is loaded
in f32 whatever ``--compute_dtype`` says; the compute dtype is the
forward's.

``--mesh_data`` and ``--mesh_model`` build a device mesh over the ranks
torchrun starts, one GPU a rank (NCCL): each batch's rows shard over the
data axis (``--per_device_batch_size`` is the global batch, as in the JAX
CLI) and a model axis of more than one rank shards the encoder's weights.
Every rank runs the loop; only the mesh's first rank writes the checkpoints,
the metrics and the saved encoder.

Usage:
  python -m kirag_tpu_torch.cli.train_aligner \\
    --retriever_model_name_or_path /ckpts/e5-large-v2 \\
    --data_folders data/hotpotqa data/2wikimultihopqa \\
    --save_dir checkpoint --name aligner
  torchrun --nproc_per_node 4 -m kirag_tpu_torch.cli.train_aligner \\
    --mesh_data 2 --mesh_model 2 ...
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Any, Dict, Optional, Sequence

import torch

from kirag_tpu_torch.cli.common import (
    add_encoder_args,
    add_mesh_args,
    build_collator,
    build_mesh,
    build_tokenizer,
    rank_device,
)
from kirag_tpu_torch.utils.logging import setup_logger

logger = logging.getLogger(__name__)


def setup_parser(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_encoder_args(parser)
    add_mesh_args(parser)
    parser.add_argument("--data_folders", type=str, nargs="+", required=True)
    parser.add_argument("--learning_rate", type=float, default=2e-5)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--accumulation_steps", type=int, default=2)
    parser.add_argument("--max_grad_norm", type=float, default=1.0)
    parser.add_argument("--num_train_epochs", type=int, default=10)
    parser.add_argument("--warmup_ratio", type=float, default=0.1)
    parser.add_argument("--per_device_batch_size", type=int, default=8)
    parser.add_argument("--num_positives", type=int, default=2)
    parser.add_argument("--num_negatives", type=int, default=10)
    parser.add_argument("--temperature", type=float, default=0.01)
    parser.add_argument("--eval_steps", type=int, default=200)
    parser.add_argument("--keep_top_k", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--remat", choices=["dots", "full", "none"], default="dots",
                        help="encoder recomputation in the backward pass: 'dots' keeps the "
                        "matmul outputs and recomputes the rest, 'full' recomputes "
                        "everything (least memory), 'none' keeps every activation. All "
                        "gradient-identical.")
    parser.add_argument("--no_remat", dest="remat", action="store_const", const="none",
                        help="alias for --remat none")
    parser.add_argument("--save_dir", type=str, default="checkpoint")
    parser.add_argument("--name", type=str, default="aligner")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, *, tokenizer=None,
         device=None) -> Dict[str, Any]:
    """Run the CLI on ``argv`` (default: the command line). ``tokenizer``
    replaces the HF tokenizer the arguments name; ``device`` is the
    trainer's (default: the GPU, over a mesh the rank's own). Returns the
    trainer's result (final eval metric, steps) and ``encoder_dir``, where
    the trained encoder is saved (by the mesh's first rank)."""
    args = setup_parser(argv)
    mesh = build_mesh(args)
    device = rank_device(mesh, device)
    writer = mesh is None or mesh.rank == 0
    save_dir = os.path.join(args.save_dir, args.name)
    os.makedirs(save_dir, exist_ok=True)
    setup_logger(os.path.join(save_dir, "train_aligner.log"), process_index=0 if writer else 1)

    from kirag_tpu_torch.data import KGChainRetrieverSeqSampleDataset
    from kirag_tpu_torch.models.encoders import RETRIEVER_NAME_TO_ENCODER, load_encoder
    from kirag_tpu_torch.training import AlignerTrainer, DataLoader, TrainerConfig
    from kirag_tpu_torch.utils.seeding import seed_everything

    seed_everything(args.seed)
    tokenizer = tokenizer if tokenizer is not None else build_tokenizer(args)
    args.query_maxlength, args.doc_maxlength = 256, 64
    collator = build_collator(args, tokenizer)
    encoder_type = RETRIEVER_NAME_TO_ENCODER[args.retriever_name]
    # f32 master weights; the compute dtype is applied per call in the forward
    encoder = load_encoder(args.retriever_model_name_or_path, encoder_type,
                           compute_dtype=torch.float32, device=device)

    train_ds = KGChainRetrieverSeqSampleDataset(
        is_train=True, data_folders=args.data_folders,
        num_positives=args.num_positives, num_negatives=args.num_negatives)
    eval_ds = KGChainRetrieverSeqSampleDataset(
        is_train=False, data_folders=args.data_folders, num_negatives=args.num_negatives)
    train_loader = DataLoader(train_ds, batch_size=args.per_device_batch_size, shuffle=True,
                              collate_fn=collator, seed=args.seed)
    eval_loader = DataLoader(eval_ds, batch_size=args.per_device_batch_size, shuffle=False,
                             collate_fn=collator)

    config = TrainerConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_ratio=args.warmup_ratio, num_train_epochs=args.num_train_epochs,
        accumulation_steps=args.accumulation_steps, max_grad_norm=args.max_grad_norm,
        eval_steps=args.eval_steps, keep_top_k=args.keep_top_k,
        save_dir=save_dir, seed=args.seed)
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    trainer = AlignerTrainer(
        encoder.model, config, train_loader, eval_loader, encoder_type=encoder_type,
        temperature=args.temperature, compute_dtype=dtype,
        remat={"none": False, "full": True}.get(args.remat, "dots"), mesh=mesh,
        batch_sharding=None if mesh is None else "data")
    result = trainer.train(resume=args.resume)
    logger.info(f"training done: {result}")
    encoder_dir = os.path.join(save_dir, "encoder")
    trainer.save_encoder(encoder_dir)
    logger.info(f"encoder saved to {encoder_dir} "
                f"(pass as --aligner_model_name_or_path to retrieve)")
    return {**result, "encoder_dir": encoder_dir}


if __name__ == "__main__":
    main()

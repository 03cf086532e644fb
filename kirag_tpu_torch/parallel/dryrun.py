"""The multi-device dry run (port of ``__graft_entry__.dryrun_multichip``).

:func:`dryrun_multichip` runs, over every rank of the world that torchrun
(or a test's gloo processes) started, one of each sharded path of the port
and checks it:

- one data- x tensor-parallel training step of a tiny BERT (the model axis
  2 where the world is even), its loss finite;
- the sharded searches (exact scan, the exact kernels' capdom and merge
  selections, approximate, int8, int4 approximate), each equal to its
  unsharded counterpart over the whole corpus;
- checkpoint-resume under the same mesh: the step after a resume bitwise
  the uninterrupted one's;
- tensor-parallel greedy decode, with the int8 KV cache, and speculative
  decoding with a sharded draft, each equal to the unsharded greedy decode.

A world of one process is a 1 x 1 mesh. Every rank runs the same program
(each call below is a collective); each returns the summary line, which the
first rank prints. Run it as

    torchrun --nproc_per_node 4 -m kirag_tpu_torch.parallel.dryrun
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from kirag_tpu_torch.parallel.mesh import create_mesh, distributed_init, shard_rows


def _shared_dir(work_dir: Optional[str]) -> str:
    """``work_dir``, or a new temporary directory made by rank 0 and named
    to every rank (the ranks share a file system)."""
    if work_dir is not None:
        return work_dir
    name = [tempfile.mkdtemp(prefix="kirag_dryrun_") if not dist.is_initialized()
            or dist.get_rank() == 0 else None]
    if dist.is_initialized():
        dist.broadcast_object_list(name, src=0)
    return name[0]


def _training(mesh, device, rng, work: str):
    """One dp x tp step of the reference's tiny BERT; then checkpoint-resume:
    returns (the first loss, the second step's loss uninterrupted and
    resumed)."""
    from kirag_tpu_torch.models import BertConfig, BertModel
    from kirag_tpu_torch.training import AlignerTrainer, TrainerConfig

    config = BertConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128,
                        max_position_embeddings=64)
    n_q, docs_per_q, seq = 2 * mesh.size("data"), 4, 16

    def rows(n):
        return {"input_ids": rng.randint(1, 500, (n, seq)).astype(np.int32),
                "attention_mask": np.ones((n, seq), np.int32)}

    batch = (rows(n_q), rows(n_q * docs_per_q), np.arange(n_q, dtype=np.int32) * docs_per_q,
             np.arange(n_q, dtype=np.int32))

    def trainer():
        model = BertModel(config, device=device,
                          generator=torch.Generator(device=device).manual_seed(0))
        return AlignerTrainer(model, TrainerConfig(learning_rate=1e-4, max_steps=100,
                                                   save_dir=work),
                              [batch], temperature=0.05, mesh=mesh, batch_sharding="data")

    first = trainer()
    loss = first.training_step(batch)["loss"]
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite training loss: {loss}")
    first.save_checkpoint()
    uninterrupted = first.training_step(batch)["loss"]
    again = trainer()
    if not again.resume_training():
        raise AssertionError("no checkpoint to resume from")
    resumed = again.training_step(batch)["loss"]
    if resumed != uninterrupted:
        raise AssertionError(f"resumed trajectory diverged: {uninterrupted} != {resumed}")
    return loss


def _searches(mesh, device, rng, hidden: int) -> None:
    """Every sharded search on this rank's rows, equal to the unsharded one."""
    from kirag_tpu_torch import ops
    from kirag_tpu_torch.ops.quantized import quantize_rows_int4, quantize_rows_int8

    dp = mesh.size("data")

    def on(x):
        return torch.as_tensor(x).to(device)

    def same(got, want, what):
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"sharded {what} disagrees with the unsharded search")

    corpus = rng.randn(64 * dp, hidden).astype(np.float32)
    queries = on(rng.randn(4, hidden).astype(np.float32))
    whole = on(corpus)
    local = shard_rows(whole, mesh)
    vals, idx = ops.sharded_topk_mips(queries, local, 8, mesh, chunk_size=32)
    if vals.shape != (4, 8) or not bool(torch.isfinite(vals).all()):
        raise AssertionError(f"sharded scan: {tuple(vals.shape)}, finite "
                             f"{bool(torch.isfinite(vals).all())}")
    same((vals, idx), ops.topk_mips(queries, whole, 8), "scan")
    for kw in ({}, {"impl": "stream", "select": "capdom"},
               {"impl": "stream", "select": "merge"}):
        got = ops.sharded_exact_topk_mips(queries, local, 8, mesh, chunk_size=128, **kw)
        if not torch.equal(got[1], idx):
            raise AssertionError(f"sharded exact {kw or 'flat'} disagrees with the scan")
    wide = on(rng.randn(256 * dp, hidden).astype(np.float32))
    approx = ops.sharded_approx_topk_mips(queries, shard_rows(wide, mesh), 8, mesh)
    reachable = min(8, 2 * dp)  # a candidate per 128-row group
    if approx[0].shape != (4, 8) or not bool(torch.isfinite(approx[0][:, :reachable]).all()):
        raise AssertionError("sharded approximate search: non-finite reachable slots")
    same(approx, ops.approx_topk_mips(queries, wide, 8), "approximate search")
    codes, scales = (on(x) for x in quantize_rows_int8(corpus))
    got = ops.sharded_topk_mips_int8(queries, shard_rows(codes, mesh), shard_rows(scales, mesh),
                                     8, mesh, chunk_size=32)
    same(got, ops.topk_mips_int8(queries, codes, scales, 8), "int8 search")
    rows4 = rng.randn(128 * dp, 256).astype(np.float32)
    rows4 /= np.linalg.norm(rows4, axis=-1, keepdims=True)
    packed, p_scales = (on(x) for x in quantize_rows_int4(rows4))
    q4 = on(rows4[:4])
    got = ops.sharded_approx_topk_mips(q4, shard_rows(packed, mesh), 4, mesh,
                                       scales=shard_rows(p_scales, mesh))
    if not torch.equal(got[1][:, 0].cpu(), torch.arange(4)):
        raise AssertionError("sharded int4 approximate search: a row does not find itself")
    same(got, ops.approx_topk_mips(q4, packed, 4, scales=p_scales), "int4 approximate search")


def _decodes(mesh, device, rng) -> None:
    """TP greedy, int8-KV and speculative decode equal to unsharded greedy."""
    from kirag_tpu_torch.models.llm import (
        LlamaConfig,
        TorchLlamaBackend,
        greedy_decode,
        init_llama_params,
    )
    from kirag_tpu_torch.models.speculative import speculative_decode

    config = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=64)
    # the reference's draft has one KV head, which a model axis of two cannot
    # cut into whole heads; two KV heads here
    draft_config = LlamaConfig(vocab_size=256, hidden_size=32, intermediate_size=64,
                               num_hidden_layers=1, num_attention_heads=2,
                               num_key_value_heads=2, max_position_embeddings=64)
    params = init_llama_params(config, seed=1, device=device)
    draft = init_llama_params(draft_config, seed=3, device=device)
    ids = rng.randint(1, 250, (2, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    base, _ = greedy_decode(params, ids, mask, config, 4)
    backend = TorchLlamaBackend(params, config, eos_token_id=2,
                                compute_dtype=torch.float32).shard_params(mesh)
    tp, _ = greedy_decode(backend.params, ids, mask, config, 4)
    if not torch.equal(tp, base):
        raise AssertionError("TP decode != single-device decode")
    kv_config = dataclasses.replace(config, kv_quant_bits=8)
    kv_base, _ = greedy_decode(params, ids, mask, kv_config, 4)
    kv_tp, _ = greedy_decode(backend.params, ids, mask, kv_config, 4)
    if not torch.equal(kv_tp, kv_base):
        raise AssertionError("TP int8-KV decode != unsharded")
    spec = TorchLlamaBackend(params, config, eos_token_id=2, compute_dtype=torch.float32,
                             draft_params=draft, draft_config=draft_config,
                             spec_gamma=3).shard_params(mesh)
    spec_ids, _ = speculative_decode(spec.params, config, spec.draft_params, draft_config, ids,
                                     mask, 4, gamma=3, compute_dtype=torch.float32,
                                     return_logits=False)
    if not torch.equal(spec_ids, base):
        raise AssertionError("TP speculative != greedy")


def dryrun_multichip(device=None, work_dir: Optional[str] = None) -> str:
    """Run and check the sharded paths over every rank of the world (see
    the module docstring); returns the summary line. ``device``: this rank's
    (default: its GPU). ``work_dir``: a directory every rank can read, for
    the checkpoint (default: a temporary one, removed after)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    model_par = 2 if world % 2 == 0 else 1
    mesh = create_mesh(data=world // model_par, model=model_par)
    rng = np.random.RandomState(0)  # the same draws on every rank
    work = _shared_dir(work_dir)
    try:
        loss = _training(mesh, device, rng, os.path.join(work, "train"))
        _searches(mesh, device, rng, hidden=64)
        _decodes(mesh, device, rng)
    finally:
        if dist.is_initialized():
            dist.barrier()
        if work_dir is None and mesh.rank == 0:
            shutil.rmtree(work, ignore_errors=True)
    return (f"dryrun_multichip ok: mesh={dict(mesh.shape)} loss={loss:.4f} "
            f"llm_tp_decode=match(tp={mesh.shape['model']}) kv_int8=match "
            f"approx+int8+int4 sharded search ok, ckpt-resume exact")


def main() -> int:
    device = distributed_init()
    line = dryrun_multichip(device)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(line, flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Data- and tensor-parallel Aligner training on the card (chip_smoke.py
phase 21 (a) and (b) at a small size).

(a) NCCL at world size 1, in the test process: ``AlignerTrainer(mesh=
create_mesh(1, 1), batch_sharding="data")`` takes the unsharded trainer's
steps bitwise (the collectives over one rank are copies), through K3 and
its backward kernels (head_dim 64, 128-token queries), bf16 compute.
(b) Two ranks on the one card over gloo (``tests/torch_dist.py``, both
processes' tensors on ``cuda:0``): a (1, 2) tensor-parallel step and a
(2, 1) data-parallel step at f32 against the unsharded trainer on the same
global batch (loss within 1e-5 relative, each gradient within 1e-4 of its
norm: the f32 K3 kernels' split-TF32 sums), K3's forward and both backward
kernels launched on every rank with 2 of 4 heads; and ``Encoder.shard_params``
over (1, 2) within 1e-5 of the largest magnitude of the unsharded encoder's
embeddings.

This file imports neither JAX nor ``kirag_tpu``, so the GPU machine runs it:
``python -m pytest --noconftest tests/test_torch_sharded_training_cuda.py -m cuda``.
Every test needs the card and skips without one.
"""

import numpy as np
import pytest
import torch

import torch_dist_tasks as tasks
from torch_dist import run_ranks

CFG = dict(vocab_size=512, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=512, max_position_embeddings=256)
K3 = ("flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def tree(seed=0):
    """Seeded weights in the reference's pytree layout (numpy)."""
    rng = np.random.RandomState(seed)
    h, i = CFG["hidden_size"], CFG["intermediate_size"]

    def linear(n_in, n_out):
        return {"kernel": (0.02 * rng.randn(n_in, n_out)).astype(np.float32),
                "bias": (0.02 * rng.randn(n_out)).astype(np.float32)}

    def norm():
        return {"scale": np.ones(h, np.float32), "bias": np.zeros(h, np.float32)}

    return {"embeddings": {"word_embeddings": (0.02 * rng.randn(CFG["vocab_size"], h)).astype(
                np.float32),
            "position_embeddings": (0.02 * rng.randn(CFG["max_position_embeddings"], h)
                                    ).astype(np.float32),
            "token_type_embeddings": (0.02 * rng.randn(2, h)).astype(np.float32),
            "layer_norm": norm()},
            "layers": [{"attention": {**{n: linear(h, h) for n in ("query", "key", "value")},
                                      "output": linear(h, h), "output_layer_norm": norm()},
                        "mlp": {"intermediate": linear(h, i), "output": linear(i, h),
                                "output_layer_norm": norm()}}
                       for _ in range(CFG["num_hidden_layers"])],
            "pooler": linear(h, h)}


def batches(n=2, queries=4, docs=4, seed=1):
    """Collated batches: queries of 128 tokens (through K3), docs of 32."""
    rng = np.random.RandomState(seed)

    def rows(count, width):
        lengths = rng.randint(width // 4, width + 1, count)
        mask = (np.arange(width)[None] < lengths[:, None]).astype(np.int32)
        return {"input_ids": rng.randint(5, CFG["vocab_size"], (count, width)).astype(
            np.int32) * mask, "attention_mask": mask}

    index = np.arange(queries, dtype=np.int32)
    return [(rows(queries, 128), rows(queries * docs, 32), index * docs, index)
            for _ in range(n)]


def case(op, mesh, save_dir, **kw):
    return {"op": op, "mesh": mesh, "cfg": CFG, "tree": tree(), "batches": batches(),
            "device": "cuda", "save_dir": str(save_dir), "steps": 2, **kw}


@pytest.mark.cuda
def test_trainer_over_nccl_world_1_is_the_unsharded_trainer(cuda_device, tmp_path):
    import torch.distributed as dist

    from kirag_tpu_torch.kernels import launch_counts, reset_launch_counts
    from kirag_tpu_torch.parallel import create_mesh

    def run(mesh, name):
        c = case("step", (1, 1), tmp_path / name, dtype=torch.bfloat16, remat="dots",
                 batch_sharding=None if mesh is None else "data")
        trainer = tasks._aligner_trainer(c, mesh, c["save_dir"])
        reset_launch_counts()
        stats = tasks._steps(trainer, 2)
        return stats, tasks._whole_params(trainer), dict(launch_counts())

    want = run(None, "unsharded")
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, device_id=cuda_device)
    try:
        got = run(create_mesh(1, 1), "mesh")
    finally:
        dist.destroy_process_group()
    assert [s["loss"] for s in got[0]] == [s["loss"] for s in want[0]]
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k], err_msg=k)
    assert all(got[2][k] > 0 for k in K3) and got[2] == want[2]


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)])
def test_two_ranks_on_one_card_train_as_one(cuda_device, tmp_path, mesh):
    got = run_ranks("aligner", 2, [case("step", mesh, tmp_path / "run")], tmp_path)
    c = {**case("step", mesh, tmp_path / "ref"), "batch_sharding": None}
    ref = tasks._aligner_trainer(c, None, c["save_dir"])
    seen = tasks._record_grads(ref)
    stats = tasks._steps(ref, 2)
    for r in got:
        for a, b in zip(r[0]["stats"], stats):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        for k, want in seen[0].items():
            gap = np.linalg.norm(r[0]["grads"][k] - want)
            assert gap <= 1e-4 * np.linalg.norm(want) + 1e-9, (k, gap)
        assert all(r[0]["launches"][k] > 0 for k in K3), r[0]["launches"]


@pytest.mark.cuda
def test_encoder_shard_params_on_the_card(cuda_device, tmp_path):
    from kirag_tpu_torch.models import Encoder

    b = batches(1, queries=8)[0][0]
    c = {"cfg": CFG, "tree": tree(), "ids": b["input_ids"], "mask": b["attention_mask"],
         "mesh": (1, 2), "device": "cuda"}
    got = run_ranks("bert_tp", 2, [c], tmp_path)
    want = Encoder(tasks._bert(c))(c["ids"], c["mask"]).cpu().numpy()
    for r in got:
        np.testing.assert_allclose(r[0]["emb"], want, rtol=0, atol=1e-5 * np.abs(want).max())

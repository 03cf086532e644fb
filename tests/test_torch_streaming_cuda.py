"""Streaming search on the card (chip_smoke.py phase 18 at a small size):
the streamed exact search is bitwise the resident one (float32 and int8;
each row's fma or mma order does not depend on the block), its blocks are
pinned and copied into two device buffers in turns on a side stream, and
the streamed approximate search equals the same streamed search through the
kernels' plain versions.

This file imports neither JAX nor ``kirag_tpu``, so the GPU machine runs it:
``python -m pytest --noconftest tests/test_torch_streaming_cuda.py -m cuda``.
Every test needs the card and skips without one.
"""

import functools

import numpy as np
import pytest
import torch

import kirag_tpu_torch.index.indexer as indexer_module
from kirag_tpu_torch.index import TorchIndexer
from kirag_tpu_torch.kernels import launch_counts, reset_launch_counts
from kirag_tpu_torch.ops import approx_topk_mips, exact_topk_mips

ROWS, DIM, BLOCK, CHUNK = 40_000, 256, 16_384, 2048


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def seeded_rows(seed, n=ROWS, d=DIM):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def pair(device, rows, **kw):
    streamed = TorchIndexer(DIM, device=device, pallas_chunk_size=CHUNK,
                            max_device_rows=BLOCK, **kw)
    resident = TorchIndexer(DIM, device=device, pallas_chunk_size=CHUNK, **kw)
    for index in (streamed, resident):
        index.index_data(range(len(rows)), rows)
    return streamed, resident


@pytest.mark.cuda
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_streamed_exact_is_the_resident_search_bitwise(cuda_device, compression):
    rows = seeded_rows(0)
    streamed, resident = pair(cuda_device, rows, compression=compression)
    queries = rows[::997][:32] + 0.01 * seeded_rows(1, 32)
    reset_launch_counts()
    got = streamed.search_knn(queries, 100)
    suffix = "" if compression == "none" else f"_{compression}"
    assert launch_counts()[f"stream_capture{suffix}"] == 3  # one search a block
    want = resident.search_knn(queries, 100)
    for (g_ids, g_vals), (w_ids, w_vals) in zip(got, want):
        assert g_ids == w_ids
        assert np.array_equal(g_vals, w_vals)
    assert streamed._device_corpus is None
    for blk in streamed._stream_blocks:
        assert blk["corpus"].is_pinned() and blk["corpus"].device.type == "cpu"
        assert blk["scales"] is None or blk["scales"].is_pinned()


@pytest.mark.cuda
def test_two_buffers_take_turns_and_the_copies_overlap_the_searches(cuda_device):
    rows = seeded_rows(2)
    streamed, _ = pair(cuda_device, rows)
    streamed.stream_timing = True
    streamed.search_knn(rows[:8], 10)
    bufs = streamed._stream_buffers
    assert len(bufs) == 2 and all(b["corpus"].shape == (BLOCK, DIM) for b in bufs)
    blocks = streamed._stream_blocks
    # blocks 0 and 2 went through buffer 0, block 1 through buffer 1
    assert torch.equal(bufs[0]["corpus"][:BLOCK].cpu(), blocks[2]["corpus"])
    assert torch.equal(bufs[1]["corpus"][:BLOCK].cpu(), blocks[1]["corpus"])
    events = streamed.stream_events
    assert len(events) == len(blocks) == 3
    torch.cuda.synchronize()
    for i, (c0, c1, s0, s1) in enumerate(events):
        assert c0.elapsed_time(c1) > 0 and s0.elapsed_time(s1) > 0
        assert c1.elapsed_time(s0) >= 0  # a block's search starts after its copy
        if i + 1 < len(events):  # the next copy is enqueued before this search
            assert events[i + 1][0].elapsed_time(s1) > 0
    again = streamed.search_knn(rows[:8], 10)
    assert streamed._stream_buffers is bufs  # made once
    assert [r[0][0] for r in again] == [str(i) for i in range(8)]


@pytest.mark.cuda
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_streamed_approx_equals_its_plain_version(cuda_device, compression, monkeypatch):
    rows = seeded_rows(3)
    streamed, _ = pair(cuda_device, rows, compression=compression)
    queries = rows[:16]
    got = streamed.search_knn(queries, 10, mode="approx")
    monkeypatch.setattr(indexer_module, "approx_topk_mips",
                        functools.partial(approx_topk_mips, plain=True))
    monkeypatch.setattr(indexer_module, "exact_topk_mips",
                        functools.partial(exact_topk_mips, plain=True))
    want = streamed.search_knn(queries, 10, mode="approx")
    for row, ((g_ids, g_vals), (w_ids, w_vals)) in enumerate(zip(got, want)):
        assert g_ids[0] == w_ids[0] == str(row)
        np.testing.assert_allclose(g_vals, w_vals, atol=1e-4)

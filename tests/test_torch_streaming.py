"""Streaming search (``TorchIndexer(max_device_rows=...)``) held against the
JAX package's own streaming (``TPUIndexer(max_device_rows=...)``) on the CPU.

Both packages cut the corpus into the same blocks (``max_device_rows``
rounded down to a multiple of 8, the last zero-padded), quantize int8/int4
blocks over the padded block (the codes and scales bitwise equal), search
each block and merge by value, then global row id. The port's exact search
is held to the reference's XLA scan (``exact_impl`` auto/plain), and its
kernel search (the plain versions on the CPU) to the reference's Pallas
kernel in interpret mode; the approximate search at W = 1 and 2, l2 (the
int8 alpha included), ``shuffle_rows``, ties across blocks and a block size
off the 8- and 128-row grids are covered. Ids are compared exactly, values
within 1e-5 (the l2 distances within 1e-4 of their size).
"""

import numpy as np
import pytest
import torch

from kirag_tpu.index import TPUIndexer
from kirag_tpu_torch.index import TorchIndexer


def unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def both(d, rows, port_kw=None, **kw):
    """The reference and the port over the same rows and options."""
    ref = TPUIndexer(d, **kw)
    port = TorchIndexer(d, device="cpu", **{**kw, **(port_kw or {})})
    ids = [f"d{i}" for i in range(len(rows))]
    ref.index_data(ids, rows)
    port.index_data(ids, rows)
    return ref, port


def assert_same_results(got, want, atol=1e-5):
    assert len(got) == len(want)
    for (g_ids, g_vals), (w_ids, w_vals) in zip(got, want):
        assert g_ids == w_ids
        np.testing.assert_allclose(g_vals, w_vals, atol=atol, rtol=1e-5)


@pytest.mark.parametrize("compression,d", [("none", 16), ("int8", 32), ("int4", 256)])
@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_exact_matches_the_reference_scan(rng, compression, d, impl):
    rows = unit_rows(rng, 700, d)
    queries = unit_rows(rng, 5, d)
    ref, port = both(d, rows, port_kw={"exact_impl": impl}, compression=compression,
                     chunk_size=64, max_device_rows=256)
    assert_same_results(port.search_knn(queries, 9), ref.search_knn(queries, 9))
    assert port._device_corpus is None and port._stream_blocks is not None


@pytest.mark.parametrize("compression,d", [("none", 8), ("int8", 16)])
def test_kernel_search_matches_the_reference_pallas_kernel(rng, compression, d):
    # the smallest shape that streams several blocks of several chunks
    # through the kernels (tests/test_index.py's test_streaming_blocks)
    rows = rng.randn(700, d).astype(np.float32)
    queries = rng.randn(2, d).astype(np.float32)
    ref, port = both(d, rows, port_kw={"exact_impl": "kernel"}, compression=compression,
                     pallas_chunk_size=128, max_device_rows=256)
    ref.exact_impl = "pallas"
    assert_same_results(port.search_knn(queries, 5), ref.search_knn(queries, 5))


@pytest.mark.parametrize("compression,d,metric", [
    ("int8", 32, "inner_product"), ("int4", 256, "inner_product"),
    ("int8", 32, "l2"), ("int4", 256, "l2"), ("none", 16, "l2")])
def test_block_codes_and_scales_are_the_references(rng, compression, d, metric):
    rows = (rng.randn(300, d) * rng.uniform(0.5, 3.0, (300, 1))).astype(np.float32)
    ref, port = both(d, rows, compression=compression, metric=metric, max_device_rows=123)
    ref._prepare_stream_blocks()
    port._prepare_stream_blocks()
    assert port._l2_alpha == ref._l2_alpha
    if compression == "int8" and metric == "l2":
        assert port._l2_alpha != 1.0  # the alpha this case is about
    assert len(port._stream_blocks) == len(ref._stream_blocks) == 3
    for got, want in zip(port._stream_blocks, ref._stream_blocks):
        assert (got["start"], got["valid"]) == (want["start"], want["valid"])
        codes = got["corpus"].numpy()
        w = want["corpus"].shape[1]
        assert codes.shape[0] == want["corpus"].shape[0] == 120
        np.testing.assert_array_equal(codes[:, :w], want["corpus"])
        assert not codes[:, w:].any()  # the l2 device width's zero columns
        if compression != "none":
            np.testing.assert_array_equal(got["scales"].numpy(), want["scales"])


@pytest.mark.parametrize("compression,d", [("none", 16), ("int8", 32), ("int4", 256)])
def test_l2_matches_the_reference(rng, compression, d):
    rows = (rng.randn(600, d) * rng.uniform(0.5, 3.0, (600, 1))).astype(np.float32)
    queries = rows[:4] + 0.01 * rng.randn(4, d).astype(np.float32)
    ref, port = both(d, rows, metric="l2", compression=compression, max_device_rows=200)
    got, want = port.search_knn(queries, 6), ref.search_knn(queries, 6)
    for (g_ids, g_vals), (w_ids, w_vals) in zip(got, want):
        assert g_ids == w_ids
        np.testing.assert_allclose(g_vals, w_vals, rtol=1e-4, atol=1e-4 * np.abs(w_vals).max())
    assert [r[0][0] for r in got] == ["d0", "d1", "d2", "d3"]


@pytest.mark.parametrize("compression,d,winners", [
    ("none", 16, 1), ("none", 16, 2), ("int8", 32, 2)])
def test_approx_matches_the_reference(rng, compression, d, winners):
    rows = unit_rows(rng, 1024, d)
    queries = rows[:4] + 0.05 * unit_rows(rng, 4, d)
    ref, port = both(d, rows, compression=compression, max_device_rows=512,
                     approx_winners=winners)
    assert_same_results(port.search_knn(queries, 5, mode="approx"),
                        ref.search_knn(queries, 5, mode="approx"))


def test_approx_with_fewer_candidates_than_k(rng):
    # 2 blocks of 2 groups, W = 1: 4 finite candidates for k = 7; the -inf
    # slots report each block's first row, merged by row id as the reference
    rows = unit_rows(rng, 500, 16)
    ref, port = both(16, rows, max_device_rows=256)
    got = port.search_knn(rows[:3], 7, mode="approx")
    assert_same_results(got, ref.search_knn(rows[:3], 7, mode="approx"))
    assert np.isinf(got[0][1][-1])


def test_shuffle_rows_matches_the_reference(rng):
    rows = unit_rows(rng, 900, 16)
    queries = rows[[5, 400, 899]]
    ref, port = both(16, rows, shuffle_rows=True, shuffle_seed=3, max_device_rows=300)
    for mode in ("exact", "approx"):
        assert_same_results(port.search_knn(queries, 6, mode=mode),
                            ref.search_knn(queries, 6, mode=mode))
    np.testing.assert_array_equal(port.index_id_to_db_id, ref.index_id_to_db_id)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_ties_across_blocks_go_to_the_lower_row(rng, impl):
    base = rng.randint(-3, 4, (64, 8)).astype(np.float32)
    rows = np.concatenate([base, base, base])  # three blocks of the same rows
    ref, port = both(8, rows, port_kw={"exact_impl": impl}, chunk_size=32,
                     max_device_rows=64)
    got = port.search_knn(base[:2], 5)
    assert_same_results(got, ref.search_knn(base[:2], 5))
    for ids, vals in got:
        assert int(ids[0][1:]) < 64  # the first block's copy wins
        top = [int(i[1:]) for i, v in zip(ids, vals) if v == vals[0]]
        assert len(top) >= 3 and top == sorted(top)


@pytest.mark.parametrize("max_device_rows", [301, 130, 9])
def test_block_size_off_the_grids(rng, max_device_rows):
    rows = unit_rows(rng, 520, 16)
    queries = unit_rows(rng, 3, 16)
    ref, port = both(16, rows, max_device_rows=max_device_rows)
    assert_same_results(port.search_knn(queries, 7), ref.search_knn(queries, 7))
    port._prepare_stream_blocks()
    ref._prepare_stream_blocks()
    size = max(8, max_device_rows // 8 * 8)
    assert [(b["start"], b["valid"]) for b in port._stream_blocks] == [
        (b["start"], b["valid"]) for b in ref._stream_blocks]
    assert all(len(b["corpus"]) == size for b in port._stream_blocks)


def test_k_beyond_the_corpus(rng):
    rows = unit_rows(rng, 40, 16)
    ref, port = both(16, rows, max_device_rows=16)
    got = port.search_knn(rows[:2], 50)
    assert_same_results(got, ref.search_knn(rows[:2], 50))
    assert len(got[0][0]) == 40


def test_refusals():
    with pytest.raises(ValueError, match="streaming"):
        TorchIndexer(64, device="cpu", compression="pq", max_device_rows=128)
    with pytest.raises(NotImplementedError, match="multi-GPU index"):
        TorchIndexer(64, device="cpu", mesh=object(), max_device_rows=128)
    with pytest.raises(ValueError, match="streaming"):
        TPUIndexer(64, compression="pq", max_device_rows=128)


def test_streaming_never_places_the_corpus(rng, monkeypatch):
    def refuse(self):
        raise AssertionError("a streamed index placed its whole corpus")

    monkeypatch.setattr(TorchIndexer, "to_device", refuse)
    rows = unit_rows(rng, 300, 16)
    index = TorchIndexer(16, device="cpu", max_device_rows=128, metric="l2")
    index.index_data(range(300), rows)
    for mode in ("exact", "approx"):
        assert index.search_knn(rows[:2], 3, mode=mode)[0][0][0] == "0"
    assert index._device_corpus is None


def test_small_corpus_is_placed_whole(rng):
    rows = unit_rows(rng, 100, 16)
    index = TorchIndexer(16, device="cpu", max_device_rows=100)
    index.index_data(range(100), rows)
    index.search_knn(rows[:1], 3)
    assert index._stream_blocks is None and index._device_corpus is not None


def test_blocks_are_made_again_after_a_change(rng, tmp_path):
    rows = unit_rows(rng, 300, 16)
    index = TorchIndexer(16, device="cpu", max_device_rows=128)
    index.index_data(range(300), rows)
    index.search_knn(rows[:1], 3)
    first = index._stream_blocks
    index.search_knn(rows[:1], 3)
    assert index._stream_blocks is first  # prepared once, reused
    more = unit_rows(rng, 50, 16)
    index.index_data(range(300, 350), more)
    assert index._stream_blocks is None
    assert index.search_knn(more[:1], 1)[0][0] == ["300"]
    assert sum(b["valid"] for b in index._stream_blocks) == 350
    index.serialize(str(tmp_path))
    index.deserialize_from(str(tmp_path))
    assert index._stream_blocks is None
    assert index.search_knn(more[:1], 1)[0][0] == ["300"]


def test_stream_blocks_are_ordinary_cpu_tensors_on_the_cpu(rng):
    rows = unit_rows(rng, 300, 16)
    index = TorchIndexer(16, device="cpu", max_device_rows=128, device_dtype=torch.bfloat16)
    index.index_data(range(300), rows)
    index._prepare_stream_blocks()
    blk = index._stream_blocks[-1]
    assert blk["corpus"].dtype == torch.bfloat16 and blk["corpus"].device.type == "cpu"
    assert blk["valid"] == 300 - 256 and not blk["corpus"][blk["valid"]:].any()
    want = torch.from_numpy(rows[256:]).to(torch.bfloat16)
    assert torch.equal(blk["corpus"][:blk["valid"]], want)

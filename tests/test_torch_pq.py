"""The port's product quantization (``compression="pq"``) held against the
JAX package.

``ops/pq.py`` (the level table, the decoder and the FAISS mapping bitwise;
the encoder's codes on integer data; the Lloyd iterations from the
reference's initial rows), K4's pq4 scoring (``quant_scores`` against
``pallas_exact._chunk_scores``), the exact search with ``quant="pq4"``
through the plain K1/K2 against JAX's stream kernel in Pallas interpret
mode, and ``TorchIndexer(compression="pq")`` against ``TPUIndexer``: the
reference's own PQ behaviours (``tests/test_index.py``), indexes serialized
by either package loaded by the other, and the pad rows of a partial last
group, whose zero codes decode to centroid 0.

Tolerances: integer-valued fixtures (small-integer queries and levels, exact
in bf16) are exact in any summation order and compare bitwise, ids and tie
order included; on random data the two packages sum the same exact f32
products in other orders, within 1e-6 of the largest score (1e-5 absolute
for unit rows). The port's k-means draws its initial rows as the
reference's ``jax.random.choice`` does (a numpy restatement of JAX's
Threefry draws, held bitwise here), so both packages start from the same
rows; an index loaded from disk uses the codebooks it was written with.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kirag_tpu.index.indexer import TPUIndexer
from kirag_tpu.ops import pq as jpq
from kirag_tpu.ops.pallas_exact import _chunk_scores as jax_chunk_scores
from kirag_tpu.ops.pallas_exact import exact_topk_mips as jax_exact
from kirag_tpu_torch.index import TorchIndexer
from kirag_tpu_torch.kernels import gather_groups, quant_scores, stream_capture
from kirag_tpu_torch.ops import pq as tpq
from kirag_tpu_torch.ops.exact import exact_topk_mips
from kirag_tpu_torch.utils import jax_random

ATOL = 1e-5


def clustered(rng, n=768, d=64, n_centers=48, noise=0.03):
    """The reference tests' clustered unit rows."""
    centers = rng.randn(n_centers, d).astype(np.float32)
    c = centers[rng.randint(0, n_centers, n)] + noise * rng.randn(n, d).astype(np.float32)
    return c / np.linalg.norm(c, axis=-1, keepdims=True)


def integer_pq(rng, n, d, m):
    """Random codes [n, m/2] and small-integer codebooks [m, 16, d/m]."""
    codes = rng.randint(0, 256, (n, m // 2)).astype(np.uint8)
    codebooks = rng.randint(-3, 4, (m, 16, d // m)).astype(np.float32)
    return codes, codebooks


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (2^-7 of its power of two)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


# ------------------------------------------------------------------ ops/pq.py


def test_level_table_and_decode_are_the_references(rng):
    for m, ds in ((16, 4), (8, 1), (32, 2)):
        codebooks = rng.randn(m, 16, ds).astype(np.float32)
        codes = rng.randint(0, 256, (50, m // 2)).astype(np.uint8)
        want, got = jpq.pq_level_table(codebooks), tpq.pq_level_table(codebooks)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(tpq.decode_pq(codes, codebooks), jpq.decode_pq(codes, codebooks))
        assert tpq.pq_bytes_per_row(m * ds, m) == jpq.pq_bytes_per_row(m * ds, m) == m // 2


@pytest.mark.parametrize("d,n_subquantizers,n_bits", [
    (64, 16, 4), (64, 16, 8), (256, 64, 8), (1024, 256, 8), (1024, 256, 4), (1024, 128, 2),
    (100, 30, 8), (768, 100, 4), (10, 64, 8), (6, 1, 4), (2, 1, 8)])
def test_resolve_subquantizers_is_the_references(d, n_subquantizers, n_bits):
    assert (tpq.resolve_subquantizers(d, n_subquantizers, n_bits)
            == jpq.resolve_subquantizers(d, n_subquantizers, n_bits))


def test_encoder_codes_equal_the_references_on_integer_data(rng):
    """Small-integer rows, codebooks trained by the reference: every
    assignment score is exact, so the codes (ties to the lower centroid
    included) are the reference's."""
    rows = rng.randint(-4, 5, (600, 64)).astype(np.float32)
    rows[:4] = 0  # every centroid ties on a zero subvector whose norms tie
    codebooks = jpq.train_pq(rows, 16, iters=5, seed=0)
    want = jpq.encode_pq(rows, codebooks)
    got = tpq.encode_pq(torch.from_numpy(rows), torch.from_numpy(codebooks), batch=256)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    ties = rng.randint(-1, 2, (16, 16, 4)).astype(np.float32)      # repeated centroids
    assert np.array_equal(tpq.encode_pq(torch.from_numpy(rows), torch.from_numpy(ties)).numpy(),
                          jpq.encode_pq(rows, ties))


def test_lloyd_from_the_references_initial_rows(rng):
    """16 clusters well separated in every subspace (normal centers, noise
    of 1e-3), with the rows ``jax.random.choice`` draws to start k-means in
    16 different clusters: both packages, started from those rows, give
    codebooks within one bf16 ulp (the cluster means, summed in other
    orders)."""
    init = np.asarray(jax.random.choice(jax.random.key(3), 2048, shape=(16,), replace=False))
    labels = rng.randint(0, 16, 2048)
    labels[init] = np.arange(16)
    centers = rng.randn(16, 64).astype(np.float32)
    sample = (centers[labels] + 1e-3 * rng.randn(2048, 64)).astype(np.float32)
    want = jpq.train_pq(sample, 16, iters=10, seed=3)
    got = tpq.lloyd(torch.from_numpy(sample), 16, torch.tensor(init), 10)
    got = got.to(torch.bfloat16).float().numpy()
    assert np.all(np.abs(got - want) <= bf16_ulp(want))
    # the port's own seeded start: same shape, bf16-snapped, deterministic
    a = tpq.train_pq(sample, 16, iters=3, seed=3).numpy()
    assert a.shape == (16, 16, 4) and np.array_equal(a, tpq.train_pq(sample, 16, 3, 3).numpy())
    assert np.array_equal(a, a.astype(ml_dtypes.bfloat16).astype(np.float32))
    with pytest.raises(ValueError, match="at least 16"):
        tpq.train_pq(sample[:10], 16)
    with pytest.raises(ValueError, match="even subquantizer"):
        tpq.train_pq(sample, 12)


@pytest.mark.parametrize("n,seed", [(16, 0), (100, 3), (1625, 1), (1626, 7), (2048, 3),
                                    (131072, 0), (3_000_000, 12345)])
def test_init_rows_are_jax_random_choice(n, seed):
    """The numpy restatement of JAX's draw, bitwise, on both sides of the
    population sizes where ``permutation`` takes a second sort round
    (n > 1625) and a third (n > 2^21.3)."""
    want = np.asarray(jax.random.choice(jax.random.key(seed), n, shape=(16,), replace=False))
    assert tpq.init_rows(n, seed).tolist() == want.tolist()
    k = jax.random.key(seed)
    assert np.array_equal(np.asarray(jax.random.key_data(jax.random.split(k, 3))),
                          jax_random.split(jax_random.key(seed), 3))
    assert np.array_equal(np.asarray(jax.random.bits(k, (50,))),
                          jax_random.random_bits32(jax_random.key(seed), 50))


@pytest.mark.parametrize("seed", [0, 5])
def test_train_pq_from_the_same_seed_gives_the_references_codebooks(rng, seed):
    """Fresh builds of both packages from one sample and seed: the same
    initial rows, so codebooks within one bf16 ulp (cluster means of well
    separated clusters, each initial row in a cluster of its own)."""
    init = jax_random.choice_without_replacement(seed, 2048, 16)
    labels = rng.randint(0, 16, 2048)
    labels[init] = np.arange(16)
    centers = rng.randn(16, 64).astype(np.float32)
    sample = (centers[labels] + 1e-3 * rng.randn(2048, 64)).astype(np.float32)
    want = jpq.train_pq(sample, 16, iters=10, seed=seed)
    got = tpq.train_pq(sample, 16, iters=10, seed=seed).numpy()
    assert np.all(np.abs(got - want) <= bf16_ulp(want))


# ------------------------------------------------------- K4's pq4 scoring


@pytest.mark.parametrize("m,ds", [(16, 4), (64, 1), (32, 8)])
def test_quant_scores_match_chunk_scores(rng, m, ds):
    d = m * ds
    codebooks = (rng.randn(m, 16, ds) / np.sqrt(d)).astype(np.float32)
    table = tpq.pq_level_table(codebooks.astype(ml_dtypes.bfloat16).astype(np.float32))
    codes = rng.randint(0, 256, (300, m // 2)).astype(np.uint8)
    q = rng.randn(5, d).astype(np.float32)
    want = np.asarray(jax_chunk_scores(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(table),
                                       "pq4"))
    got = quant_scores(*map(torch.from_numpy, (q, codes, table)), "pq4").numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # on integer data the same numbers bitwise, and the decode oracle's
    codes, codebooks = integer_pq(rng, 300, d, m)
    qi = rng.randint(-2, 3, (5, d)).astype(np.float32)
    table = tpq.pq_level_table(codebooks)
    got = quant_scores(*map(torch.from_numpy, (qi, codes, table)), "pq4").numpy()
    assert np.array_equal(got, np.asarray(jax_chunk_scores(
        jnp.asarray(qi), jnp.asarray(codes), jnp.asarray(table), "pq4")))
    assert np.array_equal(got, qi @ tpq.decode_pq(codes, codebooks).T)


def run_both(q, codes, table, k, chunk, on_miss, valid_rows=None):
    j = jax_exact(jnp.asarray(q), jnp.asarray(codes), k, chunk_size=chunk,
                  valid_rows=valid_rows, interpret=True, impl="stream", select="capdom",
                  on_miss=on_miss, scales=jnp.asarray(table), quant="pq4")
    t = exact_topk_mips(torch.from_numpy(q), torch.from_numpy(codes), k, chunk_size=chunk,
                        valid_rows=valid_rows, on_miss=on_miss, scales=torch.from_numpy(table),
                        quant="pq4", plain=True, select="capdom", impl="stream")
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def test_exact_search_matches_jax_stream_kernel_on_integer_data(rng):
    """m = 64 at D = 256: ids, values and the flag equal, tie order too. A
    zero query row ties its residual and fails the flag; the fallback
    re-scores through K2. Then 8 chunks of 4 groups, all captured."""
    codes, codebooks = integer_pq(rng, 4096, 256, 64)
    table = tpq.pq_level_table(codebooks)
    q = rng.randint(-1, 2, (8, 256)).astype(np.float32)
    q[7] = 0
    for chunk, k, on_misses in ((2048, 8, ("flag", "fallback")), (512, 20, ("flag",))):
        for on_miss in on_misses:
            j, t = run_both(q, codes, table, k, chunk, on_miss, valid_rows=4000)
            np.testing.assert_array_equal(t[0], j[0])
            np.testing.assert_array_equal(t[1], j[1])
            if on_miss == "flag":
                assert bool(t[2]) == bool(j[2]) == (chunk == 512)
    dense = q @ tpq.decode_pq(codes, codebooks)[:4000].T
    order = np.lexsort((np.broadcast_to(np.arange(4000), dense.shape), -dense), axis=1)[:, :20]
    np.testing.assert_array_equal(t[1], order)


def test_kernel_plain_versions_keep_the_table_whole(rng):
    """K1 and K2's plain versions on a pq4 corpus: the [16, D] table is not
    sliced by rows; K1's captures equal K2's re-scores and the decode
    oracle's scores."""
    codes, codebooks = integer_pq(rng, 1024, 128, 32)
    q = rng.randint(-2, 3, (3, 128)).astype(np.float32)
    table = tpq.pq_level_table(codebooks)
    qt, ct, st = map(torch.from_numpy, (q, codes, table))
    _, capture, gids, _, _ = stream_capture(qt, ct, 1000, 512, 2, st, "pq4")
    captured = gids.permute(2, 0, 1).reshape(3, -1)
    rescored = gather_groups(qt, ct, captured, st, "pq4")
    np.testing.assert_array_equal(rescored.view(3, 2, 2, 128).transpose(0, 1).numpy(),
                                  capture.view(2, 3, 2, 128).numpy())
    dense = q @ tpq.decode_pq(codes, codebooks).T
    rows = captured.numpy()[..., None] * 128 + np.arange(128)
    np.testing.assert_array_equal(rescored.numpy(), np.take_along_axis(
        dense, rows.reshape(3, -1), axis=1).reshape(3, -1, 128))
    with pytest.raises(ValueError, match="level table"):
        stream_capture(qt, ct, 1000, 512, 2, st[:8], "pq4")


def kernel_table_levels(table: torch.Tensor, m: int, ds: int) -> np.ndarray:
    """The kernels' table (csrc/score.cuh's pq4 layout) read back as the
    [m, 16, D/m] codebook values it holds: entry h of subspace s and code n
    at byte ``pq_table_offsets(D, m, s, h, n)``, component U h + u at its
    bf16 u."""
    from kirag_tpu_torch.kernels.exact import pq_table_geometry, pq_table_offsets

    u, h = pq_table_geometry(ds)[:2]
    flat = table.float().numpy()
    out = np.empty((m, 16, ds), dtype=np.float32)
    for s, hh, n, uu in np.ndindex(m, h, 16, u):
        out[s, n, u * hh + uu] = flat[pq_table_offsets(m * ds, m, s, hh, n) // 2 + uu]
    return out


def test_kernel_table_is_built_once_per_table(rng):
    """The kernels' copy of the level table (bf16 in csrc/score.cuh's pq4
    layout) is made at the first launch and reused while the table is not
    written; padding and row views leave the table whole."""
    from kirag_tpu_torch.kernels.exact import _pq_kernel_table, pad_rows, row_scales

    codes, codebooks = integer_pq(rng, 256, 128, 32)
    table = torch.from_numpy(tpq.pq_level_table(codebooks))
    first = _pq_kernel_table(table, 32)
    assert _pq_kernel_table(table, 32) is first
    want = codebooks.astype(ml_dtypes.bfloat16).astype(np.float32)       # [m, 16, D/m]
    np.testing.assert_array_equal(kernel_table_levels(first, 32, 4), want)
    table.mul_(2)
    again = _pq_kernel_table(table, 32)
    assert again is not first
    np.testing.assert_array_equal(kernel_table_levels(again, 32, 4), 2 * want)
    ct = torch.from_numpy(codes)
    padded, same = pad_rows(ct, table, 384, "pq4")
    assert padded.shape == (384, 16) and same is table and not padded[256:].any()
    assert row_scales(table, slice(0, 128), "pq4") is table


def test_tiny_corpus_path_and_padding_keep_the_table(rng):
    """One 128-row group (the dense path of both searches) and a corpus
    off the chunk grid (padded per call: codes with zeros, not the table)."""
    c = clustered(rng, n=1000, d=64)
    codebooks = jpq.train_pq(c, 16, iters=5, seed=0)
    codes = jpq.encode_pq(c, codebooks)
    table = jpq.pq_level_table(codebooks)
    q = c[:3]
    for n, chunk, k in ((100, 128, 95), (1000, 256, 10)):
        j, t = run_both(q, codes[:n], table, k, chunk, "fallback", valid_rows=n - 10)
        np.testing.assert_array_equal(t[1], j[1])
        np.testing.assert_allclose(t[0], j[0], atol=ATOL, rtol=0)


# ---------------------------------------------------------- TorchIndexer


def both_indexers(d, **kw):
    return TPUIndexer(d, **kw), TorchIndexer(d, device="cpu", **kw)


def test_faiss_request_maps_to_codebook_pq():
    for ix in both_indexers(256, n_subquantizers=64, n_bits=4):
        assert ix.compression == "pq" and ix.pq_m == 64
    for ix in both_indexers(256, n_subquantizers=64, n_bits=8):
        assert ix.compression == "pq" and ix.pq_m == 128
    for ix in both_indexers(256, n_subquantizers=64, n_bits=8, compression="pq"):
        assert ix.pq_m == 64  # explicit pq: n_subquantizers is the 4-bit count
    for ix in both_indexers(256, compression="pq"):
        assert ix.pq_m == 64  # default m = D / 4
    for ix in both_indexers(256, n_subquantizers=64, compression="int8"):
        assert ix.compression == "int8" and ix.pq_m == 0


def test_planted_neighbours_found_at_top_1(rng):
    c = rng.randn(1024, 64).astype(np.float32)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    q = rng.randn(6, 64).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    c[:6] = q + 0.15 * c[:6]
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    ix = TorchIndexer(64, device="cpu", compression="pq", n_subquantizers=16, chunk_size=256,
                      pallas_chunk_size=256)
    ix.index_data(range(1024), c)
    for row, (ids, vals) in enumerate(ix.search_knn(q, top_docs=5)):
        assert ids[0] == str(row)
        assert np.isfinite(vals).all() and vals[0] >= vals[-1]


def test_recall_on_clustered_corpus(rng):
    c = clustered(rng)
    q = c[rng.randint(0, len(c), 8)] + 0.01 * rng.randn(8, 64).astype(np.float32)
    exact = TorchIndexer(64, device="cpu", chunk_size=256)
    exact.index_data(range(len(c)), c)
    pq = TorchIndexer(64, device="cpu", compression="pq", n_subquantizers=16,
                      pallas_chunk_size=256)
    pq.index_data(range(len(c)), c)
    recalls = [len(set(a) & set(b)) / 20 for (a, _), (b, _) in
               zip(exact.search_knn(q, top_docs=20), pq.search_knn(q, top_docs=20))]
    assert np.mean(recalls) >= 0.6, recalls


def test_memory_footprint(rng):
    ix = TorchIndexer(64, device="cpu", compression="pq", n_subquantizers=16,
                      pallas_chunk_size=256)
    ix.index_data(range(512), clustered(rng, n=512))
    ix.to_device()
    assert ix._device_corpus.dtype == torch.uint8
    assert ix._device_corpus.shape == (512, 8)           # m/2 bytes a row
    assert tuple(ix._device_scales.shape) == (16, 64)    # the level table
    assert np.array_equal(ix._device_scales.numpy(), tpq.pq_level_table(ix._pq_codebooks))


def test_results_are_the_decode_oracles_with_faiss_ties(rng):
    """Exact search over the codes: the brute force over the decoded corpus,
    ties (duplicate codes) to the lower row id; the codes are the encoder's."""
    c = clustered(rng, n=640)
    ix = TorchIndexer(64, device="cpu", compression="pq", n_subquantizers=16,
                      pallas_chunk_size=256)
    ix.index_data(range(640), c)
    ix.to_device()
    codes = ix._device_corpus[:640].numpy()
    assert np.array_equal(codes, jpq.encode_pq(c, ix._pq_codebooks))
    assert not ix._device_corpus[640:].any()             # pad rows: zero codes
    recon = tpq.decode_pq(codes, ix._pq_codebooks)
    q = c[:5]
    scores = (q.astype(ml_dtypes.bfloat16).astype(np.float32)
              @ recon.astype(ml_dtypes.bfloat16).astype(np.float32).T)
    for (ids, vals), row in zip(ix.search_knn(q, top_docs=9), scores):
        order = np.argsort(-row, kind="stable")[:9]
        assert ids == [str(i) for i in order]
        np.testing.assert_allclose(vals, row[order], rtol=2e-3, atol=2e-3)


def test_serialize_roundtrip_same_codes(rng, tmp_path):
    c = clustered(rng, n=512)
    ix = TorchIndexer(64, device="cpu", compression="pq", n_subquantizers=16,
                      pallas_chunk_size=256)
    ix.index_data(range(512), c)
    r0 = ix.search_knn(c[:4], top_docs=7)
    ix.serialize(str(tmp_path))
    loaded = TorchIndexer(64, device="cpu", pallas_chunk_size=256)
    loaded.deserialize_from(str(tmp_path))
    assert loaded.compression == "pq" and loaded.pq_m == 16
    np.testing.assert_array_equal(loaded._pq_codebooks, ix._pq_codebooks)
    loaded.pq_iters = 0  # a retraining would move the codebooks
    for (a, va), (b, vb) in zip(r0, loaded.search_knn(c[:4], top_docs=7)):
        assert a == b
        np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(loaded._pq_codebooks, ix._pq_codebooks)


def test_serialize_trains_before_any_search(rng, tmp_path):
    c = clustered(rng, n=300)
    ix = TorchIndexer(64, device="cpu", compression="pq", n_subquantizers=16)
    ix.index_data(range(300), c)
    ix.serialize(str(tmp_path))
    cb = np.load(tmp_path / "pq_codebooks.npy")
    assert cb.shape == (16, 16, 4) and cb.dtype == np.float32
    cfg = __import__("json").loads((tmp_path / "index_config.json").read_text())
    assert cfg["compression"] == "pq" and cfg["pq_m"] == 16


@pytest.mark.parametrize("writer", ["TPUIndexer", "TorchIndexer"])
def test_indexes_load_across_packages(rng, tmp_path, writer):
    """A PQ index serialized by either package serves the same ids (scores
    within 1e-5) from the other: both load its codebooks."""
    c = clustered(rng, n=900)
    q = np.concatenate([c[:4], clustered(rng, n=4)])
    ref, port = both_indexers(64, compression="pq", n_subquantizers=16, pallas_chunk_size=256)
    src, dst = (ref, port) if writer == "TPUIndexer" else (port, ref)
    src.index_data(range(900), c)
    src.serialize(str(tmp_path))
    dst.deserialize_from(str(tmp_path))
    assert dst.compression == "pq" and dst.pq_m == 16
    np.testing.assert_array_equal(dst._pq_codebooks, src._pq_codebooks)
    for (w_ids, w_vals), (g_ids, g_vals) in zip(ref.search_knn(q, 10), port.search_knn(q, 10)):
        assert g_ids == w_ids
        np.testing.assert_allclose(g_vals, w_vals, atol=ATOL, rtol=0)


def test_guards():
    for cls in (TPUIndexer, TorchIndexer):
        kw = {} if cls is TPUIndexer else {"device": "cpu"}
        with pytest.raises(ValueError, match="inner_product"):
            cls(64, metric="l2", compression="pq", **kw)
        with pytest.raises(ValueError, match="streaming"):
            cls(64, compression="pq", max_device_rows=128, **kw)
        with pytest.raises(KeyError, match="compression"):
            cls(64, compression="pq8", **kw)


def test_approx_mode_serves_exact(rng):
    c = clustered(rng, n=512)
    ix = TorchIndexer(64, device="cpu", compression="pq", n_subquantizers=16,
                      pallas_chunk_size=256)
    ix.index_data(range(512), c)
    for (a, va), (b, vb) in zip(ix.search_knn(c[:3], top_docs=5, mode="approx"),
                                ix.search_knn(c[:3], top_docs=5)):
        assert a == b
        np.testing.assert_array_equal(va, vb)


def test_pad_rows_of_a_partial_last_group_are_masked(rng, tmp_path):
    """Zero codes decode to centroid 0 of every subspace, so the pad rows of
    a partial last group score as that centroid, not 0. A query that
    centroid 0 wins everywhere must still get only indexed rows, in both
    packages."""
    codes_rows = np.repeat(np.eye(64, dtype=np.float32)[:4], 75, axis=0)  # 300 rows
    ref, port = both_indexers(64, compression="pq", n_subquantizers=16, pallas_chunk_size=128)
    codebooks = np.full((16, 16, 4), -1.0, np.float32)
    codebooks[:, 0] = 2.0                  # centroid 0: the best for a positive query
    for ix in (ref, port):
        ix._pq_codebooks = codebooks
        ix.index_data(range(300), codes_rows)
    q = np.ones((2, 64), np.float32)
    for (w_ids, w_vals), (g_ids, g_vals) in zip(ref.search_knn(q, 20), port.search_knn(q, 20)):
        assert g_ids == w_ids and all(int(i) < 300 for i in g_ids)
        np.testing.assert_array_equal(g_vals, w_vals)
    padded = port._device_corpus
    assert padded.shape[0] == 384 and not padded[300:].any()
    pad_score = quant_scores(torch.from_numpy(q[:1]), padded[300:301], port._device_scales,
                             "pq4")
    assert float(pad_score) == 128.0 > float(port.search_knn(q, 1)[0][1][0])


def test_ntotal_n_bits_and_verbose_as_the_reference(rng):
    c = clustered(rng, n=300)
    ref, port = both_indexers(64, n_bits=8)
    assert ref.compression == port.compression == "none"   # n_bits alone changes nothing
    for ix in (ref, port):
        assert ix.ntotal == 0
        ix.index_data(range(300), c)
        assert ix.ntotal == len(ix) == 300
    for (w_ids, w_vals), (g_ids, g_vals) in zip(ref.search_knn(c[:3], 5, verbose=True),
                                                port.search_knn(c[:3], 5, verbose=True)):
        assert g_ids == w_ids
        np.testing.assert_allclose(g_vals, w_vals, atol=ATOL, rtol=0)


def test_cuda_indexes_refuse_geometries_the_kernels_do_not_take(rng, tmp_path):
    """On a CUDA device the pq4 kernels take D / m in {1, 2, 4, 8}, m / 2 a
    multiple of 16 and D up to 2048: other PQ indexes are refused when built
    and when loaded, not at the first search; the CPU takes any geometry."""
    for d, m in ((64, 16), (1536, 96), (4096, 512), (2048, 128)):
        with pytest.raises(ValueError, match="pq4 kernels"):
            TorchIndexer(d, compression="pq", n_subquantizers=m, device="cuda")
        assert TorchIndexer(d, compression="pq", n_subquantizers=m, device="cpu").pq_m == m
    for d, m in ((1024, 256), (1024, 128), (1024, 512), (768, 96), (2048, 1024)):
        assert TorchIndexer(d, compression="pq", n_subquantizers=m, device="cuda").pq_m == m
    # FAISS's PQ(128, 8) at D = 1024: 256 4-bit subquantizers, which the card takes
    assert TorchIndexer(1024, n_subquantizers=128, n_bits=8, device="cuda").pq_m == 256
    writer = TorchIndexer(64, compression="pq", n_subquantizers=16, device="cpu")
    writer.index_data(range(300), clustered(rng, n=300))
    writer.serialize(str(tmp_path))
    with pytest.raises(ValueError, match="pq4 kernels"):
        TorchIndexer(64, device="cuda").deserialize_from(str(tmp_path))

"""The port's exact-search variants held against the JAX package.

``kirag_tpu_torch.ops.exact.exact_topk_mips`` with every ``impl``
(stream, single, single_strided, twopass, auto) and ``select`` (flat, hier,
capdom in both assemblies, merge), on the CPU through the plain versions of
K1, K2, K7a, K7b, K8 and K9, against
``kirag_tpu.ops.pallas_exact.exact_topk_mips(..., interpret=True)`` on the
same numpy inputs, in float32, int8, int4 and pq4 and both ``on_miss``
modes. Then the plain K7a and K9 against order-free numpy statements,
``topk_mips_onepass``/``topk_lastdim`` against JAX, and ``TorchIndexer``
against ``TPUIndexer`` for each ``pallas_select``.

Shapes stay below the reference's chunk clamps, so both sides run one chunk
geometry and capture budget. Tolerances: values within 1e-5 (f32 sums of at
most 256 exact products of O(1) scores, in other orders); ids and ``ok``
equal. Integer-valued inputs are exact on both sides and compare bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kirag_tpu.index import TPUIndexer
from kirag_tpu.ops import mips as jax_mips
from kirag_tpu.ops import pallas_exact as pe
from kirag_tpu_torch.index import TorchIndexer
from kirag_tpu_torch.kernels import (
    cap_assemble,
    score_gather,
    score_gmax,
    stream_capture,
    window_merge,
)
from kirag_tpu_torch.ops import exact as ops_exact
from kirag_tpu_torch.ops import topk_lastdim, topk_mips_onepass
from kirag_tpu_torch.ops.exact import _capture_budget, _resolve_impl, exact_topk_mips

ATOL = 1e-5
# every (impl, select) of the reference; capdom and merge only exist on stream
COMBOS = [("stream", "flat"), ("stream", "hier"), ("stream", "capdom"), ("stream", "merge"),
          ("single", "hier"), ("single_strided", "hier"), ("twopass", "flat"),
          ("twopass", "hier")]
COMBO_IDS = [f"{i}-{s}" for i, s in COMBOS]


def numpy_topk(scores, k):
    """FAISS order: descending value, ties to the lower row id."""
    order = np.lexsort((np.broadcast_to(np.arange(scores.shape[1]), scores.shape),
                        -scores), axis=1)[:, :k]
    return np.take_along_axis(scores, order, axis=1), order


def run_both(q, c, k, chunk, impl, select, on_miss="fallback", valid_rows=None, scales=None,
             quant=None):
    kw = dict(chunk_size=chunk, valid_rows=valid_rows, on_miss=on_miss, quant=quant)
    if impl is not None:
        kw.update(impl=impl, select=select)
    j = pe.exact_topk_mips(jnp.asarray(q), jnp.asarray(c), k, interpret=True,
                           scales=None if scales is None else jnp.asarray(scales), **kw)
    t = exact_topk_mips(torch.from_numpy(q), torch.from_numpy(c), k,
                        scales=None if scales is None else torch.from_numpy(scales), **kw)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def assert_same(j, t, exact=False):
    np.testing.assert_array_equal(t[1], j[1])
    if exact:
        np.testing.assert_array_equal(t[0], j[0])
    else:
        np.testing.assert_allclose(t[0], j[0], atol=ATOL, rtol=0)
    if len(j) == 3:
        assert bool(t[2]) == bool(j[2])


def corpus(fmt, rng):
    """(q, c, scales, quant, chunk, k) of one format: 2 to 4 chunks of 2048
    rows, 16 groups each, so the capture (8 groups) is partial and merge's
    window ejects groups."""
    if fmt == "float32":
        return (rng.randn(6, 32).astype(np.float32), rng.randn(8192, 32).astype(np.float32),
                None, None, 2048, 10)
    q = rng.randn(6, 256 if fmt in ("int4", "pq4") else 64).astype(np.float32)
    if fmt == "int8":
        codes = rng.randint(-127, 128, (4096, 64)).astype(np.int8)
        scales = (rng.rand(4096) / 127 / 8).astype(np.float32)
        return q, codes, scales, None, 2048, 5
    if fmt == "int4":
        codes = rng.randint(0, 256, (4096, 128)).astype(np.uint8)
        scales = (rng.rand(4096, 2) / 7.5 / 16).astype(np.float32)
        return q, codes, scales, None, 2048, 5
    codes = rng.randint(0, 256, (4096, 32)).astype(np.uint8)  # pq4, m = 64, D / m = 4
    table = (rng.randn(16, 256) / 16).astype(np.float32)
    return q, codes, table, "pq4", 2048, 5


@pytest.mark.parametrize("on_miss", ["fallback", "flag"])
@pytest.mark.parametrize("impl,select", COMBOS, ids=COMBO_IDS)
@pytest.mark.parametrize("fmt", ["float32", "int8", "int4", "pq4"])
def test_variant_matches_jax(rng, fmt, impl, select, on_miss):
    q, c, scales, quant, chunk, k = corpus(fmt, rng)
    valid = c.shape[0] - 100
    j, t = run_both(q, c, k, chunk, impl, select, on_miss, valid, scales, quant)
    assert_same(j, t)
    assert t[1].max() < valid


@pytest.mark.parametrize("fmt", ["float32", "int4"])
def test_defaults_are_the_references(rng, fmt):
    """No impl and select: "auto" and "flat" on both sides."""
    q, c, scales, quant, chunk, k = corpus(fmt, rng)
    j, t = run_both(q, c, k, chunk, None, None, "flag", scales=scales, quant=quant)
    assert_same(j, t)
    assert bool(t[2])


@pytest.mark.parametrize("fmt", ["float32", "int8"])
def test_capdom_assemblies_match_jax(rng, fmt, monkeypatch):
    """KIRAG_CAPDOM_ASSEMBLY "pallas" (K8) and "einsum" (the indexing
    gather) against the reference's same two forms: bitwise each other."""
    q, c, scales, quant, chunk, k = corpus(fmt, rng)
    outs = {}
    try:
        for mode in ("pallas", "einsum"):
            monkeypatch.setattr(pe, "CAPDOM_ASSEMBLY", mode)
            monkeypatch.setattr(ops_exact, "CAPDOM_ASSEMBLY", mode)
            jax.clear_caches()  # the reference reads the mode while tracing
            j, t = run_both(q, c, k, chunk, "stream", "capdom", "flag", c.shape[0] - 7,
                            scales, quant)
            assert_same(j, t)
            outs[mode] = t
    finally:
        jax.clear_caches()
    for x, y in zip(outs["pallas"], outs["einsum"]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("impl,select", COMBOS, ids=COMBO_IDS)
def test_integer_ties_lower_row_wins(rng, impl, select):
    # few distinct scores: every selection boundary is a tie
    q = rng.randint(-1, 2, (4, 16)).astype(np.float32)
    c = rng.randint(-1, 2, (8192, 16)).astype(np.float32)
    j, t = run_both(q, c, 20, 2048, impl, select)
    assert_same(j, t, exact=True)
    ovals, oidx = numpy_topk(q @ c.T, 20)
    np.testing.assert_array_equal(t[1], oidx)
    np.testing.assert_array_equal(t[0], ovals)


@pytest.mark.parametrize("impl,select", COMBOS, ids=COMBO_IDS)
def test_valid_rows_poisoned_tail(rng, impl, select):
    q = rng.randn(4, 32).astype(np.float32)
    c = rng.randn(8192, 32).astype(np.float32)
    valid = 7000
    c[valid:] = 1e4  # rows past valid_rows would win every query
    for on_miss in ("flag", "fallback"):
        j, t = run_both(q, c, 12, 2048, impl, select, on_miss, valid_rows=valid)
        assert t[1].max() < valid
        assert_same(j, t)
        _, oidx = numpy_topk(q @ c[:valid].T, 12)
        np.testing.assert_array_equal(t[1], oidx)


@pytest.mark.parametrize("impl,select", [("stream", "merge"), ("single", "hier"),
                                         ("twopass", "flat"), ("stream", "flat")])
def test_k_at_or_beyond_the_groups(rng, impl, select):
    """k >= groups: the dense tiny-corpus path in every variant; slots
    beyond the rows hold -inf and row 0."""
    q = rng.randn(3, 8).astype(np.float32)
    c = rng.randn(300, 8).astype(np.float32)
    for k in (3, 320):  # 300 rows pad to 3 groups of 128: k >= groups
        j, t = run_both(q, c, k, 128, impl, select, "flag", valid_rows=290)
        assert_same(j, t)
        assert bool(t[2])
    assert np.isneginf(t[0][:, 290:]).all() and (t[1][:, 290:] == 0).all()


def adversarial_cluster(rng):
    """30 top rows over 15 groups of chunk 0, more than its capture budget of
    8 (tests/test_pallas_exact.py's TestOnMissFlag corpus, 8 chunks)."""
    c = (rng.randn(16384, 16) * 0.01).astype(np.float32)
    hot = np.arange(30) * 64
    c[hot] = (rng.randn(30, 16) + 5.0).astype(np.float32)
    return np.ones((3, 16), dtype=np.float32), c


@pytest.mark.parametrize("select", ["flat", "hier", "merge"])
def test_adversarial_cluster(rng, select):
    """flat and hier: the flag says False (a selected group was not
    captured), then the fallback is exact. merge: it falls back inside and
    reports True, as the reference does."""
    q, c = adversarial_cluster(rng)
    assert _capture_budget(30, 8, 16) == 8
    _, oidx = numpy_topk(q.astype(np.float64) @ c.T.astype(np.float64), 30)
    j, t = run_both(q, c, 30, 2048, "stream", select, "flag")
    assert bool(j[2]) == bool(t[2]) == (select == "merge")
    for on_miss in ("flag", "fallback") if select == "merge" else ("fallback",):
        j, t = run_both(q, c, 30, 2048, "stream", select, on_miss)
        np.testing.assert_array_equal(t[1], j[1])
        np.testing.assert_allclose(t[0], j[0], atol=ATOL, rtol=1e-6)  # scores near 90
        np.testing.assert_array_equal(t[1], oidx)


def test_stream_assert_capture_hook(rng, monkeypatch):
    """_STREAM_ASSERT_CAPTURE takes the capture path past a failed check:
    on the adversarial cluster the hot groups that chunk 0 did not capture
    are missing from the result, in both packages alike."""
    q, c = adversarial_cluster(rng)
    monkeypatch.setattr(ops_exact, "_STREAM_ASSERT_CAPTURE", True)
    monkeypatch.setattr(pe, "_STREAM_ASSERT_CAPTURE", True)
    try:
        jax.clear_caches()
        j, t = run_both(q, c, 30, 2048, "stream", "hier")
    finally:
        jax.clear_caches()
    np.testing.assert_array_equal(t[1], j[1])
    _, oidx = numpy_topk(q.astype(np.float64) @ c.T.astype(np.float64), 30)
    assert not np.array_equal(t[1], oidx)


@pytest.mark.parametrize("impl,select", [("single", "hier"), ("twopass", "flat"),
                                         ("stream", "merge"), ("auto", "flat")])
def test_query_block_tiling(rng, impl, select):
    """Q = 512: the non-stream impls and merge run 256 queries at a time
    (the reference's lax.map over QUERY_BLOCK), auto takes stream."""
    q = rng.randn(512, 16).astype(np.float32)
    c = rng.randn(4096, 16).astype(np.float32)
    c[100] = c[900] = q[5] * 3  # a tie for one query
    j, t = run_both(q, c, 5, 1024, impl, select, "flag", valid_rows=4000)
    assert_same(j, t)
    _, oidx = numpy_topk(q @ c[:4000].T, 5)
    np.testing.assert_array_equal(t[1], oidx)


def test_resolve_impl_is_the_references():
    for args in (("auto", 256, 10_000, 10_000 * 128), ("single", 256, 10_000, 10_000 * 128),
                 ("twopass", 256, 10_000, 10_000 * 128), ("auto", 1024, 10_000, 10_000 * 128),
                 ("auto", 512, 10, 10), ("auto", 513, 10, 10)):
        assert _resolve_impl(*args) == pe._resolve_impl(*args)
    assert _resolve_impl("auto", 256, 10_000, 10_000 * 128) == "stream"
    assert _resolve_impl("auto", 1024, 10_000, 10_000 * 128) == "twopass"
    assert _resolve_impl("auto", 256, 10_000, 10_000 * 128, chunk_size=32768) == "twopass"
    assert pe._resolve_impl("auto", 256, 10_000, 10_000 * 128, chunk_size=32768) == "twopass"
    with pytest.raises(ValueError):
        _resolve_impl("bogus", 256, 1000, 1000)
    q, c = torch.zeros(2, 8), torch.zeros(512, 8)
    with pytest.raises(ValueError, match="select"):
        exact_topk_mips(q, c, 4, select="heir")
    with pytest.raises(ValueError, match="impl"):
        exact_topk_mips(q, c, 4, impl="bogus")


# ------------------------------------------------ plain versions vs numpy


def test_score_gmax_plain_matches_numpy(rng):
    """K7a's plain version: raw scores in all three layouts; group maxima
    with rows past valid_rows as FIN_MIN, equal to K1's on the same rows."""
    q = rng.randint(-2, 3, (5, 24)).astype(np.float32)
    c = rng.randint(-2, 3, (3 * 1024, 24)).astype(np.float32)
    valid = 2900
    s = q @ c.T
    want_g = np.where(np.arange(3072) < valid, s, -1e30).reshape(5, 24, 128).max(-1)
    want_g = want_g.T.reshape(3, 8, 5)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    for store in ("chunk", "row", "none"):
        scores, gmax = score_gmax(tq, tc, valid, 1024, store)
        np.testing.assert_array_equal(gmax.numpy(), want_g)
        if store == "chunk":
            np.testing.assert_array_equal(scores.numpy(), s.reshape(5, 3, 1024).transpose(1, 0, 2))
        elif store == "row":
            np.testing.assert_array_equal(scores.numpy(), s)
        else:
            assert scores is None
    np.testing.assert_array_equal(gmax.numpy(), stream_capture(tq, tc, valid, 1024, 2)[0].numpy())
    with pytest.raises(ValueError, match="store"):
        score_gmax(tq, tc, valid, 1024, "strided")


def test_copy_kernels_plain_select_groups(rng):
    """K7b and K8's plain versions: the group a flat index picks, zeros
    outside the source."""
    src = torch.from_numpy(rng.randn(3, 2, 4 * 128).astype(np.float32))
    idx = torch.tensor([[0, 5, 11, 12], [7, -1, 3, 4]])
    for fn in (lambda: score_gather(src, idx), lambda: cap_assemble(idx, src, 4)):
        out = fn().numpy()
        for qi in range(2):
            for j, g in enumerate(idx[qi].tolist()):
                if 0 <= g < 12:
                    want = src[g // 4, qi, (g % 4) * 128:(g % 4 + 1) * 128].numpy()
                    np.testing.assert_array_equal(out[qi, j], want)
                else:
                    assert not out[qi, j].any()


def window_numpy(gids, capmax, resid, br):
    """Order-free statement of merge's window: after chunk c, the top br of
    every group captured so far under (key desc, gid asc); lost[c] = max(its
    residual, the best key that the top-br of (window + chunk c) leaves
    out)."""
    n_c, bc, n_q = capmax.shape
    windows, lost = [], np.zeros((n_c, n_q), np.float32)
    for qi in range(n_q):
        win = []
        for c in range(n_c):
            pool = win + [(float(capmax[c, j, qi]), int(gids[c, j, qi])) for j in range(bc)]
            pool.sort(key=lambda x: (-x[0], x[1]))
            win, out = pool[:br], pool[br:]
            lost[c, qi] = max([float(resid[c, 0, qi])] + [v for v, _ in out])
        windows.append(win)
    return windows, lost


@pytest.mark.parametrize("n_c,chunk,b,br", [(6, 1024, 3, 8), (5, 1024, 8, 8), (2, 1024, 4, 16),
                                            (1, 2048, 8, 16)])
def test_window_merge_plain_matches_order_free_statement(rng, n_c, chunk, b, br):
    """K9's plain version over K1's outputs (integer data, so keys tie):
    the window's groups, keys and payload; empty slots (fewer captured
    groups than br) after every group with gids >= total_groups, keys
    FIN_MIN and zero scores; lost per chunk."""
    q = rng.randint(-2, 3, (4, 16)).astype(np.float32)
    c = rng.randint(-2, 3, (n_c * chunk, 16)).astype(np.float32)
    outs = stream_capture(torch.from_numpy(q), torch.from_numpy(c), n_c * chunk - 50, chunk, b)
    gmax, capture, gids, capmax, resid = outs
    total = n_c * chunk // 128
    win, wkey, wgid, lost = window_merge(gids, capmax, resid, capture, br, total)
    windows, want_lost = window_numpy(gids.numpy(), capmax.numpy(), resid.numpy(), br)
    np.testing.assert_array_equal(lost.numpy()[:, 0], want_lost)
    cap = capture.numpy().reshape(n_c, 4, b, 128)
    g_all, k_all = gids.numpy(), capmax.numpy()
    for qi in range(4):
        want = sorted(windows[qi], key=lambda x: x[1])
        n_real = len(want)
        assert wgid[qi, :n_real].tolist() == [g for _, g in want]
        np.testing.assert_array_equal(wkey[qi, :n_real].numpy(), [max(v, -1e30) for v, _ in want])
        for r, (_, g) in enumerate(want):
            cc, j = np.nonzero(g_all[:, :, qi] == g)
            assert k_all[cc[0], j[0], qi] == wkey[qi, r]
            np.testing.assert_array_equal(win[qi, r].numpy(), cap[cc[0], qi, j[0]])
        empty = wgid[qi, n_real:].numpy()
        assert (empty >= total).all() and (np.diff(empty) > 0).all()
        assert (wkey[qi, n_real:] == -1e30).all() and not win[qi, n_real:].any()


def test_window_merge_exactness_rule_matches_jax_on_ties(rng):
    """An all-tie corpus: every group ties, so the strict rule kth > lost
    fails and merge falls back (reported True in flag mode), in both
    packages."""
    q = np.ones((2, 8), np.float32)
    c = np.ones((8192, 8), np.float32)
    for on_miss in ("flag", "fallback"):
        j, t = run_both(q, c, 10, 2048, "stream", "merge", on_miss)
        assert_same(j, t, exact=True)
    np.testing.assert_array_equal(t[1], np.tile(np.arange(10), (2, 1)))


# -------------------------------------------- topk_mips_onepass, topk_lastdim


def test_topk_mips_onepass_matches_jax(rng):
    q = rng.randint(-2, 3, (6, 16)).astype(np.float32)
    c = rng.randint(-2, 3, (3000, 16)).astype(np.float32)
    for valid, k in ((None, 25), (2500, 25), (None, 3000), (2990, 3010)):
        jv, ji = jax_mips.topk_mips_onepass(jnp.asarray(q), jnp.asarray(c), k, valid_rows=valid)
        tv, ti = topk_mips_onepass(torch.from_numpy(q), torch.from_numpy(c), k, valid_rows=valid)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _, oidx = numpy_topk(q @ c[:2500].T, 25)
    tv, ti = topk_mips_onepass(torch.from_numpy(q), torch.from_numpy(c), 25, valid_rows=2500)
    np.testing.assert_array_equal(ti.numpy(), oidx)


def test_topk_lastdim_matches_jax(rng):
    x = rng.randint(-3, 4, (4, 500)).astype(np.float32)
    x[:, 450:] = -np.inf
    for k in (1, 17, 500, 600):
        jv, ji = pe.topk_lastdim(jnp.asarray(x), k)
        tv, ti = topk_lastdim(torch.from_numpy(x), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# -------------------------------------------------------------- the indexer


@pytest.mark.parametrize("select", ["hier", "flat", "merge"])
def test_indexer_selects_as_the_reference(rng, select):
    """TorchIndexer(pallas_select=s) against TPUIndexer(pallas_select=s,
    exact_impl="pallas") on the same rows: the same ids and scores, a
    padded batch included."""
    rows = rng.randn(4096, 32).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    queries = rows[[5, 2000, 4000]] + 0.01 * rng.randn(3, 32).astype(np.float32)
    ref = TPUIndexer(32, exact_impl="pallas", pallas_chunk_size=1024, pallas_select=select)
    port = TorchIndexer(32, device="cpu", exact_impl="kernel", pallas_chunk_size=1024,
                        pallas_select=select)
    for index in (ref, port):
        index.index_data(list(range(4096)), rows)
    for (w_ids, w_scores), (g_ids, g_scores) in zip(ref.search_knn(queries, 10),
                                                    port.search_knn(queries, 10)):
        assert g_ids == w_ids
        np.testing.assert_allclose(g_scores, w_scores, atol=ATOL, rtol=1e-6)
    assert [ids[0] for ids, _ in port.search_knn(queries, 10)] == ["5", "2000", "4000"]

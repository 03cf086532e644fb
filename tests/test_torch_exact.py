"""The port's exact search held against the JAX package.

``kirag_tpu_torch.ops.exact.exact_topk_mips`` (on the CPU: the plain
versions of the stream-capture and gather kernels) against
``kirag_tpu.ops.pallas_exact.exact_topk_mips(impl="stream",
select="capdom")`` in Pallas interpret mode, on the same numpy inputs.
Shapes stay below every chunk clamp of the reference, so both sides run the
same chunk geometry and capture budget. Tolerances: 1e-5 on values of f32
sums over <= 32 terms taken in different orders (plus 1e-6 relative where
the scores reach 90); integer-valued inputs are exact on both sides and
compare bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kirag_tpu.ops.pallas_exact import exact_topk_mips as jax_exact
from kirag_tpu.ops.pallas_exact import hier_topk as jax_hier_topk
from kirag_tpu_torch.kernels import gather_groups, stream_capture
from kirag_tpu_torch.ops.exact import _capture_budget, exact_topk_mips, hier_topk
from kirag_tpu_torch.ops.mips import topk_mips

ATOL = 1e-5


def numpy_topk(scores, k):
    """FAISS order: descending value, ties to the lower row id."""
    order = np.lexsort((np.broadcast_to(np.arange(scores.shape[1]), scores.shape),
                        -scores), axis=1)[:, :k]
    return np.take_along_axis(scores, order, axis=1), order


def run_both(q, c, k, chunk, on_miss, valid_rows=None):
    j = jax_exact(jnp.asarray(q), jnp.asarray(c), k, chunk_size=chunk,
                  valid_rows=valid_rows, interpret=True, impl="stream",
                  select="capdom", on_miss=on_miss)
    t = exact_topk_mips(torch.from_numpy(q), torch.from_numpy(c), k, chunk_size=chunk,
                        valid_rows=valid_rows, select="capdom", impl="stream",
                        on_miss=on_miss)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("on_miss", ["flag", "fallback"])
def test_random_matches_jax(rng, on_miss):
    q = rng.randn(8, 32).astype(np.float32)
    c = rng.randn(16384, 32).astype(np.float32)
    j, t = run_both(q, c, 10, 2048, on_miss)
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_allclose(t[0], j[0], atol=ATOL, rtol=0)
    if on_miss == "flag":
        assert bool(t[2]) and bool(j[2])
    _, oidx = numpy_topk(q.astype(np.float64) @ c.T.astype(np.float64), 10)
    np.testing.assert_array_equal(t[1], oidx)


def test_integer_ties_lower_row_wins(rng):
    # few distinct scores: every selection boundary is a tie
    q = rng.randint(-1, 2, (4, 16)).astype(np.float32)
    c = rng.randint(-1, 2, (8192, 16)).astype(np.float32)
    j, t = run_both(q, c, 20, 1024, "fallback")
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    ovals, oidx = numpy_topk(q @ c.T, 20)
    np.testing.assert_array_equal(t[1], oidx)
    np.testing.assert_array_equal(t[0], ovals)


def test_valid_rows_poisoned_tail(rng):
    q = rng.randn(4, 32).astype(np.float32)
    c = rng.randn(8192, 32).astype(np.float32)
    valid = 7000
    c[valid:] = 1e4  # rows past valid_rows would win every query
    for on_miss in ("flag", "fallback"):
        j, t = run_both(q, c, 12, 2048, on_miss, valid_rows=valid)
        assert t[1].max() < valid
        np.testing.assert_array_equal(t[1], j[1])
        np.testing.assert_allclose(t[0], j[0], atol=ATOL, rtol=0)
        _, oidx = numpy_topk(q @ c[:valid].T, 12)
        np.testing.assert_array_equal(t[1], oidx)


def test_k_exceeds_rows(rng):
    q = rng.randn(3, 8).astype(np.float32)
    c = rng.randn(100, 8).astype(np.float32)
    j, t = run_both(q, c, 130, 128, "flag")
    assert t[0].shape == (3, 130) and t[1].shape == (3, 130)
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_allclose(t[0], j[0], atol=ATOL, rtol=0)
    assert np.isneginf(t[0][:, 100:]).all() and (t[1][:, 100:] == 0).all()
    assert bool(t[2])


def test_tiny_corpus_path(rng):
    # one 128-row group: the dense path, with a masked tail reporting row 0
    q = rng.randn(2, 8).astype(np.float32)
    c = rng.randn(96, 8).astype(np.float32)
    j, t = run_both(q, c, 90, 128, "fallback", valid_rows=80)
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_allclose(t[0], j[0], atol=ATOL, rtol=0)
    assert np.isneginf(t[0][:, 80:]).all() and (t[1][:, 80:] == 0).all()


def adversarial_cluster(rng):
    """Top-k rows spread over more groups of chunk 0 than the capture budget
    (tests/test_pallas_exact.py's TestOnMissFlag corpus)."""
    c = (rng.randn(65536, 16) * 0.01).astype(np.float32)
    hot = np.arange(30) * 64  # 30 hot rows over 15 groups of chunk 0
    c[hot] = (rng.randn(30, 16) + 5.0).astype(np.float32)
    return np.ones((3, 16), dtype=np.float32), c


def test_adversarial_cluster_flags_miss_and_falls_back(rng):
    q, c = adversarial_cluster(rng)
    assert _capture_budget(30, 32, 16) == 8  # < 15 hot groups
    j, t = run_both(q, c, 30, 2048, "flag")
    assert not bool(j[2]) and not bool(t[2])
    j, t = run_both(q, c, 30, 2048, "fallback")
    np.testing.assert_array_equal(t[1], j[1])
    # scores near 90 here: 1e-6 relative is about 8 f32 ulps
    np.testing.assert_allclose(t[0], j[0], atol=ATOL, rtol=1e-6)
    _, oidx = numpy_topk(q.astype(np.float64) @ c.T.astype(np.float64), 30)
    np.testing.assert_array_equal(t[1], oidx)


def test_zero_padded_rows_fail_the_flag(rng):
    # the reference's padded serving batch: one real query, seven zero rows.
    # A zero row ties its residual, so the flag is False for the whole batch.
    q = np.zeros((8, 32), dtype=np.float32)
    q[0] = rng.randn(32)
    c = rng.randn(16384, 32).astype(np.float32)
    j, t = run_both(q, c, 10, 2048, "flag")
    assert not bool(j[2]) and not bool(t[2])
    j, t = run_both(q, c, 10, 2048, "fallback")
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_allclose(t[0], j[0], atol=ATOL, rtol=0)
    q8 = rng.randn(8, 32).astype(np.float32)
    _, t = run_both(q8, c, 10, 2048, "flag")
    assert bool(t[2])


def stream_kernel_numpy(q, c, valid_rows, chunk, b):
    """A restatement of pallas_exact._stream_kernel (capdom outputs) in numpy,
    with its masked-max peel loop."""
    n_chunks, g_count = c.shape[0] // chunk, chunk // 128
    n_q = q.shape[0]
    gmax = np.zeros((n_chunks, g_count, n_q), np.float32)
    cap = np.zeros((n_chunks, n_q, b * 128), np.float32)
    gids = np.zeros((n_chunks, b, n_q), np.int32)
    capmax = np.zeros((n_chunks, b, n_q), np.float32)
    resid = np.zeros((n_chunks, 1, n_q), np.float32)
    for ci in range(n_chunks):
        s = q @ c[ci * chunk:(ci + 1) * chunk].T
        rows = ci * chunk + np.arange(chunk)
        gm = np.maximum(np.where(rows < valid_rows, s, -1e30)
                        .reshape(n_q, g_count, 128).max(-1), -1e30)
        gmax[ci] = gm.T
        for qi in range(n_q):
            x = gm[qi].copy()
            for j in range(b):
                m = x.max()
                sel = int(np.min(np.nonzero(x == m)[0]))
                gids[ci, j, qi] = ci * g_count + sel
                capmax[ci, j, qi] = m
                cap[ci, qi, j * 128:(j + 1) * 128] = s[qi, sel * 128:(sel + 1) * 128]
                x[sel] = -np.inf
            resid[ci, 0, qi] = x.max()
    return gmax, cap, gids, capmax, resid


@pytest.mark.parametrize("b", [3, 16])  # partial capture; b == G leaves -inf
def test_stream_capture_plain_matches_restatement(rng, b):
    q = rng.randint(-2, 3, (5, 24)).astype(np.float32)
    c = rng.randint(-2, 3, (6144, 24)).astype(np.float32)
    want = stream_kernel_numpy(q, c, 5000, 2048, b)
    got = stream_capture(torch.from_numpy(q), torch.from_numpy(c), 5000, 2048, b)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    if b == 16:
        assert np.isneginf(want[4]).all()


def test_gather_groups_plain_matches_row_scores(rng):
    q = rng.randn(3, 16).astype(np.float32)
    c = rng.randn(2048, 16).astype(np.float32)
    gsel = np.array([[0, 5, 15], [2, 3, 9], [1, 7, 99]], dtype=np.int32)
    cand = gather_groups(torch.from_numpy(q), torch.from_numpy(c),
                         torch.from_numpy(gsel)).numpy()
    assert cand.shape == (3, 3, 128)
    for qi in range(3):
        for j, g in enumerate(gsel[qi]):
            if g < 16:
                want = c[g * 128:(g + 1) * 128] @ q[qi]
                np.testing.assert_allclose(cand[qi, j], want, atol=ATOL, rtol=0)
    assert (cand[2, 2] == 0).all()  # group 99 lies outside the corpus


def test_hier_topk_matches_jax(rng):
    x = rng.randint(-3, 4, (4, 1000)).astype(np.float32)
    x[:, 900:] = -np.inf
    for k, block in ((10, 16), (40, 32), (3, 500)):
        jv, ji = jax_hier_topk(jnp.asarray(x), k, block=block)
        tv, ti = hier_topk(torch.from_numpy(x), k, block=block)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_topk_mips_matches_jax_and_oracle(rng):
    from kirag_tpu.ops.mips import topk_mips as jax_topk_mips

    q = rng.randint(-2, 3, (6, 16)).astype(np.float32)
    c = rng.randint(-2, 3, (3000, 16)).astype(np.float32)
    for valid in (None, 2500):
        jv, ji = jax_topk_mips(jnp.asarray(q), jnp.asarray(c), 25, chunk_size=512,
                               valid_rows=valid)
        tv, ti = topk_mips(torch.from_numpy(q), torch.from_numpy(c), 25, chunk_size=512,
                           valid_rows=valid)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        _, oidx = numpy_topk(q @ c[:valid].T, 25)
        np.testing.assert_array_equal(ti.numpy(), oidx)


def test_unported_variants_raise(rng):
    # every impl and select of the reference is ported; unknown ones raise
    # the reference's ValueError
    q = torch.zeros(2, 8)
    c = torch.zeros(512, 8)
    with pytest.raises(ValueError, match="impl"):
        exact_topk_mips(q, c, 4, impl="bogus")
    with pytest.raises(ValueError, match="select"):
        exact_topk_mips(q, c, 4, select="heir")
    for impl, select in (("single", "hier"), ("twopass", "flat"), ("stream", "merge")):
        vals, idx = exact_topk_mips(q, c, 4, impl=impl, select=select)
        assert not vals.any() and idx.tolist() == [[0, 1, 2, 3]] * 2
    with pytest.raises(ValueError):
        exact_topk_mips(q, c, 4, on_miss="ignore")
    codes = torch.zeros(512, 4, dtype=torch.uint8)
    # pq4 is ported; its level table is checked against the codes
    vals, idx = exact_topk_mips(q, codes, 4, scales=torch.zeros(16, 8), quant="pq4")
    assert not vals.any() and idx.tolist() == [[0, 1, 2, 3]] * 2  # ties: lower rows
    with pytest.raises(ValueError, match="level table"):
        exact_topk_mips(q, codes, 4, scales=torch.zeros(16, 6), quant="pq4")

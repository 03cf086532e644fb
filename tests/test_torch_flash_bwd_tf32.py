"""K3's f32 backward kernels on the card take every product in split f32
("3xTF32") on the tensor cores, through ``mma.sync`` m16n8k8 fragments with
a permuted reduction index (``csrc/flash_attention_bwd.cu``). This sandbox
has no card, so both halves of that design are modelled here in numpy:

- the arithmetic: each operand split into two TF32 values as
  ``cvt.rna.tf32.f32`` rounds (10 explicit mantissa bits, nearest, ties away
  from zero), each product as lo.hi + hi.lo + hi.hi in f32. On seeded
  [1, 2, T, 64] inputs dq, dk and dv land within 2e-6 of float64's (as a
  share of each tensor's largest magnitude), five times under the card's
  1e-5 check, which one TF32 pass misses (the model rounds its f32 sums to
  nearest; mma.sync truncates its own, which the kernels bound by adding
  each streamed unit's partial sums with rounded adds);
- the index maps: the kernels' ``scores``, ``update`` and ``store_rows``
  written out per lane over the PTX fragment layout of m16n8k8 TF32, whose
  products on integer matrices equal numpy's bitwise.
"""

import numpy as np
import pytest

SCALE = 0.125
CARD_TOL = 1e-5   # the card's check of the f32 kernels against the plain version
MODEL_TOL = 2e-6  # five times under it


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32``: 10 explicit mantissa
    bits, to nearest, ties away from zero (the sign is apart from the
    magnitude bits, so adding half the dropped range rounds the magnitude)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b in f32 from TF32 parts: lo.hi + hi.lo first, then hi.hi."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def one_pass_product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return tf32_rna(a) @ tf32_rna(b)


def f64_product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a.astype(np.float64) @ b.astype(np.float64)


def backward(q, k, v, do, seg, lse, di, product, dtype):
    """dq, dk, dv of one head by the kernels' formulas, every product by
    ``product`` and the elementwise steps in ``dtype``."""
    same = seg[:, None] == seg[None, :]
    s = product(q, k.T)
    p = np.where(same, np.exp(s.astype(dtype) * dtype(SCALE) - lse[:, None]), 0).astype(dtype)
    dp = product(do, v.T).astype(dtype)
    ds = (p * (dp - di[:, None]) * dtype(SCALE)).astype(dtype)
    return product(ds, k), product(ds.T, q), product(p.T, do)


def residuals(q, k, v, do, seg):
    """The forward's lse and di = rowsum(out * dO), f32 as the kernels read
    them (computed in float64)."""
    q64, k64, v64 = (x.astype(np.float64) for x in (q, k, v))
    logits = np.where(seg[:, None] == seg[None, :], q64 @ k64.T * SCALE, -np.inf)
    m = logits.max(-1, keepdims=True)
    e = np.exp(logits - m)
    lse = (m[:, 0] + np.log(e.sum(-1))).astype(np.float32)
    out = (e / e.sum(-1, keepdims=True)) @ v64
    return lse, np.sum(out * do.astype(np.float64), -1).astype(np.float32)


@pytest.mark.parametrize("t", [128, 256])
def test_split_tf32_backward_is_f32_grade_and_one_pass_is_not(t):
    """Split TF32 within MODEL_TOL of float64 in every head and tensor; one
    TF32 pass beyond CARD_TOL in every tensor (so the card's check tells
    the two apart)."""
    rng = np.random.RandomState(t)
    q, k, v, do = (rng.randn(1, 2, t, 64).astype(np.float32) for _ in range(4))
    seg = np.ones(t, dtype=np.int32)
    seg[t - 37:] = 0                     # right padding inside a tile
    seg[: t // 2] = 2                    # two documents
    one_pass = np.zeros(3)
    for h in range(2):
        args = (q[0, h], k[0, h], v[0, h], do[0, h], seg)
        lse, di = residuals(*args)
        want = backward(*args, lse.astype(np.float64), di.astype(np.float64), f64_product,
                        np.float64)
        split = backward(*args, lse, di, split_product, np.float32)
        rough = backward(*args, lse, di, one_pass_product, np.float32)
        for i, (x, y, w) in enumerate(zip(split, rough, want)):
            top = np.abs(w).max()
            assert x.dtype == np.float32 and np.abs(x - w).max() <= MODEL_TOL * top, i
            one_pass[i] = max(one_pass[i], np.abs(y - w).max() / top)
    assert (one_pass > CARD_TOL).all(), one_pass


def test_tf32_rounding_is_cvt_rna():
    """Nearest with ties away from zero at the 13 dropped bits, the sign
    kept; hi + lo recovers x to 2^-22 of it."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's spacing at 1
    x = np.array([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2), 1 + 1.5 * ulp,
                  3.0, 0.0], dtype=np.float32)
    np.testing.assert_array_equal(
        tf32_rna(x), np.array([one + ulp, one, -(one + ulp), 1 + 2 * ulp, 3.0, 0.0],
                              dtype=np.float32))
    r = np.random.RandomState(0).randn(10000).astype(np.float32)
    hi = tf32_rna(r)
    lo = tf32_rna(r - hi)
    for part in (hi, lo):
        assert ((part.view(np.uint32) & 0x1FFF) == 0).all()
    assert (np.abs((hi.astype(np.float64) + lo) - r) <= 2.0 ** -22 * np.abs(r)).all()


# ------------------------------------------------------- the fragment model

LANES = [(lane // 4, lane % 4) for lane in range(32)]  # (g, t)
HD = 64


def a_places(g, t):  # m16n8k8 TF32 A (16 x 8, row): a0 .. a3
    return [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]


def b_places(g, t):  # B (8 x 8, col): b0, b1
    return [(t, g), (t + 4, g)]


def c_places(g, t):  # C, D (16 x 8): c0 .. c3
    return [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]


def gather(frags, places, shape):
    """A warp's fragments (per lane) as the matrix they hold; every element
    held exactly once."""
    m = np.zeros(shape, dtype=np.int64)
    seen = np.zeros(shape, dtype=np.int64)
    for (g, t), frag in zip(LANES, frags):
        for (r, c), x in zip(places(g, t), frag):
            m[r, c] = x
            seen[r, c] += 1
    assert (seen == 1).all()
    return m


def mma(c, a, b):
    """One mma.sync m16n8k8 over per-lane fragments: c + a b."""
    d = gather(c, c_places, (16, 8)) + gather(a, a_places, (16, 8)) @ gather(b, b_places, (8, 8))
    return [[d[r, col] for r, col in c_places(g, t)] for g, t in LANES]


def zeros(n_tiles):
    return [[[0] * 4 for _ in range(32)] for _ in range(n_tiles)]


def add_part(acc, part):
    return [[x + y for x, y in zip(u, v)] for u, v in zip(acc, part)]


def scores(acc, a_rows, b_rows):
    """The kernel's scores<NT>: acc[n] += A B_n^T, A the 16 resident rows,
    B_n rows 8n .. 8n + 7, k-steps of 8 columns."""
    for s in range(HD // 8):
        a = [[a_rows[g, 8 * s + t], a_rows[g + 8, 8 * s + t], a_rows[g, 8 * s + t + 4],
              a_rows[g + 8, 8 * s + t + 4]] for g, t in LANES]
        for n in range(len(acc)):
            b = [[b_rows[8 * n + g, 8 * s + t], b_rows[8 * n + g, 8 * s + t + 4]]
                 for g, t in LANES]
            acc[n] = mma(acc[n], a, b)


def update(acc, p, b_rows):
    """The kernel's update<NT>: acc += P B, P's accumulator columns 2t,
    2t + 1 as A's columns t, t + 4, B's rows 8kk + 2t and 8kk + 2t + 1 as
    its rows t, t + 4, n-tile 2m + e's column j as column 16m + 2j + e; the
    unit's sum in fresh parts, four n-tiles at a time, added to acc."""
    for h in range(2):
        part = zeros(4)
        for kk in range(len(p)):
            a = [[p[kk][lane][0], p[kk][lane][2], p[kk][lane][1], p[kk][lane][3]]
                 for lane in range(32)]
            for m in range(2):
                col = 32 * h + 16 * m
                b = [[], []]
                for g, t in LANES:
                    x = b_rows[8 * kk + 2 * t, col + 2 * g: col + 2 * g + 2]
                    y = b_rows[8 * kk + 2 * t + 1, col + 2 * g: col + 2 * g + 2]
                    b[0].append([x[0], y[0]])
                    b[1].append([x[1], y[1]])
                part[2 * m] = mma(part[2 * m], a, b[0])
                part[2 * m + 1] = mma(part[2 * m + 1], a, b[1])
        for j in range(4):
            acc[4 * h + j] = add_part(acc[4 * h + j], part[j])


def store_rows(acc):
    """The kernel's store_rows: the warp's [16 x 64] output, row g's float4
    at columns 16m + 4t (and row g + 8's)."""
    out = np.full((16, HD), -1, dtype=np.int64)
    for lane, (g, t) in enumerate(LANES):
        for m in range(HD // 16):
            e, o = acc[2 * m][lane], acc[2 * m + 1][lane]
            out[g, 16 * m + 4 * t: 16 * m + 4 * t + 4] = [e[0], o[0], e[1], o[1]]
            out[g + 8, 16 * m + 4 * t: 16 * m + 4 * t + 4] = [e[2], o[2], e[3], o[3]]
    return out


def accumulator_matrix(acc):
    """[16 x 8 NT] held by NT accumulator tiles (column j of tile n is
    column 8n + j)."""
    return np.concatenate([gather(c, c_places, (16, 8)) for c in acc], axis=1)


@pytest.mark.parametrize("chunk", [32, 64])
def test_fragment_maps_give_the_products_bitwise(chunk):
    """On integer matrices, through the per-lane model: S^T = K Q^T and
    dP^T = V dO^T (dQ: S = Q K^T) over a 64-row tile in passes of
    ``chunk`` rows; P^T dO, dS^T Q (dK/dV) and dS K (dQ) with P^T, dS^T, dS
    the first products' accumulators as they stand; each bitwise numpy's."""
    rng = np.random.RandomState(chunk)
    ints = lambda *shape: rng.randint(-8, 9, shape).astype(np.int64)  # noqa: E731
    own, own2 = ints(16, HD), ints(16, HD)          # a warp's K and V rows (dQ: Q, dO)
    tile, tile2 = ints(64, HD), ints(64, HD)        # a streamed tile's Q and dO (dQ: K, V)
    nt = chunk // 8
    out, out2 = zeros(8), zeros(8)
    for c in range(0, 64, chunk):
        s, dp = zeros(nt), zeros(nt)
        scores(s, own, tile[c:c + chunk])
        scores(dp, own2, tile2[c:c + chunk])
        np.testing.assert_array_equal(accumulator_matrix(s), own @ tile[c:c + chunk].T)
        np.testing.assert_array_equal(accumulator_matrix(dp), own2 @ tile2[c:c + chunk].T)
        update(out, s, tile2[c:c + chunk])   # as dV += P^T dO
        update(out2, dp, tile[c:c + chunk])  # as dK += dS^T Q, and dQ += dS K
    np.testing.assert_array_equal(store_rows(out), (own @ tile.T) @ tile2)
    np.testing.assert_array_equal(store_rows(out2), (own2 @ tile2.T) @ tile)

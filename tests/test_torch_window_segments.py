"""K9's segmented design (csrc/window_merge.cu) on the CPU.

The kernel runs the reference's chunk-by-chunk merge as segments whose
windows compose: each segment's top br, the window at each segment's start
composed from them by a scan, and each segment replayed from it, with a
step flagged where the peel's slot order may decide a tie (the flagged
query then runs the reference's steps). ``segmented`` below restates that
design in numpy, step for step (sorted lists, the fast step, the
binary-searched places and the items that move, the scan's rounds, the
flag), and the tests hold it against ``window_merge_plain`` (the
reference's steps in torch) bitwise in ``win``, ``wkey``, ``wgid`` and
``lost``: on integer data with ties, with fewer captured groups than the
window (empty slots), with -inf keys, at the 21M geometry's bc = 8, br =
104 over a small C, at every segment count, and on hypothesis's tie-heavy
keys. A hand-made case shows that the flag is needed. Then
``merge_segments`` (the kernel's segment count) and the port's
``select="merge"`` search against the JAX package's on integer data.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kirag_tpu.ops import pallas_exact as pe
from kirag_tpu_torch.kernels import stream_capture, window_merge, window_merge_plain
from kirag_tpu_torch.kernels.exact import (
    MAX_MERGE_SMEM,
    MERGE_LANE_BC,
    MERGE_MAX_SEGMENTS,
    merge_segments,
    merge_smem_bytes,
)
from kirag_tpu_torch.ops.exact import _capture_budget, _merge_geometry, exact_topk_mips

INF = float("inf")
NONE = (-INF, 2 ** 31 - 1, -1)  # phase A's filler: below every item
FIN_MIN = np.float32(-1e30)


def key(item):
    """The order >-: key descending, gid ascending (a total order: gids
    are distinct)."""
    return (-item[0], item[1])


def beats(a, b):
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def merge_step(cur, new, br, bc):
    """One chunk over the sorted list ``cur`` as the kernel's merge_step:
    (next list, the key of the best item left out, flag)."""
    worst = cur[-1]
    winners = [n for n in new if beats(n, worst)]
    if not winners:
        return cur, max(n[0] for n in new), False
    kstar = cur[br - bc][0]
    tied = br > bc and cur[br - bc - 1][0] == kstar and (kstar != -INF or worst[1] >= 0)
    winners.sort(key=key)
    # the kernel's places: a winner after the winners and the list items
    # that beat it (a binary search); the items from the best winner's place
    # down move by the winners placed at or above them
    beaten = [sum(beats(w, n) for w in cur) for n in winners]
    places = {b + r: n for r, (b, n) in enumerate(zip(beaten, winners))}
    pushed_tie = False
    for i, w in enumerate(cur):
        to = i + sum(b <= i for b in beaten)
        assert to == i or i >= beaten[0]
        places[to] = w
        if to >= br and w[0] == kstar:
            pushed_tie = True
    merged = [places[i] for i in range(br + len(winners))]
    assert merged == sorted(cur + winners, key=key)
    return merged[:br], merged[br][0], tied and pushed_tie


def chunk_items(gids, capmax, c, qi):
    bc = capmax.shape[1]
    return [(float(capmax[c, j, qi]), int(gids[c, j, qi]), c * bc + j) for j in range(bc)]


def segmented(gids, capmax, resid, br, segments):
    """The kernel's segmented form for each query: (final sorted list,
    lost [C], flagged)."""
    n_c, bc, n_q = capmax.shape
    out = []
    for qi in range(n_q):
        bounds = [(1 + s * (n_c - 1) // segments, 1 + (s + 1) * (n_c - 1) // segments)
                  for s in range(segments)]
        first = sorted(chunk_items(gids, capmax, 0, qi)
                       + [(-INF, -(s + 1), -1) for s in range(bc, br)], key=key)
        ends = []
        for s, (lo, hi) in enumerate(bounds):  # A: warp 0 from chunk 0's window, the others
            cur = first if s == 0 else [NONE] * br  # from a list of NONE
            for c in range(lo, hi):
                cur, _, _ = merge_step(cur, chunk_items(gids, capmax, c, qi), br, bc)
            ends.append(cur)
        span = 1  # B: the inclusive scan, a merge with the list span warps before
        while span < segments:
            ends = [sorted(ends[s - span] + ends[s], key=key)[:br] if s >= span else ends[s]
                    for s in range(segments)]
            span *= 2
        start = [first] + ends[:-1]
        lost = np.zeros(n_c, np.float32)
        lost[0] = resid[0, 0, qi]
        flagged = False
        for s, (lo, hi) in enumerate(bounds):  # C: the replay
            cur = start[s]
            for c in range(lo, hi):
                cur, best_out, flag = merge_step(cur, chunk_items(gids, capmax, c, qi), br, bc)
                lost[c] = max(np.float32(resid[c, 0, qi]), np.float32(best_out))
                flagged |= flag
        out.append((cur, lost, flagged))
    return out


def finish(lst, capture, total, bc):
    """The kernel's last stage: the list sorted by gid (empty slot s:
    total + s), keys clamped to FIN_MIN, the payload copied by position."""
    n_c, n_q = capture.shape[:2]
    cap = capture.reshape(n_c, n_q, bc, 128)
    rows = sorted((g if g >= 0 else total - g - 1, max(np.float32(k), FIN_MIN), p)
                  for k, g, p in lst)
    return rows, cap


def assert_query_matches_plain(model, plain, capture, total, bc, qi):
    lst, lost, _ = model
    win, wkey, wgid, plain_lost = plain
    rows, cap = finish(lst, capture, total, bc)
    np.testing.assert_array_equal(lost, plain_lost[:, 0, qi])
    assert [g for g, _, _ in rows] == wgid[qi].tolist()
    np.testing.assert_array_equal([k for _, k, _ in rows], wkey[qi])
    for r, (_, _, p) in enumerate(rows):
        want = cap[p // bc, qi, p % bc] if p >= 0 else np.zeros(128, np.float32)
        np.testing.assert_array_equal(win[qi, r], want)


def check_segmented(gids, capmax, resid, capture, br, total, segments):
    """Every unflagged query bitwise the plain version; returns the flags."""
    bc = capmax.shape[1]
    plain = [x.numpy() for x in window_merge_plain(
        torch.from_numpy(gids), torch.from_numpy(capmax), torch.from_numpy(resid),
        torch.from_numpy(capture), br, total)]
    model = segmented(gids, capmax, resid, br, segments)
    for qi, m in enumerate(model):
        if not m[2]:
            assert_query_matches_plain(m, plain, capture, total, bc, qi)
    return [m[2] for m in model]


def k1_outputs(rng, n_q, n_c, chunk, d, b, lo=-2, hi=3):
    """K1's plain outputs over integer rows (many tied keys)."""
    q = rng.randint(lo, hi, (n_q, d)).astype(np.float32)
    c = rng.randint(lo, hi, (n_c * chunk, d)).astype(np.float32)
    _, capture, gids, capmax, resid = stream_capture(
        torch.from_numpy(q), torch.from_numpy(c), n_c * chunk - 50, chunk, b)
    return gids.numpy(), capmax.numpy(), resid.numpy(), capture.numpy()


def synthetic(rng, n_q, n_c, bc, groups, values):
    """K1-shaped outputs drawn directly: each chunk's bc groups (distinct, in
    the chunk's gid range) with keys from ``values`` in descending order (the
    peel's), a residual at or below the chunk's last key, random payload."""
    gids = np.zeros((n_c, bc, n_q), np.int32)
    capmax = np.zeros((n_c, bc, n_q), np.float32)
    resid = np.zeros((n_c, 1, n_q), np.float32)
    for c in range(n_c):
        for qi in range(n_q):
            gids[c, :, qi] = c * groups + rng.choice(groups, bc, replace=False)
            keys = np.sort(rng.choice(values, bc))[::-1]
            capmax[c, :, qi] = keys
            resid[c, 0, qi] = keys[-1] - rng.randint(0, 2)
    capture = rng.randn(n_c, n_q, bc * 128).astype(np.float32)
    return gids, capmax, resid, capture


@pytest.mark.parametrize("segments", [1, 2, 3, 5, 7])
def test_segments_compose_to_the_plain_window_on_tied_integer_data(rng, segments):
    """K1's outputs over integer rows (keys tie often), bc = 3, br = 8:
    every unflagged query bitwise plain at every segment count, segment
    counts that do not divide C - 1 included."""
    gids, capmax, resid, capture = k1_outputs(rng, 6, 8, 1024, 16, 3)
    check_segmented(gids, capmax, resid, capture, 8, 64, segments)


@pytest.mark.parametrize("segments", [1, 4, 6, 13])
def test_segments_at_the_21m_geometry(rng, segments):
    """bc = 8, br = 104 (the DPR corpus's geometry) over C = 40 chunks of
    random keys: the first 13 chunks fill the window's empty slots; every
    query unflagged (no ties) and bitwise plain."""
    gids, capmax, resid, capture = synthetic(rng, 3, 40, 8, 128, rng.randn(4000))
    flags = check_segmented(gids, capmax, resid, capture, 104, 40 * 128, segments)
    assert not any(flags)


@pytest.mark.parametrize("segments", [1, 2, 3])
def test_segments_with_empty_slots_left(rng, segments):
    """C * bc < br: empty slots stay to the end, their gids total + slot in
    slot order after every group, keys FIN_MIN, zero payload."""
    gids, capmax, resid, capture = synthetic(rng, 4, 4, 8, 32, np.arange(-3, 4))
    flags = check_segmented(gids, capmax, resid, capture, 104, 4 * 32, segments)
    assert not any(flags)


@pytest.mark.parametrize("segments", [1, 2, 4])
def test_segments_with_minus_inf_keys(rng, segments):
    """Captured groups with key -inf (a chunk of masked rows): empty slots
    outrank them, and where the peel's slot order could pick between the
    two the step is flagged; the unflagged queries are bitwise plain."""
    values = np.array([-INF, -INF, -INF, 0.0, 1.0, 2.0], np.float32)
    gids, capmax, resid, capture = synthetic(rng, 8, 9, 4, 16, values)
    check_segmented(gids, capmax, resid, capture, 12, 9 * 16, segments)


def test_all_tied_keys_need_no_flag(rng):
    """Every key equal: the new groups lose every tie (their gids are
    larger), so no step pushes a tied group out and nothing is flagged."""
    gids, capmax, resid, capture = synthetic(rng, 3, 30, 8, 64, np.array([1.0]))
    flags = check_segmented(gids, capmax, resid, capture, 104, 30 * 64, 5)
    assert not any(flags)


def test_the_flag_marks_where_the_slot_order_decides():
    """br = 2, bc = 1. Chunk 0 captures (5, gid 3) into slot 0; chunk 1's
    (5, gid 10) takes the empty slot 1; chunk 2's (6, gid 20) enters, and the
    reference's peel takes slot 0 (the lower slot among the tied keys), so
    it keeps gid 10 where the top 2 under >- keeps gid 3. The replay flags
    that step, and the query then takes the reference's steps."""
    gids = np.array([3, 10, 20], np.int32).reshape(3, 1, 1)
    capmax = np.array([5.0, 5.0, 6.0], np.float32).reshape(3, 1, 1)
    resid = np.full((3, 1, 1), -INF, np.float32)
    capture = np.arange(3 * 128, dtype=np.float32).reshape(3, 1, 128)
    plain = window_merge_plain(torch.from_numpy(gids), torch.from_numpy(capmax),
                               torch.from_numpy(resid), torch.from_numpy(capture), 2, 64)
    assert plain[2][0].tolist() == [10, 20]
    (lst, lost, flagged), = segmented(gids, capmax, resid, 2, 2)
    assert flagged
    assert sorted(g for _, g, _ in lst) == [3, 20]  # the order-free window, not the reference's
    np.testing.assert_array_equal(lost, plain[3][:, 0, 0])


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(n_c=st.integers(1, 12), bc=st.integers(1, 6), extra=st.integers(0, 10),
       segments=st.integers(1, 11), seed=st.integers(0, 2 ** 31 - 1),
       lo=st.integers(-3, 0))
def test_unflagged_queries_are_bitwise_plain_on_tie_heavy_keys(n_c, bc, extra, segments, seed,
                                                               lo):
    """Random geometry and keys from a handful of values (-inf among them):
    whatever the ties, an unflagged query is bitwise plain."""
    rng = np.random.RandomState(seed)
    values = np.array([-INF] + list(range(lo, 3)), np.float32)
    gids, capmax, resid, capture = synthetic(rng, 3, n_c, bc, bc + 2, values)
    check_segmented(gids, capmax, resid, capture, bc + extra, n_c * (bc + 2),
                    min(segments, max(1, n_c - 1)))


def test_merge_segments_fit_the_kernel():
    """A segment a chunk after the first, at most 32 (16 when the queries'
    blocks outnumber the SMs), one when bc > 32, and within the block's
    shared memory; too large a window raises."""
    assert merge_segments(1283, 8, 104) == merge_segments(1283, 8, 104, 132) == 32
    assert merge_segments(1283, 8, 104, 256) == 16
    assert merge_segments(62, 8, 104) == 32
    assert merge_segments(10, 8, 104) == 9
    assert merge_segments(2, 8, 104) == 1
    assert merge_segments(5, 40, 104) == 1
    assert merge_smem_bytes(104, 8, 32) == 144 + 416 + 32 * (32 * 104 + 640)
    for n_c in (1, 2, 3, 10, 62, 1283, 100000):
        for bc, br in ((8, 104), (8, 16), (16, 1024), (32, 2048), (64, 128)):
            s = merge_segments(n_c, bc, br)
            assert 1 <= s <= min(MERGE_MAX_SEGMENTS, max(1, n_c - 1))
            assert s == 1 or (bc <= MERGE_LANE_BC and merge_smem_bytes(br, bc, s) <= MAX_MERGE_SMEM)
            assert s == min(MERGE_MAX_SEGMENTS, max(1, n_c - 1)) or bc > MERGE_LANE_BC \
                or merge_smem_bytes(br, bc, s + 1) > MAX_MERGE_SMEM
    assert merge_smem_bytes(10000, 8, 1) > MAX_MERGE_SMEM  # the kernel refuses it; plain runs
    z = torch.zeros
    args = (z(4, 8, 2, dtype=torch.int32), z(4, 8, 2), z(4, 1, 2), z(4, 2, 1024))
    with pytest.raises(ValueError, match="segments"):
        window_merge(*args, 16, 8, segments=4)
    with pytest.raises(ValueError, match="paths"):
        window_merge(*args, 16, 8, paths=torch.zeros(2, dtype=torch.int32))
    assert window_merge(*args, 10000, 8)[2].shape == (2, 10000)


def run_both(q, c, k, chunk, on_miss):
    kw = dict(chunk_size=chunk, impl="stream", select="merge", on_miss=on_miss)
    j = pe.exact_topk_mips(jnp.asarray(q), jnp.asarray(c), k, interpret=True, **kw)
    t = exact_topk_mips(torch.from_numpy(q), torch.from_numpy(c), k, **kw)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("on_miss", ["fallback", "flag"])
@pytest.mark.parametrize("n_c,k", [(4, 10), (6, 20)])
def test_merge_search_matches_jax_on_integer_data(rng, n_c, k, on_miss):
    """select="merge" through the port (the plain K1 and K9) against the
    JAX package's (interpret mode), integer rows so every score is exact:
    values, ids and the flag bitwise; the window the search used is the one
    the segments compose."""
    q = rng.randint(-2, 3, (4, 32)).astype(np.float32)
    c = rng.randint(-2, 3, (n_c * 2048, 32)).astype(np.float32)
    j, t = run_both(q, c, k, 2048, on_miss)
    for x, y in zip(j, t):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    bc, br, _ = _merge_geometry(k, n_c, 16, 4)
    assert bc == _capture_budget(k, n_c, 16)
    _, capture, gids, capmax, resid = stream_capture(torch.from_numpy(q), torch.from_numpy(c),
                                                     n_c * 2048, 2048, bc)
    check_segmented(gids.numpy(), capmax.numpy(), resid.numpy(), capture.numpy(), br,
                    n_c * 16, merge_segments(n_c, bc, br))

"""K2's float design (csrc/gather_groups.cu, gather_float_kernel) on the CPU.

The kernel lets each block own two (query, slot) pairs of the flat [Q * k]
list; its 8 warps scan stretches of the block's window (the pairs of 32
queries) for the other pairs that chose each owned pair's group (counting
the earlier ones, keeping the first 31 later ones each), and a pair whose
place among its group's pairs in the window is a multiple of 32 starts a
tile: itself and up to 31 pairs after it, scored once against the group and
scattered to their (query, slot) places. ``block_tiles`` restates that rule,
per-warp truncation included, and the tests hold that every pair with an id
inside the corpus lands in exactly one tile of consecutive pairs of its
group and window, that the scan's lists give the same tiles as the whole
window would, and that scoring each tile once and scattering reproduces
``gather_groups_plain`` bitwise (integer data, so any summation order is
exact), ids outside the corpus giving zeros.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kirag_tpu_torch.kernels import gather_groups, gather_groups_plain, quant_scores

PAIRS, TILE, WARPS, KEEP = 2, 32, 8, 31  # TILE: a tile's pairs and a window's queries


def window_of(p, n, k):
    lo = p // k // TILE * TILE * k
    return lo, min(n, lo + TILE * k)


def block_tiles(flat, n_groups, k, pp):
    """The tiles of the block that owns pairs 2 pp and 2 pp + 1: [(group,
    [pairs])], as the kernel's scan of the window (warp stretches of
    32-pair rounds, each keeping its first KEEP later pairs) and its rule."""
    n = len(flat)
    lo, hi = window_of(PAIRS * pp, n, k)
    stretch = -(-(hi - lo) // (WARPS * 32)) * 32
    tiles = []
    for i in range(PAIRS):
        p = PAIRS * pp + i
        if p >= hi or not 0 <= flat[p] < n_groups:
            continue
        g = flat[p]
        place, later, lists = 0, 0, []
        for w in range(WARPS):
            seg = range(lo + w * stretch, min(hi, lo + (w + 1) * stretch))
            place += sum(1 for x in seg if flat[x] == g and x < p)
            after = [x for x in seg if flat[x] == g and x > p]
            later += len(after)
            lists.append(after[:KEEP])
        if place % TILE:
            continue
        size = min(TILE, later + 1)
        members = [p] + [x for lst in lists for x in lst][:size - 1]
        tiles.append((g, members))
    return tiles


def all_tiles(flat, n_groups, k):
    return [t for pp in range(-(-len(flat) // PAIRS)) for t in block_tiles(flat, n_groups, k, pp)]


def check_cover(flat, n_groups, k):
    tiles = all_tiles(flat, n_groups, k)
    seen = [p for _, members in tiles for p in members]
    assert sorted(seen) == [p for p, g in enumerate(flat) if 0 <= g < n_groups]
    for g, members in tiles:
        assert 1 <= len(members) <= TILE
        lo, hi = window_of(members[0], len(flat), k)
        of_group = [p for p in range(lo, hi) if flat[p] == g]
        start = of_group.index(members[0])
        assert start % TILE == 0 and members == of_group[start:start + len(members)]
    return tiles


def test_tiles_cover_shared_groups():
    """40 queries choosing one set of 10 groups: per group a tile of the 32
    queries of the first window and one of the 8 of the second, started by
    queries 0 and 32."""
    flat = np.tile(np.arange(10), 40).tolist()
    tiles = check_cover(flat, 16, 10)
    assert sorted(len(m) for _, m in tiles) == [8] * 10 + [32] * 10
    assert sorted({m[0] // 10 for _, m in tiles}) == [0, 32]


def test_tiles_across_the_scan_stretches():
    """A group chosen by every tenth pair of 40 queries x 100 slots: 320 of
    them in the first window, more than 31 in each warp's stretch; the
    truncated lists still give consecutive tiles of 32."""
    rng = np.random.RandomState(3)
    flat = rng.randint(0, 3, 4000).tolist()
    flat[::10] = [7] * 400
    tiles = check_cover(flat, 8, 100)
    assert sorted(len(m) for g, m in tiles if g == 7) == [16] + [32] * 12


def test_windows_do_not_share_tiles():
    """70 queries all choosing group 0 (k = 1): one tile a window of 32
    queries, started by queries 0, 32 and 64."""
    tiles = check_cover([0] * 70, 1, 1)
    assert [(len(m), m[0]) for _, m in tiles] == [(32, 0), (32, 32), (6, 64)]


@settings(max_examples=80, deadline=None, derandomize=True)
@given(n_q=st.integers(1, 70), k=st.integers(1, 37), n_groups=st.integers(1, 12),
       seed=st.integers(0, 2 ** 31 - 1))
def test_every_pair_lands_in_one_tile(n_q, k, n_groups, seed):
    """Random lists with repeats inside rows and ids outside the corpus
    (-1 and n_groups), one to three windows: every pair inside lands in
    exactly one tile."""
    rng = np.random.RandomState(seed)
    flat = rng.randint(-1, n_groups + 1, n_q * k).tolist()
    check_cover(flat, n_groups, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 7, 33])
def test_tiles_scored_once_and_scattered_equal_plain(dtype, k):
    """Each tile's group scored once against its pairs' queries and the
    scores scattered to their places: bitwise ``gather_groups_plain`` (and
    the wrapper on the CPU), zeros for ids outside the corpus."""
    rng = np.random.RandomState(k)
    n_groups, d, n_q = 6, 40, 45
    corpus = torch.from_numpy(rng.randint(-2, 3, (n_groups * 128, d)).astype(np.float32))
    corpus = corpus.to(dtype)
    queries = torch.from_numpy(rng.randint(-2, 3, (n_q, d)).astype(np.float32)).to(dtype)
    gsel = torch.from_numpy(rng.randint(-1, n_groups + 1, (n_q, k)))
    gsel[:35] = gsel[0]  # 35 queries share their groups
    flat = gsel.reshape(-1).tolist()
    cand = torch.zeros(n_q * k, 128)
    for g, members in all_tiles(flat, n_groups, k):
        rows = corpus[g * 128:(g + 1) * 128]
        scores = quant_scores(queries[[p // k for p in members]], rows, None, "none")
        cand[members] = scores
    cand = cand.view(n_q, k, 128)
    want = gather_groups_plain(queries, corpus, gsel)
    assert torch.equal(cand, want)
    assert torch.equal(gather_groups(queries, corpus, gsel), want)

"""``kirag_tpu_torch.kernels.exact.search_plan``: how K1, K5 and K7a cut a
call over a float32, bfloat16, int8 or packed-int4 corpus into blocks (query
tiles x ranges of each chunk's groups; K5's corpus is one chunk), and a
model of K1's capture scratch.

The plan is a pure function of (Q, chunks, groups a chunk, element size,
capture budget), so its properties are held here on the CPU: every group of
every chunk is scored once for every query, the grid fills the H100 where the
corpus allows it, a block's shared memory fits, and K1's scratch stays a
bounded multiple of its capture. ``model_capture`` restates, in Python, how
K1 fills its scratch (each range keeps the scores of its best ``slots``
groups a query) and copies the capture out of it, and is held bitwise
against ``stream_capture_plain`` on tie-heavy and random data, float and
quantized. Element size 1 is an int8 or packed-int4 corpus (the mma order's
ring: bf16 query slices). The
kernels themselves run only on the card (``tests/test_torch_kernels.py``).
"""

import itertools

import pytest
import torch

from kirag_tpu_torch.kernels import stream_capture_plain
from kirag_tpu_torch.kernels.exact import (
    BLOCKS_PER_SM,
    FILL,
    FIN_MIN,
    LANES,
    MAX_SCRATCH,
    SMEM_PER_BLOCK,
    SMEM_PER_SM,
    SMEM_RESERVED,
    SMS,
    _sweep_smem,
    quant_scores,
    search_plan,
)
from kirag_tpu_torch.ops.exact import _capture_budget
from kirag_tpu_torch.ops.quantized import quantize_rows_int4_torch, quantize_rows_int8_torch

ONE_M_CHUNKS = 62     # 1,000,000 rows on the indexer's grid of 16,384-row chunks
G = 128               # groups of a 16,384-row chunk


def blocks_of(plan, num_chunks, groups):
    """(query tile, chunk, first group, groups) of every block, in the
    kernels' order: block x = (chunk * splits + split) * q_tiles + tile."""
    out = []
    for x in range(plan.blocks):
        tile, rng = x % plan.q_tiles, x // plan.q_tiles
        chunk, split = divmod(rng, plan.splits)
        g0 = split * plan.groups_per_block
        out.append((tile, chunk, g0, min(plan.groups_per_block, groups - g0)))
    return out


ONE_M_GROUPS = 7813     # phase 12's shuffled 1M rows: 1,000,064 rows, one chunk (K5)
DPR_GROUPS = 164183     # the DPR corpus, 21,015,324 rows: the largest float index a card holds
DPR_CHUNKS = 1283       # the DPR corpus on the indexer's grid of 16,384-row chunks (K1, K7a)
ELEMS = (4, 2, 1)       # float32, bfloat16, int8 / packed int4

GEOMETRIES = [  # (Q, chunks, groups a chunk, element bytes, b)
    *((n_q, ONE_M_CHUNKS, G, e, 8) for n_q in (1, 8, 16, 32, 33, 64, 256) for e in ELEMS),
    *((n_q, DPR_CHUNKS, G, 1, b) for n_q in (8, 32, 256) for b in (2, 0)),
    *((n_q, 1, G, 4, 128) for n_q in (1, 8, 9, 64, 256)),
    (32, 1, G, 4, 8), (8, 1283, G, 2, 8), (5, 8, 16, 4, 16), (40, 3, 7, 2, 3),
    *((n_q, ONE_M_CHUNKS, G, 4, 0) for n_q in (8, 32, 256)), (64, 1, G, 2, 0),
    # K5: the corpus as one chunk of every group, no capture
    *((n_q, 1, groups, e, 0) for n_q in (1, 8, 16, 32, 33, 64, 256)
      for groups in (1, 3, 1003, ONE_M_GROUPS) for e in ELEMS),
]


@pytest.mark.parametrize("n_q,chunks,groups,elem,b", GEOMETRIES)
def test_plan_scores_every_group_of_every_chunk_once(n_q, chunks, groups, elem, b):
    p = search_plan(n_q, chunks, groups, elem, b)
    assert p.q_tile in (4, 8, 16, 32) and p.q_tiles == -(-n_q // p.q_tile)
    assert p.blocks == p.q_tiles * chunks * p.splits
    seen = torch.zeros(p.q_tiles, chunks, groups, dtype=torch.int64)
    for tile, chunk, g0, n in blocks_of(p, chunks, groups):
        assert 1 <= n <= p.groups_per_block  # the kernel's cut check: no empty range
        seen[tile, chunk, g0:g0 + n] += 1
    assert bool((seen == 1).all())
    assert p.slots == (min(b, p.groups_per_block) if b else 0)
    assert p.tracks_best == (0 < b < p.groups_per_block)
    assert search_plan(n_q, chunks, groups, elem, b) == p  # a pure function of its inputs


@pytest.mark.parametrize("elem", ELEMS)
@pytest.mark.parametrize("n_q,chunks,b", [(8, ONE_M_CHUNKS, 8), (16, ONE_M_CHUNKS, 8),
                                          (32, ONE_M_CHUNKS, 8), (8, 1, G), (64, 1, G)])
def test_plan_fills_the_card(n_q, chunks, b, elem):
    """At 1M rows and on the one-chunk 16,384-row index (phase 6's), the
    grid holds at least one block per SM, for K1 and K7a."""
    for budget in (b, 0):
        assert search_plan(n_q, chunks, G, elem, budget).blocks >= SMS


def test_plan_splits_queries_where_the_groups_cannot_fill_the_card():
    """One chunk of 128 groups at Q = 8: one group a block is only 128
    blocks, so the tile drops to 4 queries; at 1M rows the tile holds all 8."""
    one = search_plan(8, 1, G, 4, 128)
    assert (one.q_tile, one.groups_per_block, one.blocks) == (4, 1, 256)
    assert search_plan(8, ONE_M_CHUNKS, G, 4, 8).q_tile == 8
    assert search_plan(32, ONE_M_CHUNKS, G, 4, 8).q_tiles == 1  # one HBM read at Q <= 32


@pytest.mark.parametrize("elem", ELEMS)
@pytest.mark.parametrize("groups", [16, 128, 1024])
def test_plan_shared_memory_fits(groups, elem):
    """Every Q up to 256 (and any depth: the queries are staged KD columns at
    a time with the rows) and every capture budget: a block's shared memory
    within 227 KB; at 128 groups a chunk, two blocks an SM, as the kernels'
    launch bounds promise (K1's bf16 32-query sweep promises one: its
    registers, not its shared memory, hold it there)."""
    for n_q, b in itertools.product(range(1, 257), sorted({0, 1, 8, groups // 2, groups})):
        for chunks in (1, ONE_M_CHUNKS):
            p = search_plan(n_q, chunks, groups, elem, b)
            assert p.smem <= SMEM_PER_BLOCK, (n_q, chunks, b, p)
            if groups == G:
                assert BLOCKS_PER_SM * (p.smem + SMEM_RESERVED) <= SMEM_PER_SM, (n_q, b, p)


@pytest.mark.parametrize("n_q", [1, 8, 32, 256])
def test_plan_bounds_the_capture_scratch(n_q):
    """K1's scratch holds splits x slots groups a (chunk, query): at most
    MAX_SCRATCH times the capture's b, and never more than the chunk's
    groups, whatever budget the indexer gives (1M rows, 1 to 62 chunks)."""
    for chunks in (1, 2, 8, ONE_M_CHUNKS):
        b = _capture_budget(100, chunks, G)
        for elem in ELEMS:
            p = search_plan(n_q, chunks, G, elem, b)
            assert p.splits * p.slots <= min(MAX_SCRATCH * b, G + p.splits), (chunks, p)


def test_plan_rejects_what_no_kernel_takes():
    for args in [(0, 1, G, 4, 8), (8, 0, G, 4, 8), (8, 1, G, 3, 8), (8, 1, G, 8, 8),
                 (8, 1, G, 4, G + 1), (8, 1, 0, 4, 0)]:
        with pytest.raises(ValueError, match="no search plan"):
            search_plan(*args)


@pytest.mark.parametrize("b", [2, 0])
@pytest.mark.parametrize("n_q", [8, 32, 256])
def test_quantized_plan_at_the_dpr_scale(n_q, b):
    """The int8/int4 K1 (b > 0) and K7a over the DPR corpus's 1,283 chunks:
    32-query tiles, so Q = 256 reads the codes 8 times (the pre-sweep kernel
    read them 32 times in 8-query tiles), at least a full wave of blocks, the
    scratch at most MAX_SCRATCH times the capture, two blocks an SM."""
    p = search_plan(n_q, DPR_CHUNKS, G, 1, b)
    assert p.q_tile == min(32, n_q) and p.q_tiles == -(-n_q // 32)
    assert p.blocks >= SMS * BLOCKS_PER_SM
    assert p.splits * p.slots <= MAX_SCRATCH * max(b, 1)
    assert BLOCKS_PER_SM * (p.smem + SMEM_RESERVED) <= SMEM_PER_SM


def test_quantized_plan_fills_the_card_at_1m_and_q8():
    """1M int8/int4 rows at Q = 8: one query tile (the codes read once),
    split until the blocks fill FILL of a wave of two an SM (the pre-sweep
    kernel ran 2 tiles x 62 chunks = 124 blocks on 132 SMs)."""
    for b in (8, 0):
        p = search_plan(8, ONE_M_CHUNKS, G, 1, b)
        assert p.q_tiles == 1 and p.blocks >= FILL * SMS * BLOCKS_PER_SM


@pytest.mark.parametrize("q_tile", [4, 8, 16, 32])
def test_quantized_ring_slot_holds_whole_n8_query_tiles(q_tile):
    """An int8/int4 ring slot: 256 rows of 128 + 16 bytes, then the query
    tile rounded up to whole n8 tiles of bf16 rows of 128 + 16 dims (the
    mma's B operand reads 8 query rows), twice at one n8 tile (int4's one
    walk reads both planes' dims); two slots, and K1's maxima and slots
    [2][QT] each, as score.cuh's mma_stage_bytes and the launch's figure."""
    stage = 256 * 144 + (2 if q_tile <= 8 else 1) * max(q_tile, 8) * 144 * 2
    assert _sweep_smem(1, q_tile, 0, 0, 1) == 2 * stage
    assert _sweep_smem(1, q_tile, 4, 4, 4) == 2 * stage + 16 * q_tile
    assert _sweep_smem(1, q_tile, 4, 4, 8) == 2 * stage + 16 * q_tile + 8 * q_tile * 4 + \
        4 * q_tile


# ------------------------------------------------ K5: the corpus as one chunk


@pytest.mark.parametrize("elem", ELEMS)
@pytest.mark.parametrize("n_q,groups", [(8, ONE_M_GROUPS), (16, ONE_M_GROUPS),
                                        (32, ONE_M_GROUPS), (8, G), (64, G)])
def test_k5_plan_fills_the_card(n_q, groups, elem):
    """At 1M rows and on phase 6's 16,384-row index, at least one block an
    SM; at 1M and Q <= 32 the corpus is read once (one query tile) and the
    blocks fill FILL of a wave of two an SM."""
    p = search_plan(n_q, 1, groups, elem)
    assert p.blocks >= SMS
    if groups == ONE_M_GROUPS:
        assert p.q_tiles == 1 and p.blocks >= FILL * SMS * BLOCKS_PER_SM


@pytest.mark.parametrize("elem", ELEMS)
def test_k5_plan_shared_memory_fits(elem):
    """K5 peels in registers: a block's shared memory is the ring alone (K7a's
    figure at its query tile), within 227 KB and two blocks an SM at every Q."""
    for n_q in range(1, 257):
        for groups in (G, ONE_M_GROUPS, DPR_GROUPS):
            p = search_plan(n_q, 1, groups, elem)
            assert p.smem == _sweep_smem(elem, p.q_tile, 0, 0, p.groups_per_block)
            assert p.smem <= SMEM_PER_BLOCK
            assert BLOCKS_PER_SM * (p.smem + SMEM_RESERVED) <= SMEM_PER_SM, (n_q, groups, p)


@pytest.mark.parametrize("elem", ELEMS)
@pytest.mark.parametrize("n_q", [1, 8, 32, 256, 4096])
def test_k5_plan_fits_the_grid_at_the_dpr_scale(n_q, elem):
    """At the DPR corpus's 164,183 groups: the kernel's cut check passes
    (the last range holds 1 .. gpb groups), its row ids fit the int32 group
    count x 128, and the blocks fit one grid axis (2^31 - 1)."""
    p = search_plan(n_q, 1, DPR_GROUPS, elem)
    assert (p.splits - 1) * p.groups_per_block < DPR_GROUPS <= p.splits * p.groups_per_block
    assert DPR_GROUPS * LANES < 2 ** 31 and p.blocks < 2 ** 31
    assert p.blocks == p.q_tiles * p.splits >= SMS


# ------------------------------------------------ the capture scratch, modelled


def beats(v, g, bv, bg):
    """The peel's strict order: larger maximum first, then the lower id."""
    return v > bv or (v == bv and g < bg)


def model_capture(scores, valid_rows, b, splits, gpb, slots):
    """The float K1's two launches over chunk-major scores [C, Q, chunk]:
    each range of ``gpb`` groups walks its groups two a pass and gives a
    group a scratch slot (its own when slots == gpb, else the worst held
    one's when it beats it; a pass's second group taking the first's slot
    cancels the first's copy); then the peel of the clamped maxima, each pick
    copied from its range's slot. Returns K1's five outputs."""
    n_c, n_q, chunk = scores.shape
    groups = chunk // LANES
    rows = torch.arange(n_c * chunk).view(n_c, 1, chunk)
    gm = torch.where(rows < valid_rows, scores, FIN_MIN).view(n_c, n_q, groups, LANES)
    gm = gm.amax(-1).clamp_min(FIN_MIN)                                   # [C, Q, G]
    scratch = torch.full((n_c, splits, n_q, slots, LANES), float("nan"))
    held_gid = torch.full((n_c, splits, n_q, slots), -1, dtype=torch.int64)
    tracking = slots < gpb
    for c, split, q in itertools.product(range(n_c), range(splits), range(n_q)):
        g0 = split * gpb
        n = min(gpb, groups - g0)
        hv, hg, worst = [None] * slots, [None] * slots, None
        for p in range((n + 1) // 2):
            taken = []
            for gl in range(min(2, n - 2 * p)):
                local = 2 * p + gl
                g, m = g0 + local, float(gm[c, q, g0 + local])
                slot = -1
                if not tracking or local < slots:
                    slot = local
                elif beats(m, g, hv[worst], hg[worst]):
                    slot = worst
                if tracking and slot >= 0:
                    hv[slot], hg[slot] = m, g
                    held_gid[c, split, q, slot] = g
                    if local >= slots - 1:
                        worst = 0
                        for s in range(1, slots):
                            if beats(hv[worst], hg[worst], hv[s], hg[s]):
                                worst = s
                if gl == 1 and slot >= 0 and slot == taken[0]:
                    taken[0] = -1
                taken.append(slot)
            for gl, slot in reversed(list(enumerate(taken))):  # the kernel's copies race
                if slot >= 0:
                    g = g0 + 2 * p + gl
                    scratch[c, split, q, slot] = scores[c, q, g * LANES:(g + 1) * LANES]
    order_v, order_i = torch.sort(gm, dim=-1, descending=True, stable=True)
    sel = order_i[..., :b]
    capture = torch.empty(n_c, n_q, b, LANES)
    for c, q, r in itertools.product(range(n_c), range(n_q), range(b)):
        g = int(sel[c, q, r])
        split = g // gpb
        slot = held_gid[c, split, q].tolist().index(g) if tracking else g - split * gpb
        capture[c, q, r] = scratch[c, split, q, slot]
    resid = order_v[..., b] if b < groups else torch.full((n_c, n_q), float("-inf"))
    gids = sel + torch.arange(n_c).view(-1, 1, 1) * groups
    return (gm.transpose(1, 2), capture.reshape(n_c, n_q, b * LANES),
            gids.to(torch.int32).transpose(1, 2), order_v[..., :b].transpose(1, 2),
            resid[:, None, :])


CUTS = [  # (b, splits, groups a range): slots = min(b, groups a range)
    (4, 1, 16), (4, 4, 4), (4, 3, 6), (4, 16, 1), (2, 2, 8), (16, 1, 16), (16, 16, 1),
    (1, 5, 4), (6, 2, 8),
]


@pytest.mark.parametrize("data", ["ties", "random"])
@pytest.mark.parametrize("b,splits,gpb", CUTS)
def test_capture_model_equals_the_plain_capture(b, splits, gpb, data):
    """Whatever the cut, the capture copied out of the ranges' best slots is
    the plain version's capture, gids, capmax and resid, bitwise: on integer
    data every group maximum ties with many others, so the order's tie rule
    decides which group a slot holds."""
    g = torch.Generator().manual_seed(7 + splits)
    n_c, chunk, d, n_q = 3, 16 * LANES, 8, 3
    if data == "ties":
        c = torch.randint(-1, 2, (n_c * chunk, d), generator=g).float()
        q = torch.randint(-1, 2, (n_q, d), generator=g).float()
    else:
        c = torch.randn(n_c * chunk, d, generator=g)
        q = torch.randn(n_q, d, generator=g)
    valid = n_c * chunk - 200
    scores = torch.stack([quant_scores(q, c[i * chunk:(i + 1) * chunk], None, "none")
                          for i in range(n_c)])
    got = model_capture(scores, valid, b, splits, gpb, min(b, gpb))
    want = stream_capture_plain(q, c, valid, chunk, b)
    for x, y in zip(got, want):
        assert torch.equal(x.contiguous(), y)


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("b,splits,gpb", CUTS)
def test_capture_model_equals_the_plain_capture_on_quantized_scores(b, splits, gpb, quant):
    """The int8/int4 K1 fills and copies its scratch as the float one does:
    the model over quantized scores (random unit rows quantized, queries
    rounded to bf16 as the wrapper rounds them) is the plain version's
    capture, gids, capmax and resid, bitwise."""
    g = torch.Generator().manual_seed(11 + splits)
    n_c, chunk, d, n_q = 3, 16 * LANES, 256, 3
    rows = torch.nn.functional.normalize(torch.randn(n_c * chunk, d, generator=g), dim=-1)
    c, s = (quantize_rows_int8_torch if quant == "int8" else quantize_rows_int4_torch)(rows)
    q = torch.randn(n_q, d, generator=g)
    valid = n_c * chunk - 200
    scores = torch.stack([quant_scores(q, c[i * chunk:(i + 1) * chunk],
                                       s[i * chunk:(i + 1) * chunk], quant) for i in range(n_c)])
    got = model_capture(scores, valid, b, splits, gpb, min(b, gpb))
    want = stream_capture_plain(q, c, valid, chunk, b, s, quant)
    for x, y in zip(got, want):
        assert torch.equal(x.contiguous(), y)


def test_capture_model_takes_the_plans_cuts():
    """The cuts search_plan gives at these sizes are among the modelled ones:
    one chunk (b = G: a slot a group) and many chunks (b < G: best kept)."""
    one = search_plan(8, 1, 16, 4, 16)
    many = search_plan(3, 3, 16, 4, 4)
    assert (one.slots, one.groups_per_block) == (1, 1)
    assert many.slots == min(4, many.groups_per_block)
    assert (4, many.splits, many.groups_per_block) in CUTS or not many.tracks_best

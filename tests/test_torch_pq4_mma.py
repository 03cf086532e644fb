"""pq4 in ``csrc/score.cuh``'s mma order, restated in numpy.

The pq4 kernels (K1, K2 and K7a on product-quantized corpora) look each
code's bf16 level up in a table that the wrapper lays out once
(``kernels.exact._pq_kernel_table``) and that ``pq_slot`` reads in shared
memory, then sum the levels against the bf16 queries with ``mma.sync``
m16n8k16, one chain per (component j, nibble plane p), folded in (j, p)
order. The kernels run only on the card; here:

- the table holds ``bf16(L[n, j m + s])`` at the byte the kernel's address
  formula gives for every (subspace s, code n, component j), and one load of
  a k-step puts lanes of different t on the bank halves (pair entries) or
  quarters (single bf16 entries) the layout promises;
- one warp of ``pq_slot`` is emulated lane by lane: the code word a lane
  reads, the nibble's table offset (the shifts, masks and ``prmt`` of the
  source), the bf16x2 A registers, the 8-byte B loads, and the m16n8k16
  fragments of PTX's layout, so each product pairs query dim
  ``j m + p m / 2 + 16 s + 4 t + e`` with the level of that dim; chains and
  the fold of ``pq_passes`` give ``quant_scores``' values bitwise on integer
  data;
- ``search_plan``'s pq4 cuts cover their calls within 227 KB of shared
  memory a block, and ``score_probe`` runs its plain version on the CPU.
"""

import itertools

import numpy as np
import pytest
import torch

from kirag_tpu_torch.kernels.exact import (
    FILL,
    SMEM_PER_BLOCK,
    SMEM_PER_SM,
    SMS,
    _pq_kernel_table,
    pq_table_bytes,
    pq_table_geometry,
    pq_table_offsets,
    quant_scores,
    score_probe,
    score_probe_plain,
    search_plan,
    sweep_blocks_per_sm,
)

MMA_SLOT_BYTES = 128   # score.cuh: bytes of each row a ring slot holds
MMA_KSTEP = 16         # dims of one mma
PQ_Q_PAD = 16          # bf16 padding of a query row in shared memory

GEOMETRIES = [(1024, 128), (1024, 256), (1024, 512), (1024, 1024), (384, 96),
              (2048, 256), (2048, 512), (2048, 1024), (2048, 2048)]


def bf16_bits(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bits_to_f64(h) -> np.ndarray:
    return (np.asarray(h, dtype=np.uint32) << 16).view(np.float32).astype(np.float64)


def prmt(a: int, b: int, sel: int) -> int:
    """``prmt.b32`` in its default mode (byte i of d is byte ``sel >> 4 i``
    of {b, a})."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 0x7] << (8 * i) for i in range(4))


def table_bytes_of(levels: np.ndarray, m: int) -> np.ndarray:
    """The wrapper's kernel table as raw bytes."""
    table = _pq_kernel_table(torch.from_numpy(levels), m)
    return table.view(torch.int16).numpy().view(np.uint8)


class Lane:
    """What pq_slot computes for lane t of the walk of entry h from the
    table's shared address (0 here; the kernel's is a multiple of 256):
    pq_lane_base, the walk's base tb and the or'd byte tw, the k-step's
    plane base tp, then a lookup's address: prmt of byte e of the shifted
    code word (with tw) under bytes 1-3 of tp, plus the load's immediate
    (4 ks + e) H 128."""

    def __init__(self, d: int, m: int, t: int, h: int):
        self.u, self.h, self.eb, self.w, q_per_m = pq_table_geometry(d // m)
        self.m, self.t = m, t
        tbase = t // self.w * (q_per_m * m)
        self.tb = tbase + (h >> 1) * 256
        self.tw = (t % self.w * 16 * self.eb | (h & 1) << 7) * 0x01010101

    def address(self, word: int, p: int, c0: int, ks: int, e: int) -> int:
        tp = self.tb + (p * (self.m // 2) + c0) // 16 * (512 * self.h)
        assert tp % 256 == 0  # bytes 1-3 of tp carry it whole
        if self.eb == 4:
            x = ((word >> 2) if p else (word << 2) & 0xFFFFFFFF) & 0x3C3C3C3C
        else:
            x = ((word >> 3) if p else (word << 1) & 0xFFFFFFFF) & 0x1E1E1E1E
        a = prmt(x | self.tw, tp, 0x7650 | e)
        return a + (4 * ks + e) * self.h * 128


def kernel_address(d: int, m: int, s: int, h: int, n: int) -> int:
    """The byte the kernel reads for entry h of subspace s and code n: a
    word whose byte e holds n at s's plane."""
    m2 = m // 2
    p, b = divmod(s, m2)
    c0, ks = b // MMA_SLOT_BYTES * MMA_SLOT_BYTES, b % MMA_SLOT_BYTES // MMA_KSTEP
    t, e = b % 16 // 4, b % 4
    word = (n << (4 * p)) << (8 * e)
    return Lane(d, m, t, h).address(word, p, c0, ks, e)


@pytest.mark.parametrize("d,m", GEOMETRIES)
def test_kernel_table_holds_each_level_where_the_kernel_reads_it(d, m):
    """The kernel's address of every (subspace, entry, code) holds the bf16
    levels of the entry's components; the table is 32 D bytes, each level
    once; the builder's offsets are the kernel's."""
    rng = np.random.default_rng(d + m)
    levels = rng.standard_normal((16, d)).astype(np.float32)
    raw = table_bytes_of(levels, m)
    u_n, h_n = pq_table_geometry(d // m)[:2]
    assert len(raw) == pq_table_bytes(d, m) == 32 * d
    want_bits = bf16_bits(levels)
    seen = set()
    for s, h, n in itertools.product(range(m), range(h_n), range(16)):
        a = kernel_address(d, m, s, h, n)
        assert a == pq_table_offsets(d, m, s, h, n)
        for u in range(u_n):
            got = int(raw[a + 2 * u]) | int(raw[a + 2 * u + 1]) << 8
            assert got == want_bits[n, (u_n * h + u) * m + s], (s, h, n, u)
            seen.add(a + 2 * u)
    assert len(seen) == 16 * d  # every level once: the table holds nothing else


@pytest.mark.parametrize("ds", [1, 2, 4, 8])
def test_lanes_of_a_load_read_the_bank_halves_or_quarters_of_their_t(ds):
    """In one table load of a k-step (fixed plane, byte e, entry), lane t
    reads subspace 16 ks + 4 t + e of its plane: every code of t's subspace
    lies in bank half (t % 2) (pair entries) or quarter t (single bf16
    entries), so lanes of neighbouring t never clash, and the 16 codes of
    one subspace hit distinct banks or share a word."""
    m = 256
    d = ds * m
    eb, w = pq_table_geometry(ds)[2:4]
    parts = 32 // (16 * eb // 4)  # banks a run of 16 entries spans: 16 or 8
    for p, ks, e, h, n in itertools.product(range(2), range(8), range(4),
                                            range(pq_table_geometry(ds)[1]), [0]):
        part = {}
        for t in range(4):
            s = p * (m // 2) + MMA_KSTEP * ks + 4 * t + e
            addr = np.array([kernel_address(d, m, s, h, code) for code in range(16)])
            banks, words = addr // 4 % 32, addr // 4
            assert len(np.unique(words)) == len(np.unique(banks))  # no clash inside t
            assert len(set(banks // (32 // parts))) == 1
            part[t] = int(banks[0] // (32 // parts))
        assert len({part[t] for t in range(parts)}) == parts, part


# ------------------------------------------------- one warp of pq_slot, emulated


def swizzled_slot(rows: np.ndarray, c0: int) -> np.ndarray:
    """A pq4 ring slot of these 32 rows as issue_mma_rows<true> fills it: bytes
    [c0, c0 + 128) of each row (zeros past its end), 128 bytes a row, 16-byte
    chunk c of row r at chunk c ^ r % 8."""
    slot = np.zeros((32, MMA_SLOT_BYTES), dtype=np.uint8)
    part = rows[:, c0:c0 + MMA_SLOT_BYTES]
    for r, c in itertools.product(range(32), range(part.shape[1] // 16)):
        slot[r, (c ^ r % 8) * 16:(c ^ r % 8) * 16 + 16] = part[r, c * 16:c * 16 + 16]
    return slot


def pq_slot_emulated(ch, rows, table_raw, queries, d, m, h, c0, ksteps):
    """score.cuh's pq_slot for one warp of 32 rows (``rows`` [32, m/2] uint8
    codes, staged into a swizzled slot of bytes [c0, c0 + 128)) against 8
    queries (``queries`` [8, d], bf16 values as f64), advancing ``ch`` [U][2]
    of [32, 8] f64 sums for the walk of entry h. Each lane's registers are
    formed as the source forms them; the mma is PTX's m16n8k16 with exact
    sums (integer data)."""
    u_n, h_n, eb = pq_table_geometry(d // m)[:3]
    m2 = m // 2
    slot = swizzled_slot(rows, c0)

    def entry(a):
        v = int(table_raw[a]) | int(table_raw[a + 1]) << 8
        return v | (int(table_raw[a + 2]) << 16 | int(table_raw[a + 3]) << 24 if eb == 4 else 0)

    qbits = bf16_bits(queries.astype(np.float32))
    lanes = [Lane(d, m, lane % 4, h) for lane in range(32)]
    for ks in range(ksteps):
        for p in range(2):
            a_reg = {}   # (lane, u, mt, k) -> A register k of m16 tile mt
            for lane in range(32):
                g, t = lane // 4, lane % 4
                v = {}
                for mt, r in itertools.product(range(2), range(2)):
                    row = g + 16 * mt + 8 * r
                    off = (ks ^ g) * 16 + 4 * t  # word t of chunk ks, at chunk ks ^ g
                    w = sum(int(slot[row, off + i]) << (8 * i) for i in range(4))
                    for e in range(4):
                        v[mt, r, e] = entry(lanes[lane].address(w, p, c0, ks, e))
                for u in range(u_n):
                    sel = 0x7632 if u else 0x5410
                    for mt, r in itertools.product(range(2), range(2)):
                        a_reg[lane, u, mt, r] = prmt(v[mt, r, 0], v[mt, r, 1], sel)
                        a_reg[lane, u, mt, 2 + r] = prmt(v[mt, r, 2], v[mt, r, 3], sel)
            for u in range(u_n):
                # PTX m16n8k16 .bf16 fragments: A regs 0..3 hold (row g, k 2t..),
                # (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); B's x, y (k 2t..,
                # col g), (2t + 8.., g); D's c0..c3 (g, 2t..), (g + 8, 2t..)
                dim0 = (u_n * h + u) * m + p * m2 + c0 + MMA_KSTEP * ks
                b = np.zeros((16, 8))
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    four = qbits[g, dim0 + 4 * t:dim0 + 4 * t + 4]  # the 8-byte B load
                    for kk, val in zip((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9), four):
                        b[kk, g] = bits_to_f64(val)
                for mt in range(2):
                    a = np.zeros((16, 16))
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        for k, (row, k0) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                                       (g, 2 * t + 8), (g + 8, 2 * t + 8))):
                            reg = a_reg[lane, u, mt, k]
                            a[row, k0] = bits_to_f64(reg & 0xFFFF)
                            a[row, k0 + 1] = bits_to_f64(reg >> 16)
                    ch[u][p][16 * mt:16 * mt + 16] += a @ b


def pq_passes_emulated(rows, levels, queries, m):
    """One warp's pass of pq_passes: a walk of each entry over the row's
    slots, each chain from zero, folded (U h, lo), (U h, hi), (U h + 1, lo),
    ... in f32, each sum rounded on its own."""
    d = levels.shape[1]
    u_n, h_n = pq_table_geometry(d // m)[:2]
    raw = table_bytes_of(levels, m)
    m2 = m // 2
    acc = None
    for h in range(h_n):
        ch = [[np.zeros((32, 8)) for _ in range(2)] for _ in range(u_n)]
        for c0 in range(0, m2, MMA_SLOT_BYTES):
            pq_slot_emulated(ch, rows, raw, queries, d, m, h, c0,
                             min(MMA_SLOT_BYTES, m2 - c0) // MMA_KSTEP)
        for u, p in itertools.product(range(u_n), range(2)):
            part = ch[u][p].astype(np.float32)
            acc = part if acc is None else (acc + part).astype(np.float32)
    return acc


@pytest.mark.parametrize("d,m", [(1024, 256), (512, 512), (384, 96), (2048, 1024), (1024, 128),
                                 (2048, 2048)])
def test_emulated_warp_pairs_each_query_dim_with_its_level(d, m):
    """Integer levels and queries, so every sum is exact: the emulated warp
    gives quant_scores' values bitwise, which it does only if lane t's byte
    e of k-step ks at plane p, component j, meets query dim j m + p m / 2 +
    16 ks + 4 t + e in the same k-slot of A and B."""
    rng = np.random.default_rng(d * 7 + m)
    rows = rng.integers(0, 256, (32, m // 2), dtype=np.uint8)
    levels = rng.integers(-3, 4, (16, d)).astype(np.float32)
    queries = rng.integers(-2, 3, (8, d)).astype(np.float32)
    got = pq_passes_emulated(rows, levels, queries, m)
    want = quant_scores(torch.from_numpy(queries), torch.from_numpy(rows),
                        torch.from_numpy(levels), "pq4").T.numpy()
    np.testing.assert_array_equal(got, want)


def test_swizzled_slot_loads_hit_distinct_banks():
    """issue_mma_rows<true>'s layout: the word t loads of rows g (one k-step, 8 rows
    x 4 words) hit 32 distinct banks at every k-step."""
    for ks in range(8):
        banks = {((r * MMA_SLOT_BYTES + (ks ^ r % 8) * 16 + 4 * t) // 4) % 32
                 for r in range(8) for t in range(4)}
        assert len(banks) == 32


def test_emulated_warp_on_one_hot_levels_finds_each_byte():
    """One level 1 at one (code, dim), zeros elsewhere, one query dim 1:
    the score is 1 exactly for the rows whose code at that dim's subspace is
    that code, 0 for the others; at every (plane, k-step, t, e, component)
    of a D = 512, m = 256 geometry sampled."""
    d, m = 512, 256
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (32, m // 2), dtype=np.uint8)
    m2 = m // 2
    for dim in rng.choice(d, 12, replace=False):
        j, s = divmod(int(dim), m)
        p, b = divmod(s, m2)
        code = int((rows[5, b] >> (4 * p)) & 15)
        levels = np.zeros((16, d), dtype=np.float32)
        levels[code, dim] = 1.0
        queries = np.zeros((8, d), dtype=np.float32)
        queries[3, dim] = 1.0
        got = pq_passes_emulated(rows, levels, queries, m)
        want = ((rows[:, b] >> (4 * p)) & 15) == code
        np.testing.assert_array_equal(got[:, 3], want.astype(np.float32))
        assert not got[:, [0, 1, 2, 4, 5, 6, 7]].any()


# ------------------------------------------------------------- search_plan


def blocks_of(plan, num_chunks, groups):
    out = []
    for x in range(plan.blocks):
        tile, rng = x % plan.q_tiles, x // plan.q_tiles
        chunk, split = divmod(rng, plan.splits)
        g0 = split * plan.groups_per_block
        out.append((tile, chunk, g0, min(plan.groups_per_block, groups - g0)))
    return out


def pq_smem(d, m, q_tile, b, slots, gpb):
    """score.cuh's sweep_ring_bytes for pq4 (the table, 32 D bytes; two
    slots of 256 rows x 128 bytes, or of the transpose's 33 floats a row at
    32 queries; the query tile's whole n8 tiles of D + 16 bf16) plus K1's
    maxima, slots and held groups (capture_sweep_kernel)."""
    q_rows = -(-q_tile // 8) * 8
    smem = 32 * d + 2 * 256 * max(128, (q_tile + 1) * 4) + q_rows * (d + PQ_Q_PAD) * 2
    if b:
        smem += 16 * q_tile + ((8 * q_tile * slots + 4 * q_tile) if slots < gpb else 0)
    return smem


PLAN_CASES = [(n_q, chunks, groups, b, d, m)
              for n_q in (1, 8, 16, 32, 33, 256)
              for chunks, groups, b in ((62, 128, 8), (1283, 128, 2), (1283, 128, 0),
                                        (1, 128, 128), (3, 7, 3))
              for d, m in ((1024, 256), (1024, 128), (2048, 256), (2048, 2048))]


@pytest.mark.parametrize("n_q,chunks,groups,b,d,m", PLAN_CASES)
def test_pq4_plan_covers_the_call_within_a_blocks_shared_memory(n_q, chunks, groups, b, d, m):
    p = search_plan(n_q, chunks, groups, 1, b, (d, m))
    assert p.q_tile in (4, 8, 16, 32) and p.q_tiles == -(-n_q // p.q_tile)
    assert p.smem == pq_smem(d, m, p.q_tile, b, p.slots, p.groups_per_block)
    assert p.smem <= SMEM_PER_BLOCK
    seen = np.zeros((p.q_tiles, chunks, groups), dtype=np.int64)
    for tile, chunk, g0, n in blocks_of(p, chunks, groups):
        assert 1 <= n <= p.groups_per_block
        seen[tile, chunk, g0:g0 + n] += 1
    assert (seen == 1).all()
    assert p.slots == (min(b, p.groups_per_block) if b else 0)


def test_pq4_plan_fills_its_waves_and_cuts_the_tile_at_d_2048():
    """At 1M rows (62 chunks) and at 21M (1283) every Q <= 32 is one query
    tile whose blocks fill FILL of their last wave; two blocks an SM at 8
    queries and D = 1024 (two blocks' shared memory fits an SM), one at 16
    and 32 and at D = 2048; at D = 1024 the 32-query tile fits a block, at
    D = 2048 the plan takes 16."""
    for chunks, b in ((62, 8), (1283, 2)):
        for n_q, d, per_sm in ((8, 1024, 2), (16, 1024, 1), (32, 1024, 1), (8, 2048, 1)):
            p = search_plan(n_q, chunks, 128, 1, b, (d, 256))
            assert sweep_blocks_per_sm(p.q_tile, p.smem, (d, 256)) == per_sm
            assert per_sm == 1 or 2 * (p.smem + 1024) <= SMEM_PER_SM
            wave = SMS * per_sm
            assert p.blocks / (-(-p.blocks // wave) * wave) >= FILL and p.q_tiles == 1
    assert search_plan(32, 1283, 128, 1, 2, (1024, 256)).q_tile == 32
    assert search_plan(32, 1283, 128, 1, 2, (2048, 256)).q_tile == 16
    with pytest.raises(ValueError, match="no search plan"):
        search_plan(8, 4, 128, 1, 2, (1536, 96))   # not a kernel geometry
    with pytest.raises(ValueError, match="no search plan"):
        search_plan(8, 4, 128, 2, 2, (1024, 256))  # pq4 rows are bytes


# ------------------------------------------------------------- the probe


@pytest.mark.parametrize("d,m", [(1024, 256), (512, 512), (2048, 256)])
def test_score_probe_pq4_runs_its_plain_version_on_the_cpu(d, m):
    g = torch.Generator().manual_seed(5)
    codes = torch.randint(0, 256, (3, 32, m // 2), generator=g).to(torch.uint8)
    table = torch.randn(16, d, generator=g)
    q = torch.randn(3, 8, d, generator=g)
    out = score_probe(codes, table, q, "pq4")
    assert out.shape == (3, 32, 8)
    assert torch.equal(out, score_probe_plain(codes, table, q, "pq4"))
    for t in range(3):
        assert torch.equal(out[t], quant_scores(q[t], codes[t], table, "pq4").T)
    with pytest.raises(ValueError, match="level table"):
        score_probe(codes, table[:8], q, "pq4")
    with pytest.raises(ValueError, match="do not match"):
        score_probe(codes, table, q[..., :d // 2], "pq4")


def test_kernel_table_is_made_for_each_m():
    """One level table read with two subquantizer counts (a test or a tool
    may do so) gives each its own layout."""
    levels = torch.randn(16, 1024)
    a, b = _pq_kernel_table(levels, 256), _pq_kernel_table(levels, 128)
    assert a.numel() * 2 == pq_table_bytes(1024, 256) and b.numel() * 2 == pq_table_bytes(1024, 128)
    assert torch.equal(_pq_kernel_table(levels, 256), a)

"""The int8/int4 decode of ``csrc/score.cuh``'s mma order, restated in numpy.

The tensor-core kernels (K1, K2, K5 and K7a on int8 and packed-int4
corpora) turn four codes of a row, one 32-bit word, into two bf16x2 mma
operands with integer operations, ``prmt`` and one bf16 ``fma``
(``decode_i8``, ``decode_i4``). The order's products are exact only if every
decoded value is exactly the code (int8) or the level n - 7.5 (int4). The
kernels run only on the card; here each instruction is restated bit for bit
(``prmt`` in its default mode, ``fma.rn.bf16x2`` as an exact sum rounded to
bf16) and every code and nibble, at every byte of a word, is held against
the value it stands for.
"""

import numpy as np
import pytest
import torch


def prmt(a: int, b: int, sel: int) -> int:
    """``prmt.b32 d, a, b, sel`` (default mode): byte i of d is byte
    ``sel >> 4 i & 7`` of the eight bytes {b, a} (a's bytes 0-3, b's 4-7);
    selector bit 3 (sign replication) is not used by the decode."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = 0
    for i in range(4):
        nib = (sel >> (4 * i)) & 0xF
        assert nib < 8
        out |= src[nib] << (8 * i)
    return out


def bf16_bits_to_f64(h: int) -> float:
    return float(np.array([h << 16], dtype=np.uint32).view(np.float32)[0])


def f64_to_bf16_bits(x: float) -> int:
    """Round to nearest even bf16 (through torch's conversion)."""
    return int(torch.tensor([x], dtype=torch.float64).to(torch.bfloat16).view(torch.int16)[0]) \
        & 0xFFFF


def bf16x2_add(a: int, c: int) -> int:
    """``fma.rn.bf16x2 d, a, 1.0, c``: each half a * 1 + c, the exact sum
    rounded once to bf16."""
    out = 0
    for half in range(2):
        x = bf16_bits_to_f64((a >> (16 * half)) & 0xFFFF)
        y = bf16_bits_to_f64((c >> (16 * half)) & 0xFFFF)
        out |= f64_to_bf16_bits(x + y) << (16 * half)
    return out


def decode_i8(w: int):
    """score.cuh's decode_i8: bytes 0, 1 -> lo, bytes 2, 3 -> hi."""
    m = w & 0x7F7F7F7F
    b7 = w & 0x80808080
    lo = bf16x2_add(prmt(m, 0x43434343, 0x4140), prmt(b7, 0xC3C3C3C3, 0x4140))
    hi = bf16x2_add(prmt(m, 0x43434343, 0x4342), prmt(b7, 0xC3C3C3C3, 0x4342))
    return lo, hi


def decode_i4(w: int, plane: int):
    """score.cuh's decode_i4: the low (plane 0) or high (1) nibbles of bytes
    0, 1 -> lo, bytes 2, 3 -> hi."""
    shifted = (w >> 3) if plane else (w << 1) & 0xFFFFFFFF
    x = (shifted & 0x1E1E1E1E) | 0x80808080
    lo = bf16x2_add(prmt(x, 0x42424242, 0x4140), 0xC28FC28F)
    hi = bf16x2_add(prmt(x, 0x42424242, 0x4342), 0xC28FC28F)
    return lo, hi


def halves(lo: int, hi: int):
    """The four decoded bf16 values of a word, bytes 0-3, as bit patterns."""
    return [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16]


def word(byte_values):
    return sum((int(v) & 0xFF) << (8 * i) for i, v in enumerate(byte_values))


@pytest.mark.parametrize("pos", range(4))
def test_every_int8_code_decodes_to_itself_at_every_byte(pos):
    """All 256 int8 codes (the quantizer's [-127, 127] and -128), each at
    byte ``pos`` of a word whose other bytes hold other codes: the bf16 bits
    are exactly the code's, +0.0 for zero (never -0.0)."""
    rng = np.random.RandomState(pos)
    for code in range(-128, 128):
        others = rng.randint(-128, 128, 4)
        others[pos] = code
        got = halves(*decode_i8(word(others)))
        for b, v in enumerate(others):
            assert got[b] == f64_to_bf16_bits(float(v)), (code, pos, b)
            assert bf16_bits_to_f64(got[b]) == v


@pytest.mark.parametrize("plane", [0, 1])
@pytest.mark.parametrize("pos", range(4))
def test_every_int4_nibble_decodes_to_its_level_at_every_byte(pos, plane):
    """All 16 nibbles, in the low (dim t) and the high (dim t + D/2) half of
    byte ``pos``, the other nibbles random: the bf16 bits are exactly the
    level n - 7.5's, and the other plane's nibble does not leak in."""
    rng = np.random.RandomState(10 + 4 * plane + pos)
    for n in range(16):
        lo_nib = rng.randint(0, 16, 4)
        hi_nib = rng.randint(0, 16, 4)
        (hi_nib if plane else lo_nib)[pos] = n
        got = halves(*decode_i4(word(lo_nib | (hi_nib << 4)), plane))
        levels = (hi_nib if plane else lo_nib) - 7.5
        for b, v in enumerate(levels):
            assert got[b] == f64_to_bf16_bits(float(v)), (n, pos, plane, b)
            assert bf16_bits_to_f64(got[b]) == v


def test_decoded_words_on_random_rows_are_the_codes():
    """Whole random words, both formats: the two operands hold bytes 0, 1
    (lo, the earlier dim in the lower half) and 2, 3 (hi), the k-slot
    order of score.cuh's header note."""
    rng = np.random.RandomState(3)
    for w in rng.randint(0, 2 ** 32, 2000, dtype=np.uint64):
        w = int(w)
        codes = [((w >> (8 * i)) & 0xFF) - (256 if (w >> (8 * i + 7)) & 1 else 0)
                 for i in range(4)]
        assert [bf16_bits_to_f64(h) for h in halves(*decode_i8(w))] == codes
        for plane in (0, 1):
            levels = [((w >> (8 * i + 4 * plane)) & 0xF) - 7.5 for i in range(4)]
            assert [bf16_bits_to_f64(h) for h in halves(*decode_i4(w, plane))] == levels


def test_products_of_decoded_values_and_bf16_queries_are_exact_in_f32():
    """Why only the sums round: a bf16 query value (8 significant bits)
    times a code (at most 8) or a level (at most 4) has at most 16
    significant bits, exact in f32, whatever the exponents the queries
    take."""
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(4096).astype(np.float32) * 10.0 ** rng.randint(-6, 3, 4096))
    q = q.to(torch.bfloat16).double()
    for vals in (torch.arange(-128, 128).double(), torch.arange(16).double() - 7.5):
        exact = q[:, None] * vals[None, :]
        assert torch.equal(exact.float().double(), exact)

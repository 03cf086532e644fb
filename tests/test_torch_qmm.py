"""K6, the weight-only 4-bit matmul, and the weight quantizers of the port
held against the JAX package.

The plain version (what the wrapper runs on a CPU tensor) against JAX's
Pallas kernel run in interpret mode, as ``tests/test_pallas_qmm.py`` runs
it: linear int4 and NF4, 1, 4, 8, 17 and 32 rows (one to four of the CUDA
kernel's 8-row tensor-core tiles, a ragged one among them), the tilings
``supported`` accepts, and a ragged input dim through ``_dense``.
Tolerances: f32 x within 1e-5 relative (two f32 summation orders); bf16 x
within one bf16 ulp of the reference at each element, or the f32 rounding
bound where the sum is near zero
(``tests/test_torch_kernels.py::assert_int4_close``). The quantizers give
the reference's bytes. The kernel's launch plan (``qmm.plan``) at every
Llama-3-8B projection and 1-32 rows, and a numpy model of its in-register
decode of each byte into a bf16 pair, are checked here too; the kernel
itself runs only on the card (``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kirag_tpu.models import llm as jax_llm
from kirag_tpu.ops.pallas_qmm import int4_matmul as jax_int4_matmul
from kirag_tpu.ops.pallas_qmm import supported as jax_supported
from kirag_tpu_torch.kernels import int4_matmul, int4_matmul_plain, launch_counts
from kirag_tpu_torch.kernels import qmm
from kirag_tpu_torch.kernels.qmm import dequant_nibbles, plan, supported
from kirag_tpu_torch.models import llm

from tests.test_torch_kernels import assert_int4_close, int4_abs_sum

QUANTIZERS = {"int8": (jax_llm._quantize_kernel_int8, llm._quantize_kernel_int8),
              "int4": (jax_llm._quantize_kernel_int4, llm._quantize_kernel_int4),
              "nf4": (jax_llm._quantize_kernel_nf4, llm._quantize_kernel_nf4)}


def quantized(rng, in_dim, out_dim, fmt):
    k = (rng.randn(in_dim, out_dim) * 0.05).astype(np.float32)
    p = QUANTIZERS[fmt][0](k)
    return {name: np.array(v) for name, v in p.items()}  # writable copies


def port_args(p):
    cb = torch.from_numpy(p["kernel_cb4"]) if "kernel_cb4" in p else None
    return torch.from_numpy(p["kernel_q4"]), torch.from_numpy(p["kernel_scale4"]), cb


@pytest.mark.parametrize("fmt", ["int4", "nf4"])
@pytest.mark.parametrize("rows", [1, 4, 8, 17, 32])
@pytest.mark.parametrize("in_dim,out_dim", [(512, 512), (1024, 768), (512, 640)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_and_cpu_wrapper_match_jax_kernel(rng, fmt, rows, in_dim, out_dim, dtype):
    p = quantized(rng, in_dim, out_dim, fmt)
    x = rng.randn(rows, in_dim).astype(np.float32)
    want = np.asarray(jax_int4_matmul(jnp.asarray(x, getattr(jnp, dtype)), p["kernel_q4"],
                                      p["kernel_scale4"], codebook=p.get("kernel_cb4"),
                                      interpret=True)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    before = launch_counts()["int4_matmul"]
    got = int4_matmul(xt, *port_args(p))
    assert launch_counts()["int4_matmul"] == before  # the CPU runs the plain version
    assert torch.equal(got, int4_matmul_plain(xt, *port_args(p)))
    assert got.dtype == xt.dtype and got.shape == (rows, out_dim)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        assert_int4_close(got, torch.from_numpy(want), int4_abs_sum(xt, *port_args(p)))


def test_leading_dims_and_unsupported_tiling(rng):
    p = quantized(rng, 512, 512, "nf4")
    x = rng.randn(2, 3, 512).astype(np.float32)
    got = int4_matmul(torch.from_numpy(x), *port_args(p))
    want = np.asarray(jax_int4_matmul(jnp.asarray(x), p["kernel_q4"], p["kernel_scale4"],
                                      codebook=p["kernel_cb4"], interpret=True))
    assert got.shape == (2, 3, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    small = quantized(rng, 128, 512, "int4")  # half = 64: no tiling
    with pytest.raises(ValueError, match="unsupported tiling"):
        int4_matmul(torch.ones(4, 128), *port_args(small))
    with pytest.raises(ValueError, match="x last dim"):
        int4_matmul(torch.ones(4, 100), *port_args(p))


@pytest.mark.parametrize("half,out_dim", [(2048, 14336), (256, 128256), (96, 512), (256, 640),
                                          (7168, 4096), (64, 512), (512, 100)])
def test_supported_matches_jax(half, out_dim):
    assert supported(half, out_dim) == jax_supported(half, out_dim)


@pytest.mark.parametrize("fmt", ["int4", "nf4"])
@pytest.mark.parametrize("rows", [3, 48])
def test_dense_ragged_in_dim_and_row_dispatch(rng, fmt, rows):
    """in_dim 500 pads to the 512-row block grid; 3 rows take K6 ("kernel" /
    "pallas"), 48 rows the parity formulation, in both packages."""
    p = quantized(rng, 500, 512, fmt)
    x = rng.randn(rows, 500).astype(np.float32)
    want = np.asarray(jax_llm._dense(jnp.asarray(x), p, "pallas"))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = llm._dense(torch.from_numpy(x), tp, "kernel")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    for impl in ("parity", "blockdot"):
        want = np.asarray(jax_llm._dense(jnp.asarray(x), p, impl))
        got = llm._dense(torch.from_numpy(x), tp, impl)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=impl)


@pytest.mark.parametrize("fmt", ["int8", "int4", "nf4"])
@pytest.mark.parametrize("in_dim,out_dim", [(256, 96), (100, 40), (130, 300)])
def test_quantizers_give_the_reference_bytes(rng, monkeypatch, fmt, in_dim, out_dim):
    k = (rng.randn(in_dim, out_dim) * 0.05).astype(np.float32)
    k[:, 3] = 0.0                                       # an all-zero column: scale 1
    k[:64, 5] = 0.0                                     # an all-zero block
    monkeypatch.setattr(llm, "QUANT_COLUMNS", 64)      # several column chunks
    want = QUANTIZERS[fmt][0](k)
    got = QUANTIZERS[fmt][1](torch.from_numpy(k))
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        value = np.asarray(value)
        assert got[name].numpy().dtype == value.dtype, name
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)


def test_nf4_ties_at_the_midpoints_go_left():
    import ml_dtypes

    cb = llm.NF4_CODEBOOK.astype(ml_dtypes.bfloat16).astype(np.float32)
    mids = (cb[1:] + cb[:-1]) / 2.0
    col = np.concatenate([[1.0], mids, cb, np.zeros(64 - 1 - 15 - 16)]).astype(np.float32)
    k = np.stack([col, -col], axis=1)                  # absmax 1: normed == the values
    want = jax_llm._quantize_kernel_nf4(k)
    got = llm._quantize_kernel_nf4(torch.from_numpy(k))
    np.testing.assert_array_equal(got["kernel_q4"].numpy(), np.asarray(want["kernel_q4"]))


def test_unpack_and_quantize_params_match_jax(rng):
    p = quantized(rng, 256, 128, "int4")
    np.testing.assert_array_equal(
        llm._unpack_int4(torch.from_numpy(p["kernel_q4"]), torch.float32).numpy(),
        np.asarray(jax_llm._unpack_int4(jnp.asarray(p["kernel_q4"]), jnp.float32)))
    config = jax_llm.LlamaConfig(vocab_size=64, hidden_size=64, num_hidden_layers=1,
                                 num_attention_heads=2, num_key_value_heads=1,
                                 intermediate_size=128)
    import jax

    tree = jax.tree.map(np.asarray, jax_llm.init_llama_params(jax.random.PRNGKey(1), config))
    port = llm.llama_params_from_jax(tree, device="cpu")
    for bits, cb in ((8, "nf4"), (4, "nf4"), (4, "linear")):
        want = jax.tree.map(np.asarray, jax_llm.quantize_llama_params(tree, bits, cb))
        got = llm.quantize_llama_params(port, bits, cb)
        flat_want = jax.tree_util.tree_leaves_with_path(want)
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        assert [k for k, _ in flat_want] == [k for k, _ in flat_got]
        for (path, w), (_, g) in zip(flat_want, flat_got):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
    with pytest.raises(ValueError, match="bits"):
        llm.quantize_llama_params(port, 3)


# ------------------------------------------------ the CUDA kernel's launch plan

# Llama-3-8B's projections as [in/2, out] packed shapes
LLAMA3_8B = {"q_proj, o_proj": (2048, 4096), "k_proj, v_proj": (2048, 1024),
             "gate_proj, up_proj": (2048, 14336), "down_proj": (7168, 4096),
             "lm_head": (2048, 128256)}


def split_ranges(p):
    """The scale blocks whose sums each cluster rank holds (rank r: blocks
    r * steps .. (r + 1) * steps - 1), in the order the kernel adds them."""
    return [range(r * p.steps, (r + 1) * p.steps) for r in range(p.cluster)]


@pytest.mark.parametrize("nf4", [False, True])
@pytest.mark.parametrize("rows", range(1, 33))
@pytest.mark.parametrize("shape", sorted(LLAMA3_8B))
def test_plan_reads_each_weight_once_and_sums_each_block_once(shape, rows, nf4):
    """One block row holds all the rows (every weight byte is read once), the
    column tiles cover each output column once, the cluster ranks split the
    scale blocks into ranges that, in rank order, are each block once and in
    order, the cluster's ranks share a tile's columns evenly, and the grid
    and cluster are within the card's limits. The kernel takes the plan
    whole and refuses one that does not cover its call exactly."""
    half, out_dim = LLAMA3_8B[shape]
    p = plan(rows, half, out_dim, nf4)
    assert p == plan(rows, half, out_dim, nf4)                 # a pure function
    assert p.tiles == -(-rows // 8) and p.row_blocks == 1      # 8-row tiles, one block row
    assert p.col_blocks * qmm.TILE_COLS == out_dim
    ranges = split_ranges(p)
    assert [s for r in ranges for s in r] == list(range(half // qmm.SUB))
    assert all(len(r) == p.steps > 0 for r in ranges)
    assert p.cluster in (1, 2, 4, 8, 16) and p.cluster <= qmm.MAX_CLUSTER
    assert qmm.TILE_COLS % p.cluster == 0                      # each rank's share of columns
    gx, gy, gz = p.grid
    assert (gx, gy, gz) == (out_dim // qmm.TILE_COLS, p.cluster, 1)
    assert gx < 2 ** 31 and gy <= 65535 and gz <= 65535


@pytest.mark.parametrize("rows,tiles,row_blocks", [(33, 4, 2), (64, 4, 2), (65, 4, 3)])
def test_plan_past_32_rows_and_refusals(rows, tiles, row_blocks):
    p = plan(rows, 2048, 4096, False)
    assert (p.tiles, p.row_blocks) == (tiles, row_blocks)
    assert [s for r in split_ranges(p) for s in r] == list(range(64))
    for bad in ((0, 2048, 4096), (4, 2040, 4096), (4, 2048, 4000), (4, 0, 4096)):
        with pytest.raises(ValueError, match="no plan"):
            plan(*bad, False)


# ---------------------------------------- a numpy model of the kernel's decode

def prmt(a, b, sel):
    """PTX prmt.b32 in its default mode: a selector nibble below 8 copies
    that byte of {b, a}; one of 8 or more fills the byte with that byte's
    sign."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = 0
    for i in range(4):
        n = (sel >> (4 * i)) & 0xF
        byte = src[n & 7]
        if n & 8:
            byte = 0xFF if byte & 0x80 else 0
        out |= byte << (8 * i)
    return out


def bf16_pair(r):
    return np.array([r & 0xFFFF, r >> 16], np.uint32).view(np.uint32) << 16


def decode_word(w, codebook=None):
    """``decode_word`` of csrc/int4_matmul.cu, step by step: the four bytes
    of w as four bf16x2 words (low nibble in the low half)."""
    if codebook is None:
        lo = (w & 0x0F0F0F0F) ^ 0x08080808
        hi = ((w >> 4) & 0x0F0F0F0F) ^ 0x08080808
        pq = [prmt(lo, hi, 0x5140), prmt(lo, hi, 0x7362)]
        words = [prmt(pq[k >> 1], 0x43434343, 0x4342 if k & 1 else 0x4140) for k in range(4)]
        # then v * 1 - 136 in bf16x2 (exact): returned as f32 pairs
        return [bf16_pair(v).view(np.float32) - 136.0 for v in words]
    bits = torch.tensor(codebook, dtype=torch.float32).to(torch.bfloat16).view(torch.int16)
    bits = bits.numpy().astype(np.uint16).astype(np.uint32)
    lo_t = [sum(int(bits[4 * k + b] & 0xFF) << (8 * b) for b in range(4)) for k in range(4)]
    hi_t = [sum(int(bits[4 * k + b] >> 8) << (8 * b) for b in range(4)) for k in range(4)]
    pick = ((w >> 1) & 0x44444444) | 0x32103210
    wx = w ^ 0x88888888
    words = []
    for h in range(2):
        s, sx, p = w >> (16 * h), wx >> (16 * h), pick >> (16 * h)
        lo = prmt(prmt(lo_t[0], lo_t[1], s), prmt(lo_t[2], lo_t[3], sx), p)
        hi = prmt(prmt(hi_t[0], hi_t[1], s), prmt(hi_t[2], hi_t[3], sx), p)
        words += [prmt(lo, hi, 0x5140), prmt(lo, hi, 0x7362)]
    return [bf16_pair(v).view(np.float32) for v in words]


@pytest.mark.parametrize("codebook", ["linear", "nf4", "random"])
def test_decode_model_matches_dequant_nibbles_on_every_byte(rng, codebook):
    cb = {"linear": None, "nf4": llm.NF4_CODEBOOK,
          "random": rng.randn(16).astype(np.float32)}[codebook]
    packed = torch.arange(256, dtype=torch.uint8).reshape(1, 256)
    want_lo, want_hi = dequant_nibbles(packed, None if cb is None else torch.from_numpy(
        np.asarray(cb, np.float32)))
    for b0 in range(0, 256, 4):
        w = b0 | (b0 + 1) << 8 | (b0 + 2) << 16 | (b0 + 3) << 24
        for k, pair in enumerate(decode_word(w, None if cb is None else list(cb))):
            assert pair[0] == float(want_lo[0, b0 + k]), (b0 + k, "low nibble")
            assert pair[1] == float(want_hi[0, b0 + k]), (b0 + k, "high nibble")

"""K6, the weight-only 4-bit matmul, and the weight quantizers of the port
held against the JAX package.

The plain version (what the wrapper runs on a CPU tensor) against JAX's
Pallas kernel run in interpret mode, as ``tests/test_pallas_qmm.py`` runs
it: linear int4 and NF4, 1, 4 and 32 rows, the tilings ``supported``
accepts, and a ragged input dim through ``_dense``. Tolerances: f32 x within
1e-5 relative (two f32 summation orders); bf16 x within one bf16 ulp of the
reference at each element, or the f32 rounding bound where the sum is near
zero (``tests/test_torch_kernels.py::assert_int4_close``). The quantizers
give the reference's bytes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kirag_tpu.models import llm as jax_llm
from kirag_tpu.ops.pallas_qmm import int4_matmul as jax_int4_matmul
from kirag_tpu.ops.pallas_qmm import supported as jax_supported
from kirag_tpu_torch.kernels import int4_matmul, int4_matmul_plain, launch_counts
from kirag_tpu_torch.kernels.qmm import supported
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
@pytest.mark.parametrize("rows", [1, 4, 32])
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

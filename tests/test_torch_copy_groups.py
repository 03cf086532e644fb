"""K7b and K8, the selected-group copies, held against the JAX package.

``score_gather_plain`` (K7b) against JAX's ``_score_gather_kernel``, its
``pallas_call`` built here as ``pallas_exact.exact_topk_mips`` builds it for
``impl="single"``, and ``cap_assemble_plain`` (K8) against
``pallas_exact._cap_assemble``, both in interpret mode on the CPU, on the
same seeded numpy inputs: several chunks, ``per`` = 1, 2 and 16 groups a
chunk row, k not a multiple of 8, int32 and int64 indices on the port's side
with negative and past-the-end ones among them. The reference's one-hot
products at HIGHEST precision add one finite f32 value to zeros, so they
are exact copies: the copied groups compare bitwise. Where an index lies
outside the source both give zeros, equal as values: the reference's are
sums of 0 x s and take the sign of the source's values, the port's are
+0. Then the CUDA wrapper against a stand-in for the kernel library (the
indices' own pointer, width and strides reach the kernel, with
``copy_plan``'s cut and no cast or copy), and ``copy_plan`` itself.
"""

import contextlib
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kirag_tpu.ops import pallas_exact as pe
from kirag_tpu_torch.kernels import cap_assemble_plain, launch_counts, score_gather_plain
from kirag_tpu_torch.kernels import exact as kx

LANES = 128
# (chunks, queries, groups a chunk row, k): k = 13, 33, 5, 21 (not multiples of 8)
SHAPES = [(3, 5, 1, 13), (4, 3, 2, 33), (2, 7, 16, 21), (5, 2, 16, 5)]


def jax_score_gather(scores, gsel):
    """JAX's K7b: ``_score_gather_kernel`` under the ``pallas_call`` of
    ``pallas_exact.exact_topk_mips`` (impl="single"), interpreted."""
    n_c, n_q, chunk = scores.shape
    k = gsel.shape[1]
    return pl.pallas_call(
        functools.partial(pe._score_gather_kernel, groups_per_chunk=chunk // LANES, k=k),
        grid=(n_c,),
        in_specs=[pl.BlockSpec((1, n_q, chunk), lambda i: (i, 0, 0)),
                  pl.BlockSpec((n_q, k), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((n_q, k, LANES), lambda i: (0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n_q, k, LANES), jnp.float32),
        interpret=True,
    )(scores, gsel)


def inputs(n_c, n_q, per, k, seed):
    """A seeded f32 source [C, Q, per * 128] and [Q, k] indices in
    [-3, C * per + 3): some before the first group, some past the last."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((n_c, n_q, per * LANES)).astype(np.float32)
    idx = rng.integers(-3, n_c * per + 3, size=(n_q, k)).astype(np.int32)
    idx[0, :2] = (-1, n_c * per)  # one of each in every case
    return src, idx


def assert_bitwise(got: torch.Tensor, want, idx, n_groups: int) -> None:
    """The copied groups bitwise; zeros (either sign) for an index outside
    [0, n_groups)."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    inside = (idx >= 0) & (idx < n_groups)
    assert np.array_equal(got[inside].view(np.uint32), want[inside].view(np.uint32))
    assert not got[~inside].any() and not want[~inside].any()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_c,n_q,per,k", SHAPES)
def test_score_gather_plain_is_jax_score_gather_kernel(n_c, n_q, per, k, dtype):
    src, idx = inputs(n_c, n_q, per, k, seed=n_c * 100 + per)
    want = jax_score_gather(jnp.asarray(src), jnp.asarray(idx))
    got = score_gather_plain(torch.from_numpy(src), torch.from_numpy(idx).to(dtype))
    assert_bitwise(got, want, idx, n_c * per)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_c,n_q,per,k", SHAPES)
def test_cap_assemble_plain_is_jax_cap_assemble(n_c, n_q, per, k, dtype):
    src, idx = inputs(n_c, n_q, per, k, seed=n_c * 100 + per + 1)
    want = pe._cap_assemble(jnp.asarray(idx), jnp.asarray(src), n_c, per, k, n_q,
                            interpret=True)
    got = cap_assemble_plain(torch.from_numpy(idx).to(dtype), torch.from_numpy(src), per)
    assert_bitwise(got, want, idx, n_c * per)


def test_plain_copies_read_transposed_and_sliced_indices():
    """The layouts the searches hand over (a sort's top-k slice, capdom's
    column-major positions) copy as their contiguous values do."""
    src, idx = inputs(4, 6, 2, 17, seed=5)
    want = jax_score_gather(jnp.asarray(src), jnp.asarray(idx))
    wide = torch.from_numpy(np.concatenate([idx, idx], axis=1)).long()
    for view in (wide[:, :17], torch.from_numpy(idx).long().T.contiguous().T):
        assert_bitwise(score_gather_plain(torch.from_numpy(src), view), want, idx, 8)
        assert_bitwise(cap_assemble_plain(view, torch.from_numpy(src), 2), want, idx, 8)


class StubLibrary:
    """Stands in for ``load_library()``: records each entry point's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("kirag_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def stub_library(monkeypatch):
    """The copy wrapper's launch path on CPU tensors: the library stubbed,
    the CUDA device and stream calls made inert, and every tensor method
    that would cast or copy the indices made to fail."""
    lib = StubLibrary()
    monkeypatch.setattr(kx, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))

    def refuse(*args, **kwargs):
        raise AssertionError("the copy wrapper cast or copied its indices")

    for method in ("to", "contiguous", "clone", "int", "long", "type"):
        monkeypatch.setattr(torch.Tensor, method, refuse)
    return lib


@pytest.mark.parametrize("entry,name", [("kirag_score_gather", "score_gather"),
                                        ("kirag_cap_assemble", "cap_assemble")])
@pytest.mark.parametrize("dtype,layout", [(torch.int64, "contiguous"),
                                          (torch.int32, "contiguous"), (torch.int64, "rows"),
                                          (torch.int64, "transposed")])
def test_copy_wrapper_passes_the_indices_as_given_and_copy_plans_cut(stub_library, entry,
                                                                     name, dtype, layout):
    n_c, n_q, per, k = 62, 32, 8, 100
    src = torch.zeros(n_c, n_q, per * LANES)
    idx = {"contiguous": torch.arange(n_q * k, dtype=dtype).view(n_q, k),
           "rows": torch.arange(n_q * 2 * k, dtype=dtype).view(n_q, 2 * k)[:, :k],
           "transposed": torch.arange(n_q * k, dtype=dtype).view(k, n_q).T}[layout]
    before = launch_counts()[name]
    out = kx._copy_groups(src, idx, per, name, entry)
    assert out.shape == (n_q, k, LANES) and out.dtype == torch.float32
    assert launch_counts()[name] == before + 1
    (called, args), = stub_library.calls
    plan = kx.copy_plan(n_q, k)
    assert called == entry
    assert args[:5] == (src.data_ptr(), idx.data_ptr(), idx.element_size(), *idx.stride())
    assert args[2] == {torch.int32: 4, torch.int64: 8}[dtype]
    assert args[5] == out.data_ptr()
    assert args[6:10] == (n_c, n_q, k, per)
    assert args[10:12] == dataclasses.astuple(plan)
    assert args[12] == 0  # the current stream


def test_copy_wrapper_refuses_a_misaligned_source(stub_library):
    src = torch.zeros(4 * 128 + 1)[1:].view(1, 4, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kx._copy_groups(src, torch.zeros(4, 3, dtype=torch.int64), 1, "score_gather",
                        "kirag_score_gather")
    assert not stub_library.calls


SMS = 132


@pytest.mark.parametrize("k", [1, 3, 10, 99, 100, 1000])
@pytest.mark.parametrize("n_q", [1, 2, 7, 8, 31, 32, 100, 256])
def test_copy_plan_covers_the_call_and_fills_the_card(n_q, k):
    """Every pair copied once, one a warp, and no block empty (what the
    kernel checks); the most warps a block that still give every SM a
    block where there are enough pairs."""
    p = kx.copy_plan(n_q, k, SMS)
    pairs, wpb = n_q * k, p.warps_per_block
    assert wpb in kx.COPY_WARPS_PER_BLOCK
    assert (p.blocks - 1) * wpb < pairs <= p.blocks * wpb
    assert p.blocks >= min(SMS, pairs)
    larger = [w for w in kx.COPY_WARPS_PER_BLOCK if w > wpb]
    assert all(-(-pairs // w) < SMS for w in larger)


def test_copy_plan_at_the_smokes_shapes():
    """Q = 8 (800 pairs) spreads over every SM in blocks of 4 warps; Q = 32
    and 256 take the most warps a block; one query's 100 pairs go a warp a
    block."""
    assert kx.copy_plan(8, 100, SMS) == kx.CopyPlan(4, 200)
    assert kx.copy_plan(32, 100, SMS) == kx.CopyPlan(8, 400)
    assert kx.copy_plan(256, 100, SMS) == kx.CopyPlan(8, 3200)
    assert kx.copy_plan(1, 100, SMS) == kx.CopyPlan(1, 100)
    with pytest.raises(ValueError, match="no copy plan"):
        kx.copy_plan(0, 100)

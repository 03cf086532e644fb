"""K3's gradient: the flash attention ``torch.autograd.Function`` and its two
backward kernels' plain version, held against the JAX package.

JAX's Pallas TPU flash attention is a ``jax.custom_vjp`` whose backward runs
two more kernels (dK/dV and dQ); under ``pltpu.force_tpu_interpret_mode()``
``jax.grad`` runs them interpreted here (a few seconds a call, so few calls).
Same numpy inputs through both, f32, atol = rtol = 1e-5 (sums of a few
hundred unit-scale f32 products taken in different orders). On the CPU the
port's wrappers run their plain versions; the kernels against the plain
version are held on the card by ``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jax_fa

from kirag_tpu.models.bert import BertConfig as JaxBertConfig
from kirag_tpu.models.bert import _flash_attention as jax_flash_layer
from kirag_tpu_torch.kernels import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_attention_reference,
    launch_counts,
    reset_launch_counts,
)
from kirag_tpu_torch.models import BertConfig, BertModel, bert_encode
from kirag_tpu_torch.models import bert as port_bert

from tests.test_torch_flash import CFG, layer_params, port_model, segments
from tests.test_torch_kernels import BWD_LAYOUTS, bwd_segments

TOL = dict(atol=1e-5, rtol=1e-5)
SCALE = 0.125


def jax_block_sizes(t):
    """The forward and backward blocks ``kirag_tpu.models.bert`` passes."""
    return jax_fa.BlockSizes(
        block_q=t, block_k_major=t, block_k=t, block_b=1, block_q_major_dkv=t,
        block_k_major_dkv=t, block_k_dkv=t, block_q_dkv=t, block_k_major_dq=t,
        block_k_dq=t, block_q_dq=t)


@pytest.mark.parametrize("t,kind", [(128, "padded"), (256, "packed"), (128, "fully_padded")])
def test_backward_matches_jax_pallas_kernels(rng, t, kind):
    """dq, dk, dv of sum(out * w): jax.grad through the Pallas dK/dV and dQ
    kernels against the port's Function (CPU: plain forward returning lse,
    plain backward) and against flash_attention_bwd_plain called directly."""
    q, k, v, w = (rng.randn(2, 2, t, 64).astype(np.float32) for _ in range(4))
    seg = segments(kind, t)

    def loss(q, k, v):
        out = jax_fa.flash_attention(
            q, k, v, segment_ids=jax_fa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)),
            sm_scale=SCALE, block_sizes=jax_block_sizes(t))
        return jnp.sum(out * w)

    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tseg, tw = torch.from_numpy(seg), torch.from_numpy(w)
    reset_launch_counts()
    out = flash_attention(tq, tk, tv, tseg, SCALE)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(torch.sum(out * tw), (tq, tk, tv))
    assert sum(launch_counts().values()) == 0  # CPU tensors: the plain versions
    for g, ref in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), ref, **TOL)

    with torch.no_grad():
        o, lse = flash_attention_plain(tq, tk, tv, tseg, SCALE, return_lse=True)
        direct = flash_attention_bwd_plain(tq, tk, tv, tseg, o, lse, tw, SCALE)
    for g, d in zip(got, direct):
        np.testing.assert_array_equal(g.numpy(), d.numpy())


def kept_tile_pairs(seg: torch.Tensor) -> torch.Tensor:
    """[B, T, T] bool: whether the bf16 backward kernels compute the pair
    (query i, key j), by their tile skip: each 64-row tile's smallest and
    largest segment id, and a (query tile, key tile) pair kept where the two
    ranges overlap."""
    b, t = seg.shape
    tiles = seg.view(b, t // 64, 64)
    lo, hi = tiles.amin(-1), tiles.amax(-1)
    meet = (lo[:, :, None] <= hi[:, None, :]) & (lo[:, None, :] <= hi[:, :, None])
    return meet.repeat_interleave(64, dim=1).repeat_interleave(64, dim=2)


def plain_backward_on_kept_tiles(q, k, v, seg, out, lse, do, sm_scale):
    """flash_attention_bwd_plain's formulas with P (and so dS) formed only
    on the kept tile pairs: what the kernels compute when they skip."""
    f32 = torch.float32
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), k.to(f32)) * sm_scale
    same = (seg[:, None, :, None] == seg[:, None, None, :]) & kept_tile_pairs(seg)[:, None]
    p = torch.where(same, torch.exp(logits - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(f32), v.to(f32))
    di = torch.sum(out.to(f32) * do.to(f32), dim=-1)
    ds = p * (dp - di[..., None]) * sm_scale
    p, ds = p.to(q.dtype).to(f32), ds.to(q.dtype).to(f32)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.to(f32))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(f32))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(f32))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@pytest.mark.parametrize("layout", BWD_LAYOUTS)
def test_tile_skip_drops_no_same_segment_pair(rng, layout):
    """The bf16 kernels' segment tile skip is exact: the plain backward on
    the kept tile pairs alone equals the plain backward bit for bit (every
    pair it drops has P = dS = 0), and JAX's Pallas dK/dV and dQ kernels
    within TOL, on right-padded, all-padding, tile-edge packed, non-monotonic
    (1, 2, 1 across tiles) and all-real segment rows at T = 256."""
    b, t = 4, 256
    seg = bwd_segments(layout, b, t, "cpu")
    kept = kept_tile_pairs(seg)
    skips = layout in ("padded", "packed_on_edges", "non_monotonic")
    assert bool((~kept).any()) == skips  # the layouts that exercise the skip do skip
    q, k, v, w = (rng.randn(b, 1, t, 64).astype(np.float32) for _ in range(4))
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    o, lse = flash_attention_plain(tq, tk, tv, seg, SCALE, return_lse=True)
    want = flash_attention_bwd_plain(tq, tk, tv, seg, o, lse, tw, SCALE)
    got = plain_backward_on_kept_tiles(tq, tk, tv, seg, o, lse, tw, SCALE)
    for g, x in zip(got, want):
        assert torch.equal(g, x)

    def loss(q, k, v):
        out = jax_fa.flash_attention(
            q, k, v, segment_ids=jax_fa.SegmentIds(q=jnp.asarray(seg.numpy()),
                                                   kv=jnp.asarray(seg.numpy())),
            sm_scale=SCALE, block_sizes=jax_block_sizes(t))
        return jnp.sum(out * w)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def plain_forward_on_kept_tiles(q, k, v, seg, sm_scale):
    """flash_attention_plain's formulas with the logits formed only on the
    kept tile pairs (every other one -inf): what the forward kernels compute
    when they skip. Returns (out, lse)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k.to(torch.float32))
    same = (seg[:, None, :, None] == seg[:, None, None, :]) & kept_tile_pairs(seg)[:, None]
    logits = torch.where(same, logits * sm_scale, float("-inf"))
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1).to(v.dtype), v)
    return out, torch.logsumexp(logits, dim=-1)


@pytest.mark.parametrize("layout", BWD_LAYOUTS)
def test_forward_tile_skip_drops_no_same_segment_pair(rng, layout):
    """The forward kernels' segment tile skip is exact: the plain forward on
    the kept (64-query tile, 64-key tile) pairs alone equals the plain
    forward bit for bit in out and lse (a skipped tile's logits are all
    -inf), and both match JAX's Pallas forward (interpret mode; lse against
    its saved m + log(l)) within TOL, on the same five segment layouts at
    T = 256. The f32 kernel's 128-query blocks keep a superset of these
    pairs."""
    b, t = 4, 256
    seg = bwd_segments(layout, b, t, "cpu")
    q, k, v = (rng.randn(b, 1, t, 64).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want, want_lse = flash_attention_plain(tq, tk, tv, seg, SCALE, return_lse=True)
    got, got_lse = plain_forward_on_kept_tiles(tq, tk, tv, seg, SCALE)
    assert torch.equal(got, want) and torch.equal(got_lse, want_lse)

    with pltpu.force_tpu_interpret_mode():
        ref, l, m = jax_fa._flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
            jax_fa.SegmentIds(q=jnp.asarray(seg.numpy()), kv=jnp.asarray(seg.numpy())), True,
            False, SCALE, jax_block_sizes(t), False)
    ref_lse = np.asarray(m) + np.log(np.asarray(l))
    for x in (got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(ref), **TOL)
    for x in (got_lse, want_lse):
        np.testing.assert_allclose(x.numpy(), ref_lse, **TOL)


def test_lse_is_the_log_of_the_reference_softmax_sums(rng):
    """lse = m + log(l) of JAX's saved residuals, pad rows included (they
    attend among pads and are finite)."""
    t = 128
    q, k, v = (rng.randn(2, 2, t, 64).astype(np.float32) for _ in range(3))
    seg = segments("fully_padded", t)
    with pltpu.force_tpu_interpret_mode():
        _, l, m = jax_fa._flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
            jax_fa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)), True, False, SCALE,
            jax_block_sizes(t), False)
    want = np.asarray(m) + np.log(np.asarray(l))
    _, lse = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, seg)), SCALE,
                                   return_lse=True)
    assert np.isfinite(lse.numpy()).all()
    np.testing.assert_allclose(lse.numpy(), want, **TOL)


def test_attention_layer_gradients_match_jax(rng):
    """jax.grad of kirag_tpu.models.bert._flash_attention (the Pallas kernels
    interpreted) against the port's Attention layer through the Function:
    dx and every parameter of the layer."""
    t = 128
    params = layer_params(seed=5)
    att = params["layers"][0]["attention"]
    x = rng.randn(2, t, CFG["hidden_size"]).astype(np.float32)
    w = rng.randn(2, t, CFG["hidden_size"]).astype(np.float32)
    seg = segments("packed", t)

    def loss(x, p):
        return jnp.sum(jax_flash_layer(x, jnp.asarray(seg), p, JaxBertConfig(**CFG)) * w)

    with pltpu.force_tpu_interpret_mode():
        dx, dp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                jax.tree.map(jnp.asarray, att))
    layer = port_model(params).layers[0].attention
    tx = torch.from_numpy(x).requires_grad_()
    out = layer(tx, None, torch.from_numpy(seg), "flash")
    torch.sum(out * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), **TOL)
    h = CFG["hidden_size"]
    for j, name in enumerate(("query", "key", "value")):  # rows of the fused qkv
        np.testing.assert_allclose(layer.qkv.weight.grad[j * h:(j + 1) * h].numpy().T,
                                   np.asarray(dp[name]["kernel"]), **TOL)
        np.testing.assert_allclose(layer.qkv.bias.grad[j * h:(j + 1) * h].numpy(),
                                   np.asarray(dp[name]["bias"]), **TOL)
    np.testing.assert_allclose(layer.output.weight.grad.numpy().T,
                               np.asarray(dp["output"]["kernel"]), **TOL)
    np.testing.assert_allclose(layer.output.bias.grad.numpy(),
                               np.asarray(dp["output"]["bias"]), **TOL)


def test_flash_path_gradients_equal_autograd_of_the_plain_forward(rng, monkeypatch):
    """The lost-gradient repair: with the encoder forced onto the flash path,
    a loss's gradients go through the Function (the kernels on the card, the
    plain backward here) and equal autograd through the plain forward. The
    forward used to be a bare kernel call, whose output had no grad_fn on the
    card, so attention carried no gradient there."""
    monkeypatch.setattr(port_bert, "_resolve_attention_impl", lambda *args: "flash")
    cfg = BertConfig(**CFG)
    mask = segments("padded", 128)
    ids = torch.from_numpy(np.where(mask > 0, rng.randint(1, CFG["vocab_size"], mask.shape), 0))
    mask = torch.from_numpy(mask).long()

    def grads():
        torch.manual_seed(0)
        model = BertModel(cfg)
        hidden = bert_encode(model, ids, mask)
        torch.sum(hidden * torch.linspace(-1, 1, CFG["hidden_size"])).backward()
        return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    through_function = grads()
    monkeypatch.setattr(port_bert, "flash_attention", flash_attention_plain)
    through_autograd = grads()
    assert through_function.keys() == through_autograd.keys()
    assert "layers.0.attention.qkv.weight" in through_function
    for name, g in through_autograd.items():
        np.testing.assert_allclose(through_function[name].numpy(), g.numpy(), **TOL,
                                   err_msg=name)


def test_reference_function_runs_the_plain_formulas(rng):
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 64, 64).astype(np.float32)).requires_grad_()
               for _ in range(3))
    seg = torch.ones(1, 64, dtype=torch.int32)
    a = torch.autograd.grad(flash_attention(q, k, v, seg, SCALE).sum(), (q, k, v))
    b = torch.autograd.grad(flash_attention_reference(q, k, v, seg, SCALE).sum(), (q, k, v))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_backward_wrappers_check_their_operands():
    q = torch.zeros(1, 2, 128, 64)
    seg = torch.ones(1, 128, dtype=torch.int32)
    lse = di = torch.zeros(1, 2, 128)
    with pytest.raises(ValueError, match="dout must match q"):
        flash_attention_bwd(q, q, q, seg, q, lse, q[..., :32], SCALE)
    with pytest.raises(ValueError, match="dout must match q"):
        flash_attention_bwd_dq(q, q, q, seg, lse, di, q.double(), SCALE)
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_attention_bwd(q, q, q, seg, q, lse[:, :1], q, SCALE)
    with pytest.raises(ValueError, match="di must be float32"):
        flash_attention_bwd_dkv(q, q, q, seg, lse, di.double(), q, SCALE)
    with pytest.raises(TypeError, match="float32"):
        flash_attention_bwd_dkv(q.half(), q.half(), q.half(), seg, lse, di, q.half(), SCALE)
    with pytest.raises(ValueError, match="segment_ids"):
        flash_attention_bwd_dq(q, q, q, seg[:, :64], lse, di, q, SCALE)
    with pytest.raises(ValueError, match="different devices"):
        flash_attention_bwd_dkv(q, q, q, seg, lse, di.to("meta"), q, SCALE)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_bwd_dq(meta, meta, meta, seg.to("meta"), lse.to("meta"),
                               di.to("meta"), meta, SCALE)

"""K3, the encoder's flash attention, held against the JAX package.

On the CPU the port's ``flash_attention`` wrapper runs its plain version;
JAX's Pallas TPU flash attention runs under
``pltpu.force_tpu_interpret_mode()`` (about 1 s a call here, so few calls).
Same numpy inputs and parameters through both, f32; tolerance atol = rtol =
1e-5 (sums of a few hundred unit-scale f32 products taken in different
orders). The whole encoder's flash path is held against the reference's
segment-id XLA path, which ``kirag_tpu.models.bert.bert_encode`` names as the
flash path's equivalent (a whole interpret-mode encoder takes minutes).
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
from kirag_tpu.models.bert import bert_encode as jax_bert_encode
from kirag_tpu.models.bert import init_bert_params
from kirag_tpu.models.encoders import Encoder as JaxEncoder
from kirag_tpu_torch.kernels import (
    flash_attention,
    flash_attention_plain,
    launch_counts,
    reset_launch_counts,
)
from kirag_tpu_torch.models import BertConfig, BertModel, Encoder, bert_encode, params_from_jax
from kirag_tpu_torch.models.bert import _resolve_attention_impl

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = dict(vocab_size=96, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
           intermediate_size=256, max_position_embeddings=512)


def segments(kind: str, t: int) -> np.ndarray:
    """[2, t] segment ids: right-padded masks (0 = padding), a row that is all
    padding, or several documents packed into a row."""
    seg = np.ones((2, t), np.int32)
    if kind == "padded":
        seg[0, t - 37:] = 0
        seg[1, t // 3:] = 0
    elif kind == "fully_padded":
        seg[0, 90:] = 0
        seg[1] = 0
    elif kind == "packed":  # documents cut across the 64-key tiles
        seg[0] = np.repeat([1, 2, 3, 0], [50, 30, t - 100, 20])
        seg[1] = np.repeat([4, 5, 0], [70, t - 75, 5])
    return seg


def layer_params(seed: int):
    """Random parameters of the JAX layout, the attention weights scaled up
    so that the softmax is far from uniform and the mask matters."""
    params = init_bert_params(jax.random.key(seed), JaxBertConfig(**CFG))
    rng = np.random.RandomState(seed + 1)

    def perturb(path, x):
        x = np.asarray(x) + 0.02 * rng.randn(*np.shape(x)).astype(np.float32)
        if any(getattr(p, "key", None) in ("query", "key") for p in path):
            x = 8.0 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, params)


def port_model(params) -> BertModel:
    model = BertModel(BertConfig(**CFG))
    model.load_state_dict(params_from_jax(params, BertConfig(**CFG)))
    return model


@pytest.mark.parametrize("t,kind", [(128, "padded"), (256, "padded"),
                                    (128, "fully_padded"), (256, "packed")])
def test_attention_layer_matches_jax_flash_kernel(rng, t, kind):
    params = layer_params(seed=t)
    x = rng.randn(2, t, CFG["hidden_size"]).astype(np.float32)
    seg = segments(kind, t)
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash_layer(jnp.asarray(x), jnp.asarray(seg),
                               jax.tree.map(jnp.asarray, params["layers"][0]["attention"]),
                               JaxBertConfig(**CFG))
        want = np.asarray(want)
    model = port_model(params)
    reset_launch_counts()
    with torch.no_grad():
        got = model.layers[0].attention(torch.from_numpy(x), None, torch.from_numpy(seg),
                                        "flash")
    assert launch_counts()["flash_attention"] == 0  # CPU tensors: the plain version
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t,kind", [(128, "padded"), (256, "packed")])
def test_plain_version_matches_jax_flash_attention(rng, t, kind):
    q, k, v = (2.0 * rng.randn(2, 2, t, 64).astype(np.float32) for _ in range(3))
    seg = segments(kind, t)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            segment_ids=jax_fa.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)),
            sm_scale=0.125))
    args = [torch.from_numpy(a) for a in (q, k, v, seg)]
    np.testing.assert_allclose(flash_attention_plain(*args, 0.125).numpy(), want, **TOL)
    np.testing.assert_array_equal(flash_attention(*args, 0.125).numpy(),
                                  flash_attention_plain(*args, 0.125).numpy())


def test_wrapper_checks_its_operands():
    q = torch.zeros(1, 2, 128, 64)
    seg = torch.ones(1, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="one \\[B, H, T, D\\] shape"):
        flash_attention(q, q[:, :1], q, seg, 0.125)
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q.half(), q.half(), q.half(), seg, 0.125)
    with pytest.raises(ValueError, match="segment_ids"):
        flash_attention(q, q, q, seg[:, :64], 0.125)
    meta = torch.zeros(1, 2, 128, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(meta, meta, meta, seg.to("meta"), 0.125)


def test_auto_takes_flash_on_the_card_for_lane_aligned_lengths():
    cfg = BertConfig(**CFG)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert _resolve_attention_impl("auto", cuda, 384, cfg) == "flash"
    assert _resolve_attention_impl("auto", cuda, 64, cfg) == "xla"
    assert _resolve_attention_impl("auto", cpu, 512, cfg) == "xla"
    assert _resolve_attention_impl("auto", cuda, 512,
                                   BertConfig(hidden_size=128, num_attention_heads=4)) == "xla"
    assert _resolve_attention_impl("flash", cpu, 100, cfg) == "flash"
    with pytest.raises(KeyError):
        _resolve_attention_impl("pallas", cpu, 128, cfg)


def token_batch(rng, t):
    mask = segments("padded", t)
    mask = np.concatenate([mask, np.ones((1, t), np.int32)])
    ids = np.where(mask > 0, rng.randint(1, CFG["vocab_size"], mask.shape), 0).astype(np.int32)
    return ids, mask


def test_encoder_flash_path_matches_jax_segment_path(rng):
    params = layer_params(seed=11)
    ids, mask = token_batch(rng, 128)
    want = jax_bert_encode(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                           jnp.asarray(mask), JaxBertConfig(**CFG), attention_impl="xla",
                           segment_ids=jnp.asarray(mask))
    model = port_model(params)
    with torch.no_grad():
        got = bert_encode(model, torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                          attention_impl="flash")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jax_pooled = JaxEncoder(jax.tree.map(jnp.asarray, params), JaxBertConfig(**CFG), "e5",
                            attention_impl="xla")(ids, mask)
    port_pooled = Encoder.from_jax(params, BertConfig(**CFG), "e5", device="cpu",
                                   attention_impl="flash")(ids, mask)
    np.testing.assert_allclose(port_pooled.numpy(), np.asarray(jax_pooled), **TOL)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_packed_documents_match_jax(rng, impl):
    """Three documents packed into one row: positions restart per document
    and attention stays inside each."""
    params = layer_params(seed=12)
    t = 128
    seg = np.repeat([1, 2, 3, 0], [40, 50, 30, 8])[None].astype(np.int32)
    pos = np.concatenate([np.arange(n) for n in (40, 50, 30, 8)])[None].astype(np.int32)
    ids = np.where(seg > 0, rng.randint(1, CFG["vocab_size"], (1, t)), 0).astype(np.int32)
    mask = (seg > 0).astype(np.int32)
    want = jax_bert_encode(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                           jnp.asarray(mask), JaxBertConfig(**CFG), attention_impl="xla",
                           position_ids=jnp.asarray(pos), segment_ids=jnp.asarray(seg))
    model = port_model(params)
    ids, mask, pos, seg = (torch.from_numpy(a).long() for a in (ids, mask, pos, seg))
    with torch.no_grad():
        got = bert_encode(model, ids, mask, attention_impl=impl, position_ids=pos,
                          segment_ids=seg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

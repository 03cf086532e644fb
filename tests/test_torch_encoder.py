"""The port's encoder held against the JAX package.

Same numpy parameters and token ids through ``kirag_tpu`` (plain einsum
attention, f32, conftest pins JAX matmuls to "highest") and
``kirag_tpu_torch`` (f32, the CPU). Tolerance: atol = rtol = 1e-5 on
activations of unit scale, a few hundred f32 ulps for sums taken in
different orders through 2 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kirag_tpu.models.bert import BertConfig as JaxBertConfig
from kirag_tpu.models.bert import bert_encode as jax_bert_encode
from kirag_tpu.models.bert import init_bert_params
from kirag_tpu.models.encoders import Encoder as JaxEncoder
from kirag_tpu.ops import pooling as jax_pooling
from kirag_tpu_torch.models import BertConfig, BertModel, Encoder, bert_encode, params_from_jax
from kirag_tpu_torch.ops import pooling

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(vocab_size=120, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, max_position_embeddings=64)


def jax_params(cfg, seed=0):
    params = init_bert_params(jax.random.key(seed), JaxBertConfig(**cfg))
    # random LayerNorm affine and biases too, so that no term is trivially 0/1
    rng = np.random.RandomState(seed + 1)
    return jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.randn(*x.shape).astype(np.float32),
                        params)


def batch(rng, vocab=120, b=3, t=16):
    ids = rng.randint(1, vocab, (b, t)).astype(np.int32)
    mask = np.ones((b, t), dtype=np.int32)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    ids[mask == 0] = 0
    return ids, mask


def test_pooling_matches_jax(rng):
    h = rng.randn(3, 7, 16).astype(np.float32)
    mask = np.array([[1] * 7, [1, 1, 1, 0, 0, 0, 0], [0] * 7], dtype=np.int32)
    th, tm = torch.from_numpy(h), torch.from_numpy(mask)
    np.testing.assert_allclose(pooling.masked_mean_pool(th, tm).numpy(),
                               np.asarray(jax_pooling.masked_mean_pool(h, mask)), **TOL)
    np.testing.assert_array_equal(pooling.cls_pool(th, tm).numpy(),
                                  np.asarray(jax_pooling.cls_pool(h, mask)))
    x = np.concatenate([h[:, 0], np.zeros((1, 16), np.float32)])
    np.testing.assert_allclose(pooling.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_pooling.l2_normalize(x)), **TOL)


@pytest.mark.parametrize("fused_qkv", [True, False])
def test_bert_encode_matches_jax(rng, fused_qkv):
    cfg = dict(SMALL, fused_qkv=fused_qkv)
    params = jax_params(cfg)
    ids, mask = batch(rng)
    want = jax_bert_encode(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                           jnp.asarray(mask), JaxBertConfig(**cfg), attention_impl="xla")
    model = BertModel(BertConfig(**cfg))
    model.load_state_dict(params_from_jax(params, BertConfig(**cfg)))
    with torch.no_grad():
        got = bert_encode(model, torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("encoder_type", ["e5", "bge", "contriever"])
def test_encoder_heads_match_jax(rng, encoder_type):
    params = jax_params(SMALL, seed=3)
    ids, mask = batch(rng)
    want = JaxEncoder(jax.tree.map(jnp.asarray, params), JaxBertConfig(**SMALL),
                      encoder_type, attention_impl="xla")(ids, mask)
    got = Encoder.from_jax(params, BertConfig(**SMALL), encoder_type, device="cpu")(ids, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if encoder_type != "contriever":
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)


def test_encoder_loads_a_jax_saved_encoder(rng, tmp_path):
    params = init_bert_params(jax.random.key(7), JaxBertConfig(**SMALL))
    jax_enc = JaxEncoder(params, JaxBertConfig(**SMALL), "bge", attention_impl="xla")
    jax_enc.save(str(tmp_path))
    enc = Encoder.load(str(tmp_path), device="cpu")
    assert enc.encoder_type == "bge" and enc.config == BertConfig(**SMALL)
    ids, mask = batch(rng)
    np.testing.assert_allclose(enc(ids, mask).numpy(), np.asarray(jax_enc(ids, mask)), **TOL)


def test_seeded_init_is_reproducible():
    cfg = BertConfig(**SMALL)
    a = BertModel(cfg, generator=torch.Generator().manual_seed(5)).state_dict()
    b = BertModel(cfg, generator=torch.Generator().manual_seed(5)).state_dict()
    c = BertModel(cfg, generator=torch.Generator().manual_seed(6)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "layers.0.attention.qkv.weight"
    assert not torch.equal(a[w], c[w])
    assert abs(float(a[w].std()) - 0.02) < 0.002
    assert torch.equal(a["layers.1.mlp.output_layer_norm.weight"], torch.ones(64))
    assert torch.equal(a["layers.1.mlp.intermediate.bias"], torch.zeros(128))


def test_bf16_compute_tracks_f32(rng):
    params = jax_params(SMALL, seed=4)
    ids, mask = batch(rng)
    f32 = Encoder.from_jax(params, BertConfig(**SMALL), device="cpu")(ids, mask)
    bf16 = Encoder.from_jax(params, BertConfig(**SMALL), device="cpu",
                            compute_dtype=torch.bfloat16)(ids, mask)
    assert bf16.dtype == torch.float32
    cos = torch.sum(f32 * bf16, dim=-1)  # both unit rows (e5 head)
    assert float(cos.min()) > 0.999

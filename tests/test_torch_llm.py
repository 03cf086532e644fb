"""The port's Llama decoder held against the JAX package.

A tiny geometry whose projections K6 tiles (2 layers, hidden 512, 8 heads of
64, 2 KV heads, MLP 1024, vocab 512), parameters drawn by ``jax.random`` and
carried across with ``llama_params_from_jax``:

- ``llama_block_forward`` logits at f32 compute within 1e-4 for bf16, int8,
  linear int4 and NF4 weights, for the llama family, Qwen2 (QKV biases) and
  Gemma-2 (sandwich norms, GeGLU, soft-capping, sliding window);
- greedy ids equal, with 4-bit decode through K6 (its plain version here,
  JAX's kernel in interpret mode; a few steps, since that mode is slow);
- prefill + resume equal to one greedy decode; eos rows stay eos;
- ``TorchLlamaBackend`` against ``JaxLlamaBackend`` across prompt buckets,
  and under the Generator's segmented stop-word decode;
- ``convert_hf_llama_state_dict`` and ``load_llama`` give the reference's
  parameters from a tiny checkpoint that ``transformers`` writes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import transformers

from kirag_tpu.generation.interface import Generator as JaxGenerator
from kirag_tpu.models import llm as jax_llm
from kirag_tpu_torch.generation.interface import Generator
from kirag_tpu_torch.models import llm

from tests.helpers import make_tokenizer

TINY = dict(vocab_size=512, hidden_size=512, num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=2, intermediate_size=1024, max_position_embeddings=256,
            rope_theta=1e4)
FAMILIES = {
    "llama": {},
    "qwen2": {"attention_bias": True},
    "gemma2": {"model_type": "gemma2", "head_dim_override": 64, "query_pre_attn_scalar": 64,
               "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
               "sliding_window": 4, "hidden_activation": "gelu_pytorch_tanh",
               "tie_word_embeddings": True, "rms_norm_eps": 1e-6},
}
TOL = dict(rtol=1e-4, atol=1e-4)


def port_config(config: jax_llm.LlamaConfig) -> llm.LlamaConfig:
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
    fields["int4_impl"] = {"pallas": "kernel"}.get(config.int4_impl, config.int4_impl)
    return llm.LlamaConfig(**fields)


def jax_params(family, fmt, seed=0):
    """(JAX config, JAX numpy tree) for one family and weight format."""
    config = jax_llm.LlamaConfig(**TINY, **FAMILIES[family])
    tree = jax.tree.map(np.asarray, jax_llm.init_llama_params(jax.random.PRNGKey(seed), config))
    rng = np.random.RandomState(seed + 1)
    for layer in tree["layers"]:
        for name in ("input_layernorm", "post_attention_layernorm"):
            layer[name]["scale"] = (1 + 0.1 * rng.randn(512)).astype(np.float32)
        if family == "qwen2":
            for name in ("q_proj", "k_proj", "v_proj"):
                layer[name]["bias"] = (0.1 * rng.randn(*layer[name]["bias"].shape)
                                       ).astype(np.float32)
        if family == "gemma2":
            for name in ("pre_feedforward_layernorm", "post_feedforward_layernorm"):
                layer[name] = {"scale": (0.1 * rng.randn(512)).astype(np.float32)}
    if fmt == "bf16":  # load_llama's cast: 2-D float leaves in bf16, the rest f32
        tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16) if a.ndim >= 2 else a, tree)
    elif fmt != "f32":
        bits, cb = {"int8": (8, "nf4"), "int4": (4, "linear"), "nf4": (4, "nf4")}[fmt]
        tree = jax.tree.map(np.asarray, jax_llm.quantize_llama_params(tree, bits, cb))
    return config, tree


def left_padded(rng, b=3, t=7, vocab=512):
    ids = rng.randint(1, vocab, size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), dtype=np.int32)
    mask[0, :3] = 0
    if b > 2:
        mask[2, :5] = 0
    ids[mask == 0] = 0
    return ids, mask


def forward_both(config, tree, ids, mask):
    nl, nkv, hd = config.num_hidden_layers, config.num_key_value_heads, config.head_dim
    positions = np.clip(np.cumsum(mask, axis=1) - 1, 0, None)
    empty = [jnp.zeros((len(ids), 0, nkv, hd)) for _ in range(nl)]
    want, _, _ = jax_llm.llama_block_forward(
        tree, jnp.asarray(ids), jnp.asarray(positions), config, empty, empty,
        jnp.zeros((len(ids), 0), jnp.int32), new_mask=jnp.asarray(mask))
    params = llm.llama_params_from_jax(tree, device="cpu")
    t_empty = [torch.zeros(len(ids), 0, nkv, hd) for _ in range(nl)]
    got, _, _ = llm.llama_block_forward(
        params, torch.from_numpy(ids).long(), torch.from_numpy(positions), port_config(config),
        t_empty, t_empty, torch.zeros(len(ids), 0, dtype=torch.int32),
        new_mask=torch.from_numpy(mask))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4", "nf4"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_logits_match_jax(rng, family, fmt):
    config, tree = jax_params(family, fmt)
    ids, mask = left_padded(rng)
    got, want = forward_both(config, tree, ids, mask)
    sel = mask.astype(bool)  # pad rows attend nothing valid; compare real tokens
    np.testing.assert_allclose(got[sel], want[sel], **TOL)


@pytest.mark.parametrize("fmt", ["int4", "nf4"])
def test_greedy_decode_through_k6_matches_jax(rng, fmt):
    config, tree = jax_params("llama", fmt)
    config = dataclasses.replace(config, int4_impl="pallas")  # interpret mode off the TPU
    ids, mask = left_padded(rng, b=2)
    want_ids, want_logits = jax_llm.greedy_decode(tree, jnp.asarray(ids), jnp.asarray(mask),
                                                  config, 3)
    params = llm.llama_params_from_jax(tree, device="cpu")
    got_ids, got_logits = llm.greedy_decode(params, ids, mask, port_config(config), 3)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), **TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_decode_matches_jax(rng, family):
    config, tree = jax_params(family, "f32")
    ids, mask = left_padded(rng)
    params = llm.llama_params_from_jax(tree, device="cpu")
    probe, _ = llm.greedy_decode(params, ids, mask, port_config(config), 1)
    eos = int(probe[0, 0])  # row 0 finishes at once; the others run on
    for eos_id in (None, eos):
        want_ids, want_logits = jax_llm.greedy_decode(
            tree, jnp.asarray(ids), jnp.asarray(mask), config, 6, eos_token_id=eos_id)
        got_ids, got_logits = llm.greedy_decode(params, ids, mask, port_config(config), 6,
                                                eos_token_id=eos_id)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), **TOL)
        no_logits, none = llm.greedy_decode(params, ids, mask, port_config(config), 6,
                                            eos_token_id=eos_id, return_logits=False)
        assert none is None and torch.equal(no_logits, got_ids)


def test_decode_without_logits_stops_once_every_row_is_done(rng, monkeypatch):
    config, tree = jax_params("llama", "f32")
    ids, mask = left_padded(rng, b=1)
    params = llm.llama_params_from_jax(tree, device="cpu")
    eos = int(llm.greedy_decode(params, ids, mask, port_config(config), 1)[0][0, 0])
    want, _ = jax_llm.greedy_decode(tree, jnp.asarray(ids), jnp.asarray(mask), config, 6,
                                    eos_token_id=eos)
    steps = []
    step = llm._decode_step
    monkeypatch.setattr(llm, "_decode_step", lambda *a: steps.append(1) or step(*a))
    got, _ = llm.greedy_decode(params, ids, mask, port_config(config), 6, eos_token_id=eos,
                               return_logits=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got == eos).all()) and not steps  # the only row was done after the prefill


def test_prefill_resume_equals_greedy(rng):
    config, tree = jax_params("llama", "f32")
    pc = port_config(config)
    params = llm.llama_params_from_jax(tree, device="cpu")
    ids, mask = left_padded(rng)
    eos = int(llm.greedy_decode(params, ids, mask, pc, 1)[0][0, 0])
    for eos_id in (None, eos):
        ref_ids, ref_logits = llm.greedy_decode(params, ids, mask, pc, 9, eos_token_id=eos_id)
        first, first_logits, state = llm.prefill_decode(params, ids, mask, pc, 9,
                                                        eos_token_id=eos_id)
        parts, logits = [first], [first_logits]
        for n in (4, 4):
            t, lg, state = llm.resume_decode(params, state, pc, n, eos_token_id=eos_id)
            parts.append(t)
            logits.append(lg)
        assert torch.equal(torch.cat(parts, dim=1), ref_ids)
        assert torch.equal(torch.cat(logits, dim=1), ref_logits)
        if eos_id is not None:
            assert bool((ref_ids[0] == eos).all())  # a finished row keeps emitting eos


def test_backend_matches_jax_across_buckets(rng):
    config, tree = jax_params("llama", "f32")
    ref = jax_llm.JaxLlamaBackend(jax.tree.map(jnp.asarray, tree), config, eos_token_id=7,
                                  compute_dtype=jnp.float32, prompt_buckets=(16, 32))
    port = llm.TorchLlamaBackend(llm.llama_params_from_jax(tree, device="cpu"),
                                 port_config(config), eos_token_id=7,
                                 compute_dtype=torch.float32, prompt_buckets=(16, 32))
    for t in (5, 20, 40):  # padded to 16, to 32, truncated to the last 32
        ids, mask = left_padded(rng, b=2, t=t)
        want_ids, want_logits = ref.greedy(ids, mask, 4)
        got_ids, got_logits = port.greedy(ids, mask, 4)
        assert got_ids.dtype == np.int32
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_allclose(got_logits, want_logits, **TOL)
        want0, _, want_state = ref.greedy_start(ids, mask, 5, return_logits=False)
        got0, none, got_state = port.greedy_start(ids, mask, 5, return_logits=False)
        assert none is None
        want1, want_lg, _ = ref.greedy_resume(want_state, 4)
        got1, got_lg, _ = port.greedy_resume(got_state, 4)
        np.testing.assert_array_equal(np.concatenate([got0, got1], 1),
                                      np.concatenate([want0, want1], 1))
        np.testing.assert_allclose(got_lg, want_lg, **TOL)


def test_generator_segmented_decode_matches_jax(rng, tmp_path):
    config, tree = jax_params("llama", "f32")
    tok = make_tokenizer(tmp_path)
    prompts = ["alpha beta gamma", "w3 is the city of w5 and w7"]
    outs = []
    for gen_cls, backend in (
            (JaxGenerator, jax_llm.JaxLlamaBackend(jax.tree.map(jnp.asarray, tree), config,
                                                   eos_token_id=999, compute_dtype=jnp.float32,
                                                   prompt_buckets=(32,))),
            (Generator, llm.TorchLlamaBackend(llm.llama_params_from_jax(tree, device="cpu"),
                                              port_config(config), eos_token_id=999,
                                              compute_dtype=torch.float32,
                                              prompt_buckets=(32,)))):
        gen = gen_cls(tok, backend, model_name="llama-3-tiny-instruct", max_length=32,
                      max_new_tokens=10, stop_check_every=4)
        gen.family = "generic"
        enc = gen.tokenizer_encode(prompts)
        full, _ = gen.greedy_generate(enc, return_logits=False)
        seg, seg_logits = gen.greedy_generate(enc, stop_words=["never-emitted"])
        first = tok.decode(full[0, :1], skip_special_tokens=True).strip() or "[never]"
        early, _ = gen.greedy_generate(enc, stop_words=[first], return_logits=False)
        outs.append((full, seg, seg_logits, early))
    (j_full, j_seg, j_lg, j_early), (t_full, t_seg, t_lg, t_early) = outs
    np.testing.assert_array_equal(t_full, j_full)
    np.testing.assert_array_equal(t_seg, j_seg)
    np.testing.assert_array_equal(t_seg, t_full)
    np.testing.assert_allclose(t_lg, j_lg, **TOL)
    np.testing.assert_array_equal(t_early, j_early)


def save_hf_llama(path, family="llama", safe_serialization=True):
    torch.manual_seed(0)
    kw = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, intermediate_size=128, max_position_embeddings=64)
    if family == "gemma2":
        model = transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
            **kw, head_dim=16, sliding_window=8, query_pre_attn_scalar=16))
    elif family == "qwen2":
        model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
            **kw, tie_word_embeddings=False))
    else:
        model = transformers.LlamaForCausalLM(transformers.LlamaConfig(**kw))
    model.save_pretrained(str(path), safe_serialization=safe_serialization)
    return str(path), model


def assert_same_tree(got, want):
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert [k for k, _ in flat_got] == [k for k, _ in flat_want]
    for (path, w), (_, g) in zip(flat_want, flat_got):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, path
            w, g = w.astype(np.float32), g.float()
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))


@pytest.mark.parametrize("family", ["llama", "qwen2", "gemma2"])
@pytest.mark.parametrize("quant_bits", [None, 8, 4])
def test_convert_hf_state_dict_matches_jax(tmp_path, family, quant_bits):
    _, model = save_hf_llama(tmp_path, family)
    config = jax_llm.config_from_hf(model.config)
    assert port_config(config) == llm.config_from_hf(model.config)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    want = jax_llm.convert_hf_llama_state_dict(sd, config, quant_bits=quant_bits)
    got = llm.convert_hf_llama_state_dict(sd, port_config(config), quant_bits=quant_bits)
    assert_same_tree(got, want)


@pytest.mark.parametrize("fmt", ["model.safetensors", "pytorch_model.bin"])
@pytest.mark.parametrize("quant_bits,dtype", [(None, "float32"), (None, "bfloat16"),
                                              (8, "bfloat16"), (4, "bfloat16")])
def test_load_llama_matches_jax(tmp_path, fmt, quant_bits, dtype):
    path, _ = save_hf_llama(tmp_path, safe_serialization=fmt == "model.safetensors")
    want, want_config = jax_llm.load_llama(path, compute_dtype=getattr(jnp, dtype),
                                           quant_bits=quant_bits)
    got, got_config = llm.load_llama(path, compute_dtype=getattr(torch, dtype),
                                     quant_bits=quant_bits, device="cpu")
    assert got_config == port_config(want_config)  # 4-bit: "parity" off the card
    assert_same_tree(got, want)


def test_entry_points_default_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no GPU")
    path, _ = save_hf_llama(tmp_path)
    config = llm.LlamaConfig(**TINY)
    for call in (lambda: llm.init_llama_params(config),
                 lambda: llm.llama_params_from_jax({"embed_tokens": np.zeros((2, 2))}),
                 lambda: llm.load_llama(path)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_init_llama_params_quantizes_as_it_builds():
    config = llm.LlamaConfig(**dict(TINY, num_hidden_layers=1))
    plain = llm.init_llama_params(config, seed=3, device="cpu")
    nf4 = llm.init_llama_params(config, seed=3, device="cpu", dtype=torch.bfloat16,
                                quant_bits=4)
    want = llm.quantize_llama_params(plain, bits=4)
    assert nf4["embed_tokens"].dtype == torch.bfloat16
    assert torch.equal(nf4["embed_tokens"], plain["embed_tokens"].to(torch.bfloat16))
    for name in ("q_proj", "down_proj"):
        for key in ("kernel_q4", "kernel_scale4", "kernel_cb4"):
            assert torch.equal(nf4["layers"][0][name][key], want["layers"][0][name][key])
    assert llm.param_bytes(nf4) < llm.param_bytes(plain) / 3


def test_unported_options_raise():
    """The draft model and the prefix pool are ported: the backend takes
    them (tests/test_torch_speculative.py and tests/test_torch_prefix_kv.py
    hold their decodes) and refuses a draft with the int8 KV cache, as the
    reference does."""
    config, tree = jax_params("llama", "f32")
    params = llm.llama_params_from_jax(tree, device="cpu")
    pc = port_config(config)
    spec = llm.TorchLlamaBackend(params, pc, 0, draft_params=params, draft_config=pc,
                                 spec_gamma=3)
    assert spec.draft_params is params and spec.spec_acc_hist.shape == (3,)
    assert not spec.supports_prefix_cache
    pooled = llm.TorchLlamaBackend(params, pc, 0, prefix_cache_groups=4)
    assert pooled.supports_prefix_cache and pooled._prefix_pool is None  # allocated at first use
    with pytest.raises(ValueError, match="full-precision KV cache"):
        llm.TorchLlamaBackend(params, dataclasses.replace(pc, kv_quant_bits=8), 0,
                              draft_params=params, draft_config=pc)

"""The port's int8 KV cache held against the JAX package.

- ``_kv_quantize``: codes and scales bitwise JAX's (all-zero slots, values
  on the .5 code boundaries, f32 and bf16 inputs);
- the attention block's int8 branch at bf16 compute against JAX's, and a
  control that dequantizes the cache first and misses the bound;
- prefill and 8 decode steps with ``kv_quant_bits=8`` at f32 compute: logits
  within 1e-5 of the largest, greedy ids equal, for the llama and gemma2
  families with f32 weights and NF4 weights (the port's plain K6 against
  JAX's per-block XLA formulation, the same sums); the int8 cache's contents
  after the run;
- ``TorchLlamaBackend`` against ``JaxLlamaBackend`` across two prompt
  buckets, ``load_llama(kv_quant_bits=8)``'s config, and both packages'
  ``cli/retrieve.py --llm_kv_quant_bits 8``.

The geometry is test_torch_llm.py's (2 layers, hidden 512: K6 tiles only
inputs of 512 and up); its parameters are drawn by ``jax.random``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kirag_tpu.models import llm as jax_llm
from kirag_tpu_torch.models import llm

from tests.torch_cli_helpers import cli_workspace, run_retrieve_clis, torch_threads  # noqa: F401
from tests.test_torch_llm import jax_params, left_padded, port_config, save_hf_llama

KV8 = dict(kv_quant_bits=8)
STEPS = 9  # the prefill's token and 8 decode steps


def rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def kv_inputs(rng, dtype):
    x = (rng.randn(3, 17, 4, 64) * rng.rand(3, 17, 4, 1) * 5).astype(np.float32)
    x[0, 3] = 0                                # all-zero slots: scale 0, codes 0
    s = np.float32(0.37)
    x[1, 2, 0] = (np.arange(64) - 31.5).astype(np.float32) * s   # x / scale at k + .5
    x[1, 2, 0, 0] = 127 * s
    x[2, 5, 1] = np.linspace(-1, 1, 64, dtype=np.float32) * 1e-30   # tiny: the 1e-12 floor
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_matches_jax_bitwise(rng, dtype):
    x = kv_inputs(rng, ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    want_q, want_s = jax_llm._kv_quantize(jnp.asarray(x))
    t = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    got_q, got_s = llm._kv_quantize(t)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert not got_q[0, 3].any() and not got_s[0, 3].any()
    # the .5 boundaries round half to even, as JAX's and numpy's rint do
    row = np.asarray(x[1, 2, 0], np.float32)
    np.testing.assert_array_equal(got_q[1, 2, 0].numpy(),
                                  np.clip(np.rint(row / got_s[1, 2, 0].numpy()), -127, 127))


def test_cache_alloc_and_write():
    cache = llm._cache_alloc(2, 5, 3, 8, torch.float32, 8, "cpu")
    assert cache["q"].shape == (2, 5, 3, 8) and cache["q"].dtype == torch.int8
    assert cache["s"].shape == (2, 5, 3) and cache["s"].dtype == torch.float32
    new = torch.randn(2, 3, 8)
    llm._cache_write(cache, new, slice(None), 4)
    q, s = llm._kv_quantize(new)
    assert torch.equal(cache["q"][:, 4], q) and torch.equal(cache["s"][:, 4], s)
    assert not cache["q"][:, :4].any()
    with pytest.raises(ValueError, match="kv_quant_bits"):
        llm._check_config(llm.LlamaConfig(kv_quant_bits=4))



def bf16_attention_case(rng, t_new):
    """One attention block at bf16 compute over an int8 cache of 300 slots
    (GQA 4 query heads over 2 KV heads, some slots masked, one all-zero):
    (JAX config, JAX layer, inputs). The projections select columns of the
    identity and every position is 0 (RoPE is the identity there), so q, k
    and v are the inputs' exact bf16 values in both packages and the
    comparison holds the attention's own arithmetic."""
    nh, nkv, hd = 4, 2, 64
    hidden = nh * hd
    config = jax_llm.LlamaConfig(vocab_size=64, hidden_size=hidden, num_hidden_layers=1,
                                 num_attention_heads=nh, num_key_value_heads=nkv,
                                 intermediate_size=64, **KV8)
    eye = np.eye(hidden, dtype=np.float32).astype(ml_dtypes.bfloat16)
    layer = {"q_proj": {"kernel": eye}, "k_proj": {"kernel": eye[:, :nkv * hd]},
             "v_proj": {"kernel": eye[:, hidden - nkv * hd:]}, "o_proj": {"kernel": eye}}
    bsz, t_cache = 2, 300
    x = rng.randn(bsz, t_new, hidden).astype(ml_dtypes.bfloat16)
    kv = (rng.randn(2, bsz, t_cache, nkv, hd) * rng.rand(2, bsz, t_cache, nkv, 1) * 3)
    kv[:, 0, 5] = 0
    caches = [jax_llm._kv_quantize(jnp.asarray(kv[i].astype(ml_dtypes.bfloat16)))
              for i in range(2)]
    cache_mask = (rng.rand(bsz, t_cache) > 0.1).astype(np.int32)
    positions = np.zeros((bsz, t_new), np.int32)
    return config, layer, (x, caches, cache_mask, positions, np.ones_like(positions))


@pytest.mark.parametrize("t_new", [1, 3])
def test_int8_attention_at_bf16_matches_jax(rng, t_new):
    """At bf16 compute the int8 branch rounds where the reference does: the
    probabilities times the V scale are cast to bf16 before the product
    with the raw codes, and the K scale multiplies the logits after the
    contraction. The block's output is within 2^-9 of its largest magnitude
    of JAX's (bitwise on this machine); dequantizing the cache to bf16 first
    and attending over it, the other order, misses that bound by 2.5x and
    more."""
    config, layer, (x, caches, cache_mask, positions, new_mask) = bf16_attention_case(rng, t_new)
    (kq, ks), (vq, vs) = caches
    want = jax_llm._attention_block(jnp.asarray(x), jax.tree.map(jnp.asarray, layer), config,
                                    jnp.asarray(positions), {"q": kq, "s": ks},
                                    {"q": vq, "s": vs}, jnp.asarray(cache_mask),
                                    jnp.asarray(new_mask))[0]
    want = np.asarray(want).astype(np.float32)

    def bf16(a):
        return torch.from_numpy(np.asarray(a).astype(np.float32)).to(torch.bfloat16)

    tlayer = {name: {"kernel": bf16(p["kernel"])} for name, p in layer.items()}
    k_cache, v_cache = ({"q": torch.from_numpy(np.array(q)), "s": torch.from_numpy(np.array(s))}
                        for q, s in caches)
    pc = port_config(config)

    def port(cfg, kc, vc):
        out = llm._attention_block(bf16(x), tlayer, cfg, torch.from_numpy(positions).long(), kc,
                                   vc, torch.from_numpy(cache_mask), torch.from_numpy(new_mask))
        assert out[0].dtype == torch.bfloat16
        return out[0].float().numpy()

    bound = 2.0 ** -9 * float(np.abs(want).max())
    got = port(pc, k_cache, v_cache)
    assert float(np.abs(got - want).max()) <= bound

    def dequantized(c):
        return (c["q"].float() * c["s"][..., None]).to(torch.bfloat16)

    control = port(dataclasses.replace(pc, kv_quant_bits=None), dequantized(k_cache),
                   dequantized(v_cache))
    assert float(np.abs(control - want).max()) > 2.5 * bound

def decode_both(family, fmt, rng, eos=None):
    """Prefill + 8 decode steps at f32 with the int8 cache in both packages:
    (port ids, logits, state), (JAX ids, logits)."""
    config, tree = jax_params(family, fmt)
    # NF4: JAX's per-block formulation, K6's arithmetic; another rounding of
    # a key can move its int8 code by one, so the sum order must be the same
    config = dataclasses.replace(config, **KV8, int4_impl="blockdot" if fmt == "nf4"
                                 else config.int4_impl)
    ids, mask = left_padded(rng)
    want_ids, want_logits = jax_llm.greedy_decode(tree, jnp.asarray(ids), jnp.asarray(mask),
                                                  config, STEPS, eos_token_id=eos)
    pc = port_config(config)
    if fmt == "nf4":
        pc = dataclasses.replace(pc, int4_impl="kernel")  # the plain K6 on CPU tensors
    params = llm.llama_params_from_jax(tree, device="cpu")
    first, first_logits, state = llm.prefill_decode(params, ids, mask, pc, STEPS,
                                                    eos_token_id=eos)
    rest, rest_logits, state = llm.resume_decode(params, state, pc, STEPS - 1,
                                                 eos_token_id=eos)
    got_ids = torch.cat([first, rest], dim=1).numpy()
    got_logits = torch.cat([first_logits, rest_logits], dim=1).numpy()
    return (got_ids, got_logits, state, params, pc, ids, mask), (np.asarray(want_ids),
                                                                np.asarray(want_logits))


@pytest.mark.parametrize("fmt", ["f32", "nf4"])
@pytest.mark.parametrize("family", ["llama", "gemma2"])
def test_int8_cache_decode_matches_jax(rng, family, fmt, monkeypatch):
    from kirag_tpu_torch.kernels import qmm

    calls = []
    plain = qmm.int4_matmul_plain
    monkeypatch.setattr(qmm, "int4_matmul_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    (got_ids, got_logits, state, _, _, ids, _), (want_ids, want_logits) = decode_both(
        family, fmt, rng)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert rel_err(got_logits, want_logits) <= 1e-5
    assert bool(calls) == (fmt == "nf4")        # NF4's projections went through K6
    k0 = state["k"][0]
    assert isinstance(k0, dict) and k0["q"].dtype == torch.int8
    assert k0["q"].shape[1] == ids.shape[1] + STEPS  # the prompt and room for every token


def test_int8_cache_holds_the_references_codes(rng):
    """After prefill and 8 decode steps the port's cache holds JAX's codes,
    its scales within 1e-6 of the largest, the same mask and positions, and
    an empty last slot. (The codes equal only where no key or value lies
    within the two packages' f32 rounding of a code's .5 boundary: one step
    of a code there moves later logits by about 1e-4 of the largest.)"""
    (_, _, state, *_ , ids, mask), _ = decode_both("llama", "f32", rng)
    config, tree = jax_params("llama", "f32")
    config = dataclasses.replace(config, **KV8)
    _, _, want = jax_llm._prefill_state(tree, jnp.asarray(ids), jnp.asarray(mask), config, STEPS,
                                        jnp.float32, None)
    for _ in range(STEPS - 1):
        want = jax_llm._decode_step(tree, want, config, jnp.float32, None)[1]
    for got, ref in zip(state["k"] + state["v"], want["k"] + want["v"]):
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
        assert rel_err(got["s"].numpy(), np.asarray(ref["s"])) <= 1e-6
        assert not got["q"][:, -1].any() and not got["s"][:, -1].any()
    np.testing.assert_array_equal(state["cache_mask"].numpy(), np.asarray(want["cache_mask"]))
    np.testing.assert_array_equal(state["cache_pos"].numpy(), np.asarray(want["cache_pos"]))
    assert state["write_at"] == int(want["write_at"]) == ids.shape[1] + STEPS - 1


def test_int8_cache_with_eos_rows(rng):
    config, tree = jax_params("llama", "f32")
    params = llm.llama_params_from_jax(tree, device="cpu")
    ids, mask = left_padded(np.random.RandomState(0))   # decode_both's prompts
    eos = int(llm.greedy_decode(params, ids, mask, port_config(config), 1)[0][0, 0])
    (got_ids, got_logits, *_), (want_ids, want_logits) = decode_both("llama", "f32", rng, eos)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert rel_err(got_logits, want_logits) <= 1e-5
    assert (got_ids[0] == eos).all()  # row 0 finished at once and keeps emitting eos


def test_int8_cache_with_chunked_prefill_matches_jax(rng, monkeypatch):
    """A prompt longer than the port's prefill query chunk (cut to 3 here):
    the chunks score all the new keys, as the reference's one piece does."""
    monkeypatch.setattr(llm, "PREFILL_QUERY_CHUNK", 3)
    (got_ids, got_logits, *_), (want_ids, want_logits) = decode_both("llama", "f32", rng)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert rel_err(got_logits, want_logits) <= 1e-5


def test_backend_int8_cache_matches_jax_across_buckets(rng):
    config, tree = jax_params("llama", "f32")
    config = dataclasses.replace(config, **KV8)
    ref = jax_llm.JaxLlamaBackend(jax.tree.map(jnp.asarray, tree), config, eos_token_id=7,
                                  compute_dtype=jnp.float32, prompt_buckets=(16, 32))
    port = llm.TorchLlamaBackend(llm.llama_params_from_jax(tree, device="cpu"),
                                 port_config(config), eos_token_id=7,
                                 compute_dtype=torch.float32, prompt_buckets=(16, 32))
    for t in (5, 20):  # padded to 16, to 32
        ids, mask = left_padded(rng, b=2, t=t)
        want_ids, want_logits = ref.greedy(ids, mask, 4)
        got_ids, got_logits = port.greedy(ids, mask, 4)
        np.testing.assert_array_equal(got_ids, want_ids)
        assert rel_err(got_logits, want_logits) <= 1e-5
        want0, _, want_state = ref.greedy_start(ids, mask, 5, return_logits=False)
        got0, _, got_state = port.greedy_start(ids, mask, 5, return_logits=False)
        assert isinstance(got_state["k"][0], dict)
        want1, want_lg, _ = ref.greedy_resume(want_state, 4)
        got1, got_lg, _ = port.greedy_resume(got_state, 4)
        np.testing.assert_array_equal(np.concatenate([got0, got1], 1),
                                      np.concatenate([want0, want1], 1))
        assert rel_err(got_lg, want_lg) <= 1e-5


@pytest.mark.parametrize("quant_bits", [None, 4])
def test_load_llama_kv_quant_matches_jax(tmp_path, quant_bits):
    path, _ = save_hf_llama(tmp_path)
    _, want = jax_llm.load_llama(path, compute_dtype=jnp.bfloat16, quant_bits=quant_bits,
                                 kv_quant_bits=8)
    _, got = llm.load_llama(path, compute_dtype=torch.bfloat16, quant_bits=quant_bits,
                            kv_quant_bits=8, device="cpu")
    assert got == port_config(want) and got.kv_quant_bits == 8


def test_draft_and_prefix_pool_still_refuse(rng):
    """With the int8 cache a draft is still refused (the reference's
    refusal); the prefix pool is ported and takes the int8 format."""
    config, tree = jax_params("llama", "f32")
    pc = dataclasses.replace(port_config(config), **KV8)
    params = llm.llama_params_from_jax(tree, device="cpu")
    with pytest.raises(ValueError, match="full-precision KV cache"):
        llm.TorchLlamaBackend(params, pc, 0, draft_params=params, draft_config=pc)
    pool = llm.alloc_prefix_pool(pc, 2, 8, torch.float32, "cpu")
    assert pool["k"][0]["q"].dtype == torch.int8 and pool["v"][1]["s"].shape == (2, 8, 2)
    assert llm.TorchLlamaBackend(params, pc, 0, prefix_cache_groups=4).supports_prefix_cache


def test_retrieve_cli_int8_kv_matches_jax(cli_workspace, monkeypatch):
    """``--llm_kv_quant_bits 8`` over the cached KG (the constructor runs): both
    packages' results files agree, and the flag reaches an injected pair."""
    from kirag_tpu_torch.cli import retrieve

    with torch_threads(1):
        _, results = run_retrieve_clis(cli_workspace, monkeypatch, concurrent=1, cached=True,
                                       extra=("--llm_kv_quant_bits", "8"))
    got, want = results["port"], results["jax"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["paths"] == w["paths"]
        assert [c["id"] for c in g["ctxs"]] == [c["id"] for c in w["ctxs"]]
        np.testing.assert_allclose([c["score"] for c in g["ctxs"]],
                                   [c["score"] for c in w["ctxs"]], rtol=1e-5, atol=1e-5)
        assert len(g["ctxs"]) > 0
    args = retrieve.setup_parser(["--dataset", "d", "--query_file", "q", "--index_folder", "i",
                                  "--retriever_model_name_or_path", "r", "--llm", "l",
                                  "--aligner_model_name_or_path", "a", "--save_file", "s",
                                  "--llm_kv_quant_bits", "8"])
    params, config = {"embed_tokens": None}, llm.LlamaConfig()
    assert retrieve.load_llm(args, (params, config))[1].kv_quant_bits == 8

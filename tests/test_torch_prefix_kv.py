"""The port's prefix-KV pool held against the JAX package.

The JAX tests' tiny Llama (``tests/test_llm.py``'s ``TestPrefixKVCache``:
vocab 128, hidden 32, 2 layers, 4 heads of 8, 2 KV heads), f32, parameters
drawn by ``jax.random`` and carried across with ``llama_params_from_jax``.
``TorchLlamaBackend(prefix_cache_groups=...)`` with ``prefix_groups`` held
to plain greedy and to ``JaxLlamaBackend`` on the same calls: the seeding
and the reusing call, a cached tail the prompt diverges from, LRU eviction,
a pool wider than the 256-slot window, the short-match fallback, the
Generator's plumbing, and the int8 cache (``kv_quant_bits=8``), whose pool
holds JAX's codes and scales.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kirag_tpu.models import llm as jax_llm
from kirag_tpu_torch.models import llm

from tests.helpers import make_tokenizer

CFG = jax_llm.LlamaConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, intermediate_size=64,
                          max_position_embeddings=128, rope_theta=10000.0)
TOL = dict(rtol=1e-4, atol=1e-4)


def port_config(config: jax_llm.LlamaConfig) -> llm.LlamaConfig:
    return llm.LlamaConfig(**{f.name: getattr(config, f.name)
                              for f in dataclasses.fields(config)})


@pytest.fixture(scope="module")
def model():
    """The JAX tree and the port's parameters, from the same draws."""
    tree = jax_llm.init_llama_params(jax.random.PRNGKey(3), CFG)
    return tree, llm.llama_params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def backends(model, kv_bits=None, groups=4, tokens=128, eos=None):
    """(JAX backend, port backend) with a prefix pool."""
    tree, params = model
    config = dataclasses.replace(CFG, kv_quant_bits=kv_bits)
    kw = dict(eos_token_id=eos, prompt_buckets=(32, 64, 128), prefix_cache_groups=groups,
              prefix_cache_tokens=tokens)
    return (jax_llm.JaxLlamaBackend(tree, config, compute_dtype=jnp.float32, **kw),
            llm.TorchLlamaBackend(params, port_config(config), compute_dtype=torch.float32, **kw))


def plain_greedy(model, ids, mask, n, kv_bits=None):
    config = port_config(dataclasses.replace(CFG, kv_quant_bits=kv_bits))
    g, lg = llm.greedy_decode(model[1], ids, mask, config, n)
    return g.numpy(), lg.numpy()


def shared_rows(rng, prefix_len=80, tails=(20, 33)):
    """Left-padded rows sharing a prefix, each with its own tail."""
    prefix = rng.randint(1, 128, size=prefix_len).astype(np.int32)
    rows = [np.concatenate([prefix, rng.randint(1, 128, size=t).astype(np.int32)])
            for t in tails]
    width = max(len(r) for r in rows)
    ids = np.zeros((len(rows), width), np.int32)
    mask = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        ids[i, width - len(r):] = r
        mask[i, width - len(r):] = 1
    return ids, mask


def both(pair, ids, mask, n, groups):
    """One prefixed greedy call on each backend: {pkg: (ids, logits)}."""
    return {pkg: be.greedy(ids, mask, n, prefix_groups=groups)
            for pkg, be in zip(("jax", "port"), pair)}


def assert_ids(out, want):
    np.testing.assert_array_equal(out["port"][0], want)
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])


def test_matches_plain_greedy(model, rng):
    """The seeding call and the reusing call: plain greedy's ids, logits
    within 1e-4 of plain greedy's and of JAX's."""
    ids, mask = shared_rows(rng)
    want_ids, want_lg = plain_greedy(model, ids, mask, 6)
    pair = backends(model)
    for _ in range(2):
        out = both(pair, ids, mask, 6, ["q1", "q1"])
        assert_ids(out, want_ids)
        np.testing.assert_allclose(out["port"][1], want_lg, **TOL)
        np.testing.assert_allclose(out["port"][1], out["jax"][1], **TOL)
    assert list(pair[1]._prefix_meta) == ["q1"] and pair[1]._prefix_meta["q1"]["slot"] == 0


def test_divergent_tail_never_attended(model, rng):
    """A turn's tail cached past the shared prefix must not leak into a
    later prompt that diverges there."""
    prefix = rng.randint(1, 128, size=60).astype(np.int32)
    turn1 = np.concatenate([prefix, rng.randint(1, 128, 30).astype(np.int32)])[None]
    turn2 = np.concatenate([prefix, rng.randint(1, 128, 25).astype(np.int32)])[None]
    pair = backends(model)
    both(pair, turn1, np.ones_like(turn1), 4, ["q"])     # seeds with turn 1's ids
    out = both(pair, turn2, np.ones_like(turn2), 4, ["q"])
    assert_ids(out, plain_greedy(model, turn2, np.ones_like(turn2), 4)[0])


def test_lru_eviction_stays_correct(model, rng):
    pair = backends(model, groups=2)
    prompts = {g: rng.randint(1, 128, size=70).astype(np.int32)[None] for g in "abc"}
    for _ in range(2):  # second pass: "a" was evicted by "c" and seeds again
        for g, row in prompts.items():
            out = both(pair, row, np.ones_like(row), 4, [g])
            assert_ids(out, plain_greedy(model, row, np.ones_like(row), 4)[0])
    port = pair[1]
    assert len(port._prefix_meta) == 2 and port._prefix_lru == pair[0]._prefix_lru == ["b", "c"]
    assert {g: m["slot"] for g, m in port._prefix_meta.items()} == {
        g: m["slot"] for g, m in pair[0]._prefix_meta.items()}


def test_prefix_window_narrower_than_the_pool(model, rng):
    """A 512-slot pool and a match of about 70 (a 256-slot window): plain
    greedy's ids; the pool stays 512 wide, only the gather narrows."""
    pair = backends(model, tokens=512)
    ids, mask = shared_rows(rng, prefix_len=70, tails=(10, 25))
    want, _ = plain_greedy(model, ids, mask, 5)
    for _ in range(2):
        assert_ids(both(pair, ids, mask, 5, ["q", "q"]), want)
    assert pair[1]._prefix_pool["k"][0].shape == (4, 512, CFG.num_key_value_heads, CFG.head_dim)


def test_short_match_falls_back(model, rng):
    """Rows with fewer than 16 matching tokens run with match 0."""
    pair = backends(model)
    a = rng.randint(1, 128, size=(1, 40)).astype(np.int32)
    b = rng.randint(1, 128, size=(1, 40)).astype(np.int32)
    b[0, :8] = a[0, :8]  # only 8 shared tokens
    both(pair, a, np.ones_like(a), 4, ["g"])
    want, _ = plain_greedy(model, b, np.ones_like(b), 4)
    assert_ids(both(pair, b, np.ones_like(b), 4, ["g"]), want)


def test_generator_level_plumbing(model, tmp_path):
    """prefix_groups rides generator_generate -> greedy_generate ->
    backend.greedy; the ids equal the no-prefix path's and JAX's."""
    from kirag_tpu.generation.interface import Generator as JaxGenerator
    from kirag_tpu_torch.generation.interface import Generator

    tok = make_tokenizer(tmp_path)
    if tok.pad_token_id is None:
        tok.pad_token = "[PAD]"
    pair = backends(model, tokens=64, eos=tok.eos_token_id or 3)
    inst = ["extract the triples from the passage"] * 2
    inputs = ["the cat sat on the mat", "the dog ate the bone"]
    gens = {pkg: cls(tok, be, model_name="llama", max_length=128, max_new_tokens=4, batch_size=4)
            for pkg, cls, be in (("jax", JaxGenerator, pair[0]), ("port", Generator, pair[1]))}
    plain, _ = gens["port"].generator_generate(inst, inputs, return_logits=False)
    for _ in range(2):
        got = {pkg: g.generator_generate(inst, inputs, return_logits=False,
                                         prefix_groups=["q1", "q1"])[0]
               for pkg, g in gens.items()}
        np.testing.assert_array_equal(got["port"], plain)
        np.testing.assert_array_equal(got["port"], got["jax"])
    assert list(pair[1]._prefix_meta) == ["q1"]


def test_kv_quant_pool_matches_jax(model, rng):
    """kv_quant_bits=8: the pool is int8 codes and f32 scales; the codes
    write_prefix_pool stores are JAX's, bitwise, and its scales JAX's within
    1e-6 (the packages' f32 keys and values differ in the last bit, so the
    scales, max|x| / 127, do too) and bitwise what JAX's quantizer makes of
    the port's keys and values; the prefixed ids equal JAX's prefixed run's
    and the plain int8-cache decode's."""
    tree, params = model
    ids, mask = shared_rows(rng)
    pair = backends(model, kv_bits=8)
    want, _ = plain_greedy(model, ids, mask, 4, kv_bits=8)
    for _ in range(2):
        assert_ids(both(pair, ids, mask, 4, ["q", "q"]), want)
    # write_prefix_pool alone, a right-padded prefix into the last slot of fresh pools
    config = dataclasses.replace(CFG, kv_quant_bits=8)
    prefix = np.zeros((1, 128), np.int32)
    prefix[0, :90] = ids[1, -90:]
    pmask = (prefix > 0).astype(np.int32)
    ref = jax_llm.write_prefix_pool(tree, jax_llm.alloc_prefix_pool(config, 3, 128, jnp.float32),
                                    jnp.asarray(2), jnp.asarray(prefix), jnp.asarray(pmask),
                                    config, jnp.float32)
    got = llm.write_prefix_pool(params, llm.alloc_prefix_pool(port_config(config), 3, 128,
                                                              torch.float32, "cpu"),
                                2, prefix, pmask, port_config(config), torch.float32)
    positions = torch.clamp(torch.cumsum(torch.from_numpy(pmask).long(), 1) - 1, min=0)
    empty = [torch.zeros(1, 0, CFG.num_key_value_heads, CFG.head_dim)] * CFG.num_hidden_layers
    _, ks, vs = llm.llama_block_forward(params, torch.from_numpy(prefix).long(), positions,
                                        port_config(CFG), empty, empty,
                                        torch.zeros(1, 0, dtype=torch.long),
                                        new_mask=torch.from_numpy(pmask).long(),
                                        cache_positions=positions[:, :0])
    for g, r, kv in zip(got["k"] + got["v"], ref["k"] + ref["v"], ks + vs):
        assert g["q"].dtype == torch.int8 and g["s"].dtype == torch.float32
        assert g["q"][2].any() and not g["q"][:2].any()  # the slot written, the others zero
        np.testing.assert_array_equal(g["q"].numpy(), np.asarray(r["q"]))
        scale = np.asarray(r["s"])
        assert np.abs(g["s"].numpy() - scale).max() <= 1e-6 * np.abs(scale).max()
        q, s = jax_llm._kv_quantize(jnp.asarray(kv[0].numpy()))
        np.testing.assert_array_equal(g["q"][2].numpy(), np.asarray(q))
        np.testing.assert_array_equal(g["s"][2].numpy(), np.asarray(s))
    # the backend's pool after the prefixed calls: JAX's codes
    port_pool, jax_pool = pair[1]._prefix_pool, pair[0]._prefix_pool
    for g, r in zip(port_pool["k"] + port_pool["v"], jax_pool["k"] + jax_pool["v"]):
        np.testing.assert_array_equal(g["q"].numpy(), np.asarray(r["q"]))

"""The port's greedy speculative decoding held against the JAX package.

The JAX tests' tiny target and draft (``tests/test_speculative.py``), f32,
parameters drawn by ``jax.random`` and carried across with
``llama_params_from_jax``. For each case the port's ``speculative_decode``,
``speculative_start`` and ``speculative_resume`` take the same numpy inputs
as JAX's: ids exactly equal to JAX's and to the port's ``greedy_decode``,
logits within 1e-4, the acceptance histogram equal. Then
``TorchLlamaBackend`` with a draft against ``JaxLlamaBackend`` and the plain
backend: the dispatch of greedy / start / resume, the logits-segmented
plain path, ``spec_acc_hist`` across resumes, and the refusal of an int8
KV cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kirag_tpu.models import llm as jax_llm
from kirag_tpu.models import speculative as jax_spec
from kirag_tpu_torch.models import llm, speculative

TARGET_CFG = jax_llm.LlamaConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                                 num_attention_heads=4, num_key_value_heads=2,
                                 intermediate_size=128, max_position_embeddings=256,
                                 rope_theta=10000.0)
DRAFT_CFG = jax_llm.LlamaConfig(vocab_size=128, hidden_size=32, num_hidden_layers=1,
                                num_attention_heads=2, num_key_value_heads=1,
                                intermediate_size=64, max_position_embeddings=256,
                                rope_theta=10000.0)
TOL = dict(rtol=1e-4, atol=1e-4)


def port_config(config: jax_llm.LlamaConfig) -> llm.LlamaConfig:
    return llm.LlamaConfig(**{f.name: getattr(config, f.name)
                              for f in dataclasses.fields(config)})


@pytest.fixture(scope="module")
def models():
    """Both packages' target and draft, from the same ``jax.random`` draws."""
    trees = {"t": jax_llm.init_llama_params(jax.random.PRNGKey(0), TARGET_CFG),
             "d": jax_llm.init_llama_params(jax.random.PRNGKey(7), DRAFT_CFG)}
    port = {k: llm.llama_params_from_jax(jax.tree.map(np.asarray, v), device="cpu")
            for k, v in trees.items()}
    cfgs = {"t": (TARGET_CFG, port_config(TARGET_CFG)), "d": (DRAFT_CFG, port_config(DRAFT_CFG))}
    return {"jax": {k: (trees[k], cfgs[k][0]) for k in trees},
            "port": {k: (port[k], cfgs[k][1]) for k in port}}


def prompts(b=3, t=12, seed=0):
    """Left-padded prompts, a different length each row."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 128, size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    for row in range(b):
        ids[row, :row] = 0
        mask[row, :row] = 0
    return ids, mask


def pair(models, pkg, draft):
    """(target params, config, draft params, config) of one package."""
    m = models[pkg]
    return (*m["t"], *m["t" if draft == "self" else "d"])


def both_decodes(models, draft, ids, mask, n, **kw):
    """speculative_decode of both packages with stats: {pkg: (ids, logits, hist)}."""
    out = {}
    for pkg, mod in (("jax", jax_spec), ("port", speculative)):
        script = kw.get("draft_script")
        args = dict(kw, draft_script=(None if script is None else
                                      jnp.asarray(script) if pkg == "jax" else script))
        a, lg, hist = mod.speculative_decode(*pair(models, pkg, draft), ids, mask, n,
                                             return_stats=True, **args)
        out[pkg] = (np.asarray(a), None if lg is None else np.asarray(lg), np.asarray(hist))
    return out


def port_greedy(models, ids, mask, n, **kw):
    params, config = models["port"]["t"]
    g, lg = llm.greedy_decode(params, ids, mask, config, n, **kw)
    return g.numpy(), None if lg is None else lg.numpy()


def assert_same(out, greedy_ids, greedy_logits=None):
    (j_ids, j_lg, j_hist), (p_ids, p_lg, p_hist) = out["jax"], out["port"]
    np.testing.assert_array_equal(p_ids, j_ids)
    np.testing.assert_array_equal(p_ids, greedy_ids)
    np.testing.assert_array_equal(p_hist, j_hist)
    if greedy_logits is not None:
        np.testing.assert_allclose(p_lg, j_lg, **TOL)
        np.testing.assert_allclose(p_lg, greedy_logits, **TOL)


@pytest.mark.parametrize("draft,gamma", [("self", 4), ("other", 1), ("other", 2),
                                         ("other", 3), ("other", 4)])
def test_decode_matches_jax_and_greedy(models, draft, gamma):
    """A self-draft (everything accepted) and an unrelated draft (mostly
    rejected) at every gamma: the target's greedy stream and logits."""
    ids, mask = prompts()
    out = both_decodes(models, draft, ids, mask, 14, gamma=gamma)
    assert_same(out, *port_greedy(models, ids, mask, 14))
    hist = out["port"][2]
    assert hist.sum() > 0
    if draft == "self" and gamma > 1:
        assert hist[gamma - 1] > 0


def test_eos_pads_after_finish(models):
    ids, mask = prompts()
    free, _ = port_greedy(models, ids, mask, 12, return_logits=False)
    eos = int(free[0, 2])  # row 0 finishes at its third token
    out = both_decodes(models, "other", ids, mask, 12, gamma=3, eos_token_id=eos,
                       return_logits=False)
    greedy_ids, _ = port_greedy(models, ids, mask, 12, eos_token_id=eos, return_logits=False)
    assert_same(out, greedy_ids)
    assert out["port"][1] is None
    row = out["port"][0][0]
    assert (row[int(np.argmax(row == eos)):] == eos).all()


def test_max_new_one(models):
    ids, mask = prompts(b=2, t=8)
    out = both_decodes(models, "other", ids, mask, 1, gamma=4, return_logits=True)
    assert_same(out, *port_greedy(models, ids, mask, 1))
    assert out["port"][0].shape == (2, 1) and out["port"][2].sum() == 0  # no round ran


@pytest.mark.parametrize("script", ["perfect", "every 3rd flipped", "all -1"])
def test_draft_scripts(models, script):
    """A script overrides proposals only: the stream stays greedy's, and the
    histogram shows the scripted agreement."""
    ids, mask = prompts()
    n, gamma = 24, 4
    greedy_ids, _ = port_greedy(models, ids, mask, n, return_logits=False)
    if script == "perfect":
        table = greedy_ids
    elif script == "all -1":
        table = -np.ones_like(greedy_ids)
    else:
        flip = np.arange(n)[None, :] % 3 == 2
        table = np.where(flip, (greedy_ids + 1) % TARGET_CFG.vocab_size, greedy_ids)
    out = both_decodes(models, "other", ids, mask, n, gamma=gamma, return_logits=False,
                       draft_script=table)
    assert_same(out, greedy_ids)
    hist = out["port"][2]
    if script == "perfect":
        assert hist[:gamma - 1].sum() == 0 and hist[gamma - 1] > 0
    elif script == "all -1":  # the same as no script
        plain = both_decodes(models, "other", ids, mask, n, gamma=gamma, return_logits=False)
        np.testing.assert_array_equal(hist, plain["port"][2])
    else:
        accepted = (hist * np.arange(gamma)).sum()
        assert hist[gamma - 1] == 0 and accepted / (accepted + hist[:gamma - 1].sum()) <= 2 / 3


@pytest.mark.parametrize("eos", [False, True])
def test_segmented_resumes(models, eos):
    """start + uneven resumes: the greedy stream, JAX's segments; rounds that
    overshoot a segment keep their surplus for the next."""
    ids, mask = prompts()
    total, gamma, segments = (12, 3, (4, 4, 3)) if eos else (16, 4, (3, 5, 7))
    free, _ = port_greedy(models, ids, mask, total, return_logits=False)
    eos_id = int(free[1, 3]) if eos else None
    greedy_ids, _ = port_greedy(models, ids, mask, total, eos_token_id=eos_id,
                                return_logits=False)
    got = {}
    for pkg, mod in (("jax", jax_spec), ("port", speculative)):
        args = pair(models, pkg, "other")
        first, st = mod.speculative_start(*args, ids, mask, total, gamma=gamma,
                                          eos_token_id=eos_id)
        parts = [np.asarray(first)]
        for n in segments:
            seg, st = mod.speculative_resume(*args, st, n, total, gamma=gamma,
                                             eos_token_id=eos_id)
            parts.append(np.asarray(seg))
        got[pkg] = (np.concatenate(parts, axis=1), np.asarray(st["acc_hist"]))
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    np.testing.assert_array_equal(got["port"][0], greedy_ids)
    np.testing.assert_array_equal(got["port"][1], got["jax"][1])
    # past the budget: pad tokens, not old stream positions
    tail, _ = speculative.speculative_resume(*pair(models, "port", "other"), st, 3, total,
                                             gamma=gamma, eos_token_id=eos_id)
    np.testing.assert_array_equal(tail.numpy(), np.full((3, 3), eos_id or 0))


def backends(models):
    """Both packages' backend with the draft, and the port's plain one."""
    (tj, cj), (dj, dcj) = models["jax"]["t"], models["jax"]["d"]
    (tp, cp), (dp, dcp) = models["port"]["t"], models["port"]["d"]
    common = dict(eos_token_id=999, prompt_buckets=(16,), spec_gamma=3)
    return (jax_llm.JaxLlamaBackend(tj, cj, compute_dtype=jnp.float32, draft_params=dj,
                                    draft_config=dcj, **common),
            llm.TorchLlamaBackend(tp, cp, compute_dtype=torch.float32, draft_params=dp,
                                  draft_config=dcp, **common),
            llm.TorchLlamaBackend(tp, cp, eos_token_id=999, compute_dtype=torch.float32,
                                  prompt_buckets=(16,)))


def test_backend_greedy_dispatch(models):
    jax_be, spec, plain = backends(models)
    ids, mask = prompts()
    p_ids, p_lg = plain.greedy(ids, mask, 10)
    s_ids, s_lg = spec.greedy(ids, mask, 10)
    j_ids, j_lg = jax_be.greedy(ids, mask, 10)
    np.testing.assert_array_equal(s_ids, p_ids)
    np.testing.assert_array_equal(s_ids, j_ids)
    np.testing.assert_allclose(s_lg, p_lg, **TOL)
    np.testing.assert_allclose(s_lg, j_lg, **TOL)
    np.testing.assert_array_equal(spec.spec_acc_hist, jax_be.spec_acc_hist)
    assert spec.spec_acc_hist.sum() > 0 and not spec.supports_prefix_cache


@pytest.mark.parametrize("scripted", [False, True])
def test_backend_segmented_dispatch_and_hist(models, scripted):
    """greedy_start / greedy_resume with a draft run the speculative state
    ``(st, total, script, hist)``; ``spec_acc_hist`` adds each resume's
    rounds, as JAX's backend does."""
    jax_be, spec, plain = backends(models)
    ids, mask = prompts()
    n = 12
    want, _ = plain.greedy(ids, mask, n, return_logits=False)
    if scripted:  # perfect agreement: every round accepts 2 of 2
        for be in (jax_be, spec):
            be.draft_script_fn = lambda i, m: want
    got = {}
    for name, be in (("jax", jax_be), ("port", spec)):
        first, lg, st = be.greedy_start(ids, mask, n, return_logits=False)
        assert lg is None and isinstance(st, tuple) and "served" in st[0]
        parts, hists = [first], []
        for k in (5, 6):
            seg, _, st = be.greedy_resume(st, k, return_logits=False)
            parts.append(seg)
            hists.append(be.spec_acc_hist.copy())
        got[name] = (np.concatenate(parts, axis=1), hists)
    np.testing.assert_array_equal(got["port"][0], want)
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    np.testing.assert_array_equal(np.array(got["port"][1]), np.array(got["jax"][1]))
    assert spec.spec_acc_hist.sum() > 0
    if scripted:
        assert spec.spec_acc_hist[:2].sum() == 0


def test_backend_logits_segmented_takes_the_plain_path(models):
    _, spec, plain = backends(models)
    ids, mask = prompts()
    first, lg, st = spec.greedy_start(ids, mask, 5, return_logits=True)
    p_first, p_lg, p_st = plain.greedy_start(ids, mask, 5, return_logits=True)
    assert isinstance(st, dict) and lg is not None
    seg, lg2, _ = spec.greedy_resume(st, 4, return_logits=True)
    p_seg, p_lg2, _ = plain.greedy_resume(p_st, 4, return_logits=True)
    np.testing.assert_array_equal(np.concatenate([first, seg], 1),
                                  np.concatenate([p_first, p_seg], 1))
    np.testing.assert_allclose(lg2, p_lg2, **TOL)
    assert spec.spec_acc_hist.sum() == 0


def test_kv_quant_cache_refused(models):
    """As the reference: an int8 cache rounds the cached slots but not the
    verify window's, so the stream would leave greedy's."""
    (tp, cp), (dp, dcp) = models["port"]["t"], models["port"]["d"]
    q = dataclasses.replace(cp, kv_quant_bits=8)
    with pytest.raises(ValueError, match="full-precision KV cache"):
        llm.TorchLlamaBackend(tp, q, 0, draft_params=dp, draft_config=dcp)
    with pytest.raises(ValueError, match="full-precision KV cache"):
        llm.TorchLlamaBackend(tp, cp, 0, draft_params=dp,
                              draft_config=dataclasses.replace(dcp, kv_quant_bits=8))
    ids, mask = prompts()
    with pytest.raises(ValueError, match="full-precision KV cache"):
        speculative.speculative_decode(tp, q, dp, dcp, ids, mask, 4)
    with pytest.raises(ValueError, match="tokenizer/vocab"):
        llm.TorchLlamaBackend(tp, cp, 0, draft_params=dp,
                              draft_config=dataclasses.replace(dcp, vocab_size=64))


@pytest.mark.parametrize("past", [0, 1, 6])
def test_resume_at_and_past_the_reserved_budget(models, past):
    """``speculative_start`` reserves a budget of B tokens. At the budget
    both packages serve greedy's stream. Past it the reference's
    ``while_loop`` runs on and JAX drops the writes that leave the reserved
    cache and stream buffer: one past the budget its stream here is still
    greedy's, but from B + gamma on it pads with 0 where greedy goes on, so
    a resume past the budget gives no stream contract. The port refuses
    every resume past the budget instead."""
    ids, mask = prompts()
    budget, gamma = 10, 4
    total = budget + past
    greedy_ids, _ = port_greedy(models, ids, mask, total, return_logits=False)
    served = {}
    for pkg, mod in (("jax", jax_spec), ("port", speculative)):
        args = pair(models, pkg, "other")
        first, st = mod.speculative_start(*args, ids, mask, budget, gamma=gamma)
        if pkg == "port" and past:
            with pytest.raises(ValueError, match="passes the budget of 10"):
                mod.speculative_resume(*args, st, total - 1, total, gamma=gamma)
            continue
        seg, _ = mod.speculative_resume(*args, st, total - 1, total, gamma=gamma)
        served[pkg] = np.concatenate([np.asarray(first), np.asarray(seg)], axis=1)
    if past == 0:
        np.testing.assert_array_equal(served["port"], served["jax"])
        np.testing.assert_array_equal(served["port"], greedy_ids)
    elif past == 1:
        np.testing.assert_array_equal(served["jax"], greedy_ids)
    else:  # the reference's stream buffer ends at column B + gamma
        np.testing.assert_array_equal(served["jax"][:, :budget + gamma],
                                      greedy_ids[:, :budget + gamma])
        assert (served["jax"][:, budget + gamma:] == 0).all()
        assert (greedy_ids[:, budget + gamma:] != 0).any()

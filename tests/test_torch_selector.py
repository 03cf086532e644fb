"""The port's ``TripleSelector`` (``pipeline/selector.py``) held against the
JAX package.

- ``get_option_token_id_to_option_map`` is identical (one-token options
  only, the smaller option first on a shared token);
- ``get_option_tokens_probs`` is within 1e-7 of JAX's on seeded logits,
  rows without an option token NaN in both;
- ``select``, ``select_wo_selector`` and ``retrieve`` give JAX's chains,
  scores (within 1e-6) and documents at ``num_beams`` 1 and 3, over the tiny
  corpus, encoder and KG stub of test_torch_pipeline.py, with a selector
  stub whose logits carry seeded noise so that several options keep
  probability.
"""

import re

import numpy as np
import pytest

from kirag_tpu.pipeline import TripleSelector as JaxTripleSelector
from kirag_tpu_torch.pipeline import TripleSelector

from tests.helpers import make_tokenizer
from tests.test_torch_pipeline import PKG, build_stack

SELECTOR = {"jax": JaxTripleSelector, "port": TripleSelector}


class NoisyLogits:
    """A backend over a stub whose logits get seeded noise, call by call:
    the same sequence in both packages. Its ids are the stub's."""

    def __init__(self, backend, seed=0, scale=4.0):
        self.backend, self.rng, self.scale = backend, np.random.RandomState(seed), scale
        self.eos_token_id = backend.eos_token_id
        self.calls = backend.calls

    def greedy(self, input_ids, attention_mask, max_new_tokens, return_logits=True):
        ids, logits = self.backend.greedy(input_ids, attention_mask, max_new_tokens, True)
        logits = logits + self.scale * self.rng.randn(*logits.shape).astype(np.float32)
        return ids, (logits if return_logits else None)


def selector_rule(prompt):
    """Pick the first candidate that names the question's entity, else the
    second, and stop ("0") once the chain holds two triples."""
    q = re.findall(r"w\d+", prompt.lower().split("question :")[-1])[0]
    menu = prompt.lower().split("candidate knowledge triples :")[-1]
    existing = prompt.lower().split("existing knowledge triples :")[-1].split("candidate")[0]
    if existing.count("<") >= 2:
        return "0"
    for line in menu.split("\n"):
        m = re.match(r"\s*(\d+) \. .*" + q + r"\b", line)
        if m and m.group(1) != "0":
            return m.group(1)
    return "2"


def build(tmp_path, name):
    kirag, corpus = build_stack(tmp_path, name)
    tok = kirag.constructor.tokenizer
    constructor = PKG[name]["stub"](tok, rules=[(lambda p: "candidate" in p.lower(),
                                                 selector_rule)], max_new_tokens=8)
    constructor.backend = NoisyLogits(constructor.backend)
    selector = SELECTOR[name](
        retriever=kirag.retriever, kg_generator=kirag.kg_generator, constructor=constructor,
        aligner=kirag.aligner, examplar_type="hotpotqa", adaptive_examplars=False,
        num_turns=3, topk=3, num_candidate_triples=5)
    return selector, corpus


def assert_same_chains(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["triples"] == w["triples"] and g["finished"] == w["finished"]
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-6, atol=1e-6)
        if "triple_filter_scores" in w:
            np.testing.assert_allclose(g["triple_filter_scores"], w["triple_filter_scores"],
                                       rtol=1e-6, atol=1e-6)


def test_option_map_matches_jax(tmp_path):
    selectors = {name: build(tmp_path, name)[0] for name in SELECTOR}
    for n in (1, 4, 10, 13, 30):
        maps = {name: s.get_option_token_id_to_option_map(n) for name, s in selectors.items()}
        assert maps["port"] == maps["jax"] and maps["port"]


def test_option_probs_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    selectors = {name: build(tmp_path, name)[0] for name in SELECTOR}
    tok = make_tokenizer(tmp_path)
    vocab = tok.vocab_size
    rows = ["w3 2 7", "alpha 0", "beta gamma", "5", ""]
    ids = np.full((len(rows), 6), tok.pad_token_id, np.int32)
    for i, r in enumerate(rows):
        t = tok(r, add_special_tokens=False)["input_ids"][:6]
        ids[i, :len(t)] = t
    logits = (3 * rng.randn(len(rows), 6, vocab)).astype(np.float32)
    for n in (3, 8):
        out = {name: s.get_option_tokens_probs(ids, logits, n) for name, s in selectors.items()}
        (g_opts, g_probs), (w_opts, w_probs) = out["port"], out["jax"]
        assert g_opts == w_opts
        np.testing.assert_array_equal(np.isnan(g_probs), np.isnan(w_probs))
        np.testing.assert_allclose(g_probs, w_probs, rtol=0, atol=1e-7, equal_nan=True)
        option_ids = selectors["port"].get_option_token_id_to_option_map(n)
        has_option = np.isin(ids, list(option_ids)).any(axis=1)
        assert has_option.any() and not has_option.all()
        assert (np.isnan(g_probs).all(axis=1) == ~has_option).all()
        np.testing.assert_allclose(g_probs[has_option].sum(axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("num_beams", [1, 3])
def test_select_and_select_wo_selector_match_jax(tmp_path, num_beams):
    out = {}
    for name in SELECTOR:
        selector, corpus = build(tmp_path, name)
        question = corpus[4]["passage"]
        docs = selector.kg_generator(selector.retriever.get_documents(
            {corpus[i]["passage_id"]: 1.0 for i in range(5)}))
        step1 = selector.select(question, docs, num_beams=num_beams)
        step2 = selector.select(question, docs, existing_reasoning_chains=step1,
                                num_beams=num_beams, max_num_chains=4)
        wo1 = selector.select_wo_selector(question, docs, num_beams=num_beams,
                                          return_triple_filter_scores=True)
        wo2 = selector.select_wo_selector(question, docs, existing_reasoning_chains=wo1,
                                          num_beams=num_beams, max_num_chains=4,
                                          return_triple_filter_scores=True)
        out[name] = (step1, step2, wo1, wo2, selector.constructor.backend.calls)
    for got, want in zip(out["port"][:4], out["jax"][:4]):
        assert_same_chains(got, want)
    assert out["port"][4] == out["jax"][4]
    assert any(c["triples"] for c in out["port"][0])
    if num_beams == 3:
        assert len(out["port"][0]) > 1  # the noisy options kept more than one beam


@pytest.mark.parametrize("num_beams", [1, 3])
@pytest.mark.parametrize("use_llm_selector", [True, False])
def test_retrieve_matches_jax(tmp_path, num_beams, use_llm_selector):
    out = {}
    for name in SELECTOR:
        selector, corpus = build(tmp_path, name)
        out[name] = [selector.retrieve(corpus[i]["passage"], num_beams=num_beams,
                                       max_num_chains=3, use_llm_selector=use_llm_selector)
                     for i in (4, 9)]
    for (g_chains, g_docs), (w_chains, w_docs) in zip(out["port"], out["jax"]):
        assert_same_chains(g_chains, w_chains)
        assert list(g_docs) == list(w_docs)
        np.testing.assert_allclose(list(g_docs.values()), list(w_docs.values()),
                                   rtol=1e-6, atol=1e-6)
    assert any(c["triples"] for c, _ in out["port"] for c in c)

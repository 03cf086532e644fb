"""The port's KiRAG loop held against the JAX package.

- ``Generator`` over the rule-based ``StubBackend``: forced prefixes spliced
  at the token level, segmented stop words, text trimming;
- ``KGGenerator`` (examplar ranking, the pickle cache) and ``KiRAG.retrieve``
  / ``retrieve_batch`` on a tiny corpus, with the encoder carried across by
  ``Encoder.from_jax``: the same chains, documents in the same order, scores
  within 1e-5 (f32 encoders, sums in another order);
- both packages' ``cli/retrieve.py`` on a tiny on-disk workspace give the
  same results json, also with ``--draft_llm`` and
  ``--llm_prefix_cache_groups``.
"""

import pickle
import re
import sys

import jax
import numpy as np
import pytest
import torch

from kirag_tpu.data import E5Collator as JaxE5Collator
from kirag_tpu.data import HotPotQA as JaxHotPotQA
from kirag_tpu.generation import make_stub_generator as jax_make_stub_generator
from kirag_tpu.index import TPUIndexer
from kirag_tpu.kg import KGGenerator as JaxKGGenerator
from kirag_tpu.pipeline import KiRAG as JaxKiRAG
from kirag_tpu.retrieval import DenseRetriever as JaxDenseRetriever
from kirag_tpu.utils.io import hash_object as jax_hash_object
from kirag_tpu_torch.data import E5Collator, HotPotQA
from kirag_tpu_torch.evaluation import f1_score
from kirag_tpu_torch.generation import make_stub_generator
from kirag_tpu_torch.index import TorchIndexer
from kirag_tpu_torch.kg import KGGenerator
from kirag_tpu_torch.models import BertConfig, Encoder
from kirag_tpu_torch.pipeline import KiRAG
from kirag_tpu_torch.retrieval import DenseRetriever
from kirag_tpu_torch.utils.io import hash_object

from tests.helpers import make_corpus_json, make_tiny_encoder, make_tokenizer
from tests.torch_cli_helpers import cli_workspace, run_retrieve_clis, torch_threads  # noqa: F401

PKG = {
    "jax": dict(stub=jax_make_stub_generator, kg=JaxKGGenerator, kirag=JaxKiRAG,
                retriever=JaxDenseRetriever, collator=JaxE5Collator, corpus=JaxHotPotQA),
    "port": dict(stub=make_stub_generator, kg=KGGenerator, kirag=KiRAG,
                 retriever=DenseRetriever, collator=E5Collator, corpus=HotPotQA),
}


def kg_rule():
    """Every KG-construction prompt: a triple from the document's title."""
    def match(prompt):
        return "knowledge" in prompt and "title :" in prompt

    def respond(prompt):
        m = re.findall(r"title : (w\d+)", prompt)
        n = int(m[-1][1:]) if m else 0
        return f"< w{n} ; is ; w{n + 100} >"

    return (match, respond)


def constructor_rule(prompt):
    """Keyed on the question and the forced Thought, so the sequential and
    the batched loops see the same responses."""
    seg = prompt.lower().split("question :")[-1]
    m = re.findall(r"w(\d+)", seg)
    n = int(m[0]) if m else 0
    if n == 9:
        return ""                                   # question 9 stops after turn 1
    if f"w{n + 150}" in seg:
        return "so the answer is : w%d" % (n + 100)
    return f"< w{n} ; is ; w{n + 150} >"


def test_metrics_and_hash_match_jax():
    from kirag_tpu.evaluation.metrics import f1_score as jax_f1, normalize_answer as jax_norm
    from kirag_tpu_torch.evaluation import normalize_answer

    pairs = [("The Eiffel Tower!", "eiffel tower"), ("yes", "no"), ("an apple a day", "apple"),
             ("Zürich, the city", "zurich city"), ("", "x"), ("noanswer", "noanswer")]
    for a, b in pairs:
        assert normalize_answer(a) == jax_norm(a)
        assert f1_score(a, b) == jax_f1(a, b)
    for obj in ({"title": "w1", "text": "<a; b; c>", "reference": ["doc1", 0]},
                [1, 2.5, None, "ü"], {"n": np.arange(3)}, {}, b"\x00\x01"):
        assert hash_object(obj) == jax_hash_object(obj)


MIXED_SCRIPT = [
    "Café Müller, São Paulo — 1984!", "Москва́ — столица России (ru).", "東京は日本の首都です。",
    "नमस्ते दुनिया १२३", "مرحبا بالعالم ٣", "emoji 👩\u200d💻 tab\tzero\u200bwidth",
    "Ⅻ ⓐⒶ x²+y₂ ½", "İstanbul ǅ ß ﬁne", "Ελληνικά: Ἀθῆναι",
]


def test_has_answer_and_regex_match_match_jax():
    """The port's tokenizer (unicodedata categories and the standard ``re``)
    against the reference's (the ``regex`` package) on mixed-script text."""
    from kirag_tpu.evaluation import metrics as jax_metrics
    from kirag_tpu_torch.evaluation import has_answer
    from kirag_tpu_torch.evaluation import metrics

    for text in MIXED_SCRIPT:
        assert metrics._tokenize_words(metrics._nfd(text)) == \
            jax_metrics._tokenize_words(jax_metrics._nfd(text))
    cases = [(["sao paulo"], MIXED_SCRIPT[0]), (["Москва"], MIXED_SCRIPT[1]),
             (["столица россии"], MIXED_SCRIPT[1]), (["１２３", "१२३"], MIXED_SCRIPT[3]),
             (["istanbul"], MIXED_SCRIPT[7]), (["Αθηναι"], MIXED_SCRIPT[8]),
             (["dunya"], MIXED_SCRIPT[3]), (["", "x"], "y x z"), (["1984"], MIXED_SCRIPT[0])]
    for answers, text in cases:
        assert has_answer(answers, text) == jax_metrics.has_answer(answers, text), answers
    patterns = [r"s[aã]o\s+paulo", r"^москва", r"\d{4}", r"(unclosed", r"ΑΘΗΝΑΙ|Ἀθῆναι"]
    for pattern in patterns:
        for text in MIXED_SCRIPT:
            assert metrics.regex_match(text, pattern) == jax_metrics.regex_match(text, pattern)
            assert has_answer([pattern], text, "regex") == \
                jax_metrics.has_answer([pattern], text, "regex")
    # the documented difference: a property class compiles only in `regex`
    assert jax_metrics.regex_match("abc", r"\p{L}+") and not metrics.regex_match("abc",
                                                                                r"\p{L}+")


def test_generator_over_stub_matches_jax(tmp_path):
    tok = make_tokenizer(tmp_path)
    rules = [("alpha", "w1 is the city . question : w2"), ("beta", "< w3 ; of ; w4 > and more")]
    outs = {}
    for name, pkg in PKG.items():
        gen = pkg["stub"](tok, rules=rules, default_response="w9 w9 w9 w9",
                          max_new_tokens=12, stop_check_every=3)
        ids, logits = gen.generator_generate(
            ["inst", "inst", "inst"], ["alpha w5", "beta", "gamma"],
            current_generated_texts=["Thought: w1 .", "", "Thought:"])
        texts = gen.generate_texts(["inst"] * 3, ["alpha", "beta", "gamma"],
                                   stop_words=["question", ";"])
        seg_ids, _ = gen.greedy_generate(gen.tokenizer_encode(["alpha", "beta w2"]),
                                         stop_words=["city"], return_logits=False)
        outs[name] = (ids, logits, texts, seg_ids, gen.backend.calls)
    for got, want in zip(outs["port"], outs["jax"]):
        if isinstance(got, np.ndarray):
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want


def build_stack(tmp_path, pkg_name, cache_path=None):
    """One package's KiRAG over the tiny corpus: the same tokenizer, encoder
    parameters, documents and stub LLMs in both packages."""
    pkg = PKG[pkg_name]
    tok = make_tokenizer(tmp_path)
    jax_enc = make_tiny_encoder(vocab_size=tok.vocab_size)
    if pkg_name == "jax":
        enc = jax_enc
        indexer = TPUIndexer(enc.embedding_size, chunk_size=32)
    else:
        enc = Encoder.from_jax(jax.tree.map(np.asarray, jax_enc.params),
                               BertConfig(**jax_enc.config.__dict__), "e5", device="cpu")
        indexer = TorchIndexer(enc.embedding_size, device="cpu")
    collator = pkg["collator"](tokenizer=tok, query_maxlength=64, doc_maxlength=64)
    path, _ = make_corpus_json(tmp_path)
    corpus = pkg["corpus"](title_prefix="title:", passage_prefix="text:", corpus_path=path)
    retriever = pkg["retriever"](enc, collator, indexer=indexer, corpus=corpus, batch_size=8)
    indexer.index_data([corpus[i]["passage_id"] for i in range(len(corpus))],
                       retriever.calculate_document_embeddings(
                           [corpus[i]["passage"] for i in range(len(corpus))]))
    aligner = pkg["retriever"](enc, collator, batch_size=8)
    kg_llm = pkg["stub"](tok, rules=[kg_rule()])
    kg_generator = pkg["kg"](kg_llm, examplar_type="hotpotqa", embedder=aligner,
                             max_length=2048, batch_size=4)
    if cache_path is not None:
        kg_generator.load_cached_kg_triples(cache_path)
    constructor = pkg["stub"](tok, rules=[(lambda p: "question :" in p.lower(),
                                          constructor_rule)], max_new_tokens=64)
    kirag = pkg["kirag"](retriever=retriever, kg_generator=kg_generator,
                         constructor=constructor, aligner=aligner, examplar_type="hotpotqa",
                         num_turns=3, topk=3, num_candidate_triples=5)
    return kirag, corpus


def assert_same_results(got, want):
    assert len(got) == len(want)
    for (g_chains, g_docs), (w_chains, w_docs) in zip(got, want):
        assert g_chains == w_chains
        assert list(g_docs) == list(w_docs)
        np.testing.assert_allclose(list(g_docs.values()), list(w_docs.values()),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_beams", [1, 2])
def test_kirag_retrieve_and_batch_match_jax(tmp_path, num_beams):
    results = {}
    for name in PKG:
        kirag, corpus = build_stack(tmp_path, name)
        questions = [corpus[i]["passage"].replace("title :", "") for i in (5, 9, 2)]
        seq = [kirag.retrieve(q, num_beams=num_beams) for q in questions]
        kirag, _ = build_stack(tmp_path, name)
        results[name] = (seq, kirag.retrieve_batch(questions, num_beams=num_beams))
    assert_same_results(results["port"][0], results["jax"][0])
    assert_same_results(results["port"][1], results["jax"][1])
    assert_same_results(results["port"][1], results["port"][0])
    assert results["port"][0][0][0][0][0].startswith("<w5")  # a chain was built


def test_kg_generator_and_cache_match_jax(tmp_path):
    docs_out, cached = {}, {}
    for name in PKG:
        cache = str(tmp_path / f"{name}.pkl")
        kirag, corpus = build_stack(tmp_path, name, cache_path=cache)
        kg = kirag.kg_generator
        docs = [dict(corpus.get_document(f"doc{i}")) for i in (1, 4, 7, 11, 13)]
        calls = len(kg.generator.backend.calls)
        docs_out[name] = kg(docs)
        again = kg(docs)                                # served from the cache
        assert len(kg.generator.backend.calls) == calls + 2 and again == docs_out[name]
        kg.save_cached_kg_triples(cache)
        with open(cache, "rb") as f:
            cached[name] = pickle.load(f)
    assert docs_out["port"] == docs_out["jax"]
    assert cached["port"] == cached["jax"]
    assert docs_out["port"][0]["triples"][0]["text"].startswith("<w1 ; is ; w101")


# ------------------------------------------------------------------ the CLIs


def test_retrieve_cli_approx_and_retrieval_eval_match_jax(cli_workspace, monkeypatch):
    """``--search_mode approx --approx_winners 2``: the KiRAG results of both
    packages agree, and both packages' ``cli/retrieval_eval`` read the
    port's results file alike (qrels and answer presence)."""
    from kirag_tpu.cli import retrieval_eval as jax_eval
    from kirag_tpu_torch.cli import retrieval_eval

    ws = cli_workspace
    # one device for JAX too: its 8-device test mesh would shard the 20-row
    # index into shards smaller than a 128-row group
    paths, results = run_retrieve_clis(ws, monkeypatch,
                                       extra=("--search_mode", "approx", "--approx_winners", "2",
                                              "--mesh_data", "1"))
    got, want = results["port"], results["jax"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["paths"] == w["paths"] and len(g["ctxs"]) > 0
        assert [c["id"] for c in g["ctxs"]] == [c["id"] for c in w["ctxs"]]
        np.testing.assert_allclose([c["score"] for c in g["ctxs"]],
                                   [c["score"] for c in w["ctxs"]], rtol=1e-5, atol=1e-5)
    qrels = ws["root"] / "qrels.tsv"
    qrels.write_text("q0\tdoc3\t1\nq0\tdoc5\t1\nq1\tdoc7\t1\nq1\tdoc9\t0\n")
    assert retrieval_eval.load_qrels(str(qrels)) == jax_eval.load_qrels(str(qrels))
    for argv in (["--dataset", "2wikimultihopqa", "--qrels", str(qrels), "--k", "3"],
                 ["--dataset", "nq", "--k", "2"], ["--dataset", "nq", "--k", "10"]):
        metrics = retrieval_eval.main(["--save_file", paths["port"], *argv])
        monkeypatch.setattr(sys, "argv", ["prog", "--save_file", paths["port"], *argv])
        jax_eval.main()
        want_metrics = (jax_eval.evaluate_with_qrels(got, jax_eval.load_qrels(str(qrels)), 3)
                        if "--qrels" in argv else
                        jax_eval.evaluate_answer_presence(got, int(argv[-1])))
        assert metrics == want_metrics
    assert retrieval_eval.evaluate_answer_presence(got, 10)["Recall@10"] > 0


def assert_same_cli_results(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["paths"] == w["paths"]
        assert [c["id"] for c in g["ctxs"]] == [c["id"] for c in w["ctxs"]]
        np.testing.assert_allclose([c["score"] for c in g["ctxs"]],
                                   [c["score"] for c in w["ctxs"]], rtol=1e-5, atol=1e-5)
        assert ({k: v for k, v in g.items() if k != "ctxs"}
                == {k: v for k, v in w.items() if k != "ctxs"})
        assert len(g["ctxs"]) > 0


@pytest.mark.parametrize("concurrent,cached", [(1, False), (2, True)])
def test_retrieve_cli_matches_jax(cli_workspace, monkeypatch, concurrent, cached):
    _, results = run_retrieve_clis(cli_workspace, monkeypatch, concurrent, cached)
    got = results["port"]
    assert_same_cli_results(got, results["jax"])
    if cached:  # the triples ranked the documents and the constructor ran
        assert all(g["paths"] == [[""]] for g in got)


@pytest.mark.parametrize("option", ["draft_llm", "llm_prefix_cache_groups"])
def test_retrieve_cli_draft_and_prefix_pool_match_jax(cli_workspace, monkeypatch, option):
    """``--draft_llm`` (the tiny Llama as its own draft) and
    ``--llm_prefix_cache_groups 2``, over the cached KG so that the
    constructor runs: both packages' results files agree, and the port's
    constructor decoded through speculative decoding or the prefix pool."""
    from kirag_tpu_torch.models import llm, speculative

    ws = cli_workspace
    value = ws["llm_dir"] if option == "draft_llm" else "2"
    module, name = ((speculative, "speculative_decode") if option == "draft_llm"
                    else (llm, "greedy_decode_prefixed"))
    calls, fn = [], getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    with torch_threads(1):
        _, results = run_retrieve_clis(ws, monkeypatch, concurrent=1, cached=True,
                                       extra=(f"--{option}", value))
    assert_same_cli_results(results["port"], results["jax"])
    assert calls


def test_retrieve_cli_refuses_what_is_not_ported(cli_workspace):
    from kirag_tpu_torch.cli import retrieve

    ws = cli_workspace
    base = ["--dataset", "hotpotqa", "--query_file", "q.json", "--index_folder", ws["index"],
            "--retriever_model_name_or_path", ws["enc_dir"], "--llm", ws["llm_dir"],
            "--aligner_model_name_or_path", ws["enc_dir"], "--save_dir",
            str(ws["root"] / "refused"), "--save_file", "r.json"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        retrieve.main(base + ["--mesh_model", "2"], device="cpu")
    if not torch.cuda.is_available():  # without device="cpu" the CLI runs on the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            retrieve.main(base)

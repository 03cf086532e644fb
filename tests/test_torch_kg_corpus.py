"""The port's ``cli/construct_kg_corpus.py`` held against the JAX CLI.

Both CLIs extract triples for documents 1-6 of a 20-document corpus
(``--start 1 --end 7 --batch_size 2 --save_every 1``) into a cache file
that already holds one of them, first over the rule-based stub backend
(swapped in for each package's Llama backend), then over the tiny zero-norm
Llama checkpoint of ``cli_workspace`` (both CLIs decode its 512 new tokens
in bf16). The cache pickles are equal, the cache is saved after every batch,
and the port's CLI runs on the GPU unless given ``device="cpu"``.
"""

import pickle
import re
import sys

import pytest
import torch

import kirag_tpu.kg.kg_generator as jax_kg
import kirag_tpu.models.llm as jax_llm
import kirag_tpu_torch.kg.kg_generator as port_kg
import kirag_tpu_torch.models.llm as port_llm
from kirag_tpu.cli import construct_kg_corpus as jax_cli
from kirag_tpu.generation import StubBackend as JaxStubBackend
from kirag_tpu_torch.cli import construct_kg_corpus
from kirag_tpu_torch.generation import StubBackend

from tests.torch_cli_helpers import cli_workspace, torch_threads  # noqa: F401


def kg_rule():
    """Every KG-construction prompt: a triple from the document's title."""
    def match(prompt):
        return "knowledge" in prompt and "title :" in prompt

    def respond(prompt):
        n = int(re.findall(r"title : w(\d+)", prompt)[-1])
        return f"< w{n} ; is ; w{n + 100} > < w{n + 100} ; of ; w{n} >"

    return (match, respond)


def seeded_cache(path):
    """A cache that already holds document 3 (the CLIs must not redo it)."""
    with open(path, "wb") as f:
        pickle.dump({"doc3": {"id": "doc3", "title": "w3", "triples": [
            {"text": "<w3; cached; w3>", "sentence": 0}]}}, f)


def run_both(ws, monkeypatch, tag, stub):
    """Both CLIs on the workspace; returns {package: (cache, saves)}."""
    import transformers

    tok = transformers.AutoTokenizer.from_pretrained(ws["llm_dir"])
    out = {}
    for name, kg_mod in (("jax", jax_kg), ("port", port_kg)):
        cache = ws["root"] / f"kg_corpus_{tag}_{name}.pkl"
        seeded_cache(cache)
        saves = []
        save = kg_mod.KGGenerator.save_cached_kg_triples
        monkeypatch.setattr(kg_mod.KGGenerator, "save_cached_kg_triples",
                            lambda self, path, save=save: saves.append(path) or save(self, path))
        argv = ["--corpus", "2wikimultihopqa", "--corpus_path", ws["corpus_path"],
                "--dataset", "hotpotqa", "--llm", ws["llm_dir"], "--cached_kg_triples_file",
                str(cache), "--batch_size", "2", "--save_every", "1", "--start", "1",
                "--end", "7"]
        if name == "jax":
            if stub:
                monkeypatch.setattr(jax_llm, "load_llama", lambda *a, **k: (None, None))
                monkeypatch.setattr(jax_llm, "JaxLlamaBackend",
                                    lambda *a, **k: JaxStubBackend(tok, rules=[kg_rule()]))
            monkeypatch.setattr(sys, "argv", ["prog"] + argv)
            jax_cli.main()
        else:
            if stub:
                monkeypatch.setattr(port_llm, "TorchLlamaBackend",
                                    lambda *a, **k: StubBackend(tok, rules=[kg_rule()]))
                pair = (None, None)
            else:
                pair = port_llm.load_llama(ws["llm_dir"], compute_dtype=torch.bfloat16,
                                           device="cpu")
            assert construct_kg_corpus.main(argv, llm_tokenizer=tok, llm=pair,
                                            device="cpu") == str(cache)
        with open(cache, "rb") as f:
            out[name] = (pickle.load(f), saves)
    return out


@pytest.mark.parametrize("backend", ["stub", "tiny llama"])
def test_construct_kg_corpus_matches_jax(cli_workspace, monkeypatch, backend):
    with torch_threads(1):
        out = run_both(cli_workspace, monkeypatch, backend.replace(" ", "_"), backend == "stub")
    (got, got_saves), (want, want_saves) = out["port"], out["jax"]
    assert got == want
    assert sorted(got) == [f"doc{i}" for i in range(1, 7)]
    assert got["doc3"]["triples"] == [{"text": "<w3; cached; w3>", "sentence": 0}]
    assert len(got_saves) == len(want_saves) == 4        # after each of 3 batches, and at the end
    if backend == "stub":
        assert got["doc1"]["triples"][0]["text"].startswith("<w1 ; is ; w101")


def test_construct_kg_corpus_runs_on_the_gpu_by_default(cli_workspace, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no GPU")
    ws = cli_workspace
    with pytest.raises(RuntimeError, match="no CUDA device"):
        construct_kg_corpus.main(["--corpus_path", ws["corpus_path"], "--llm", ws["llm_dir"],
                                  "--cached_kg_triples_file", str(tmp_path / "c.pkl")])

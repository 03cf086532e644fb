"""Shared fixtures of the port's CLI tests: a tiny workspace that both
packages' CLIs run on, both ``cli/retrieve.py`` runs over it, and a scoped
torch thread count."""

import contextlib
import json
import os
import pickle
import re
import sys

import pytest

from tests.helpers import BASE_VOCAB, WORDS, make_corpus_json


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to ``n`` for the block: a tiny model's
    decode is thousands of small ops, and on a machine whose cores other test
    workers share, each op's thread team costs more than the op."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cli_workspace(tmp_path_factory):
    """A tiny E5 checkpoint and tokenizer, a tiny Llama whose final norm is
    zero (every step's logits tie, so both packages emit token 0 at bf16
    compute: the decode is fixed and the test holds the plumbing), a corpus,
    queries, an index built by the JAX CLIs, and a KG cache of one triple
    per passage (which makes the constructor run)."""
    import torch
    import transformers

    from kirag_tpu.cli import build_index, compute_corpus_embeddings

    root = tmp_path_factory.mktemp("torch_retrieve_cli")
    (root / "vocab.txt").write_text("\n".join(BASE_VOCAB + WORDS))
    tok = transformers.BertTokenizerFast(vocab_file=str(root / "vocab.txt"),
                                         do_lower_case=True)
    torch.manual_seed(0)
    enc_dir = root / "e5-tiny"
    transformers.BertModel(transformers.BertConfig(
        vocab_size=tok.vocab_size, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=128)).save_pretrained(str(enc_dir))
    tok.save_pretrained(str(enc_dir))
    llm_dir = root / "llama-tiny-instruct"
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=tok.vocab_size, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=64, max_position_embeddings=512))
    with torch.no_grad():
        model.model.norm.weight.zero_()
    model.save_pretrained(str(llm_dir))
    tok.save_pretrained(str(llm_dir))
    corpus_path, docs = make_corpus_json(root)
    queries = [{"id": "q0", "question": "what is w3 ?", "answers": ["w103"]},
               {"id": "q1", "question": "what is w7 ?", "answers": ["w107"]}]
    (root / "queries.json").write_text(json.dumps(queries))
    cache = {d["id"]: dict(d, triples=[{"text": f"<{d['title']}; is; w{100 + i}>",
                                        "sentence": 0}])
             for i, d in enumerate(docs)}
    with open(root / "kg.pkl", "wb") as f:
        pickle.dump(cache, f)
    out = str(root / "out")
    argv = sys.argv
    try:
        sys.argv = ["prog", "--retriever_model_name_or_path", str(enc_dir), "--corpus",
                    "2wikimultihopqa", "--corpus_path", corpus_path, "--per_device_batch_size",
                    "8", "--compute_dtype", "float32", "--save_dir", out, "--name", "e5"]
        compute_corpus_embeddings.main()
        sys.argv = ["prog", "--embeddings_dir", os.path.join(out, "e5"), "--embedding_size",
                    "32", "--save_dir", os.path.join(out, "index")]
        build_index.main()
    finally:
        sys.argv = argv
    return {"root": root, "enc_dir": str(enc_dir), "llm_dir": str(llm_dir),
            "corpus_path": corpus_path, "index": os.path.join(out, "index")}


def run_retrieve_clis(ws, monkeypatch, concurrent=1, cached=False, extra=()):
    """Both packages' ``cli/retrieve.py`` on the workspace; returns their
    results files' paths and contents."""
    from kirag_tpu.cli import retrieve as jax_retrieve
    from kirag_tpu_torch.cli import retrieve

    paths, results = {}, {}
    tag = re.sub(r"[^\w.]", "_", "_".join([str(concurrent), *extra]).replace("--", ""))
    for name in ("jax", "port"):
        argv_extra = list(extra)
        if cached:
            cache = str(ws["root"] / f"kg_{name}_{tag}.pkl")
            with open(ws["root"] / "kg.pkl", "rb") as src, open(cache, "wb") as dst:
                dst.write(src.read())
            argv_extra += ["--cached_kg_triples_file", cache]
        argv = ["--dataset", "2wikimultihopqa", "--query_file", str(ws["root"] / "queries.json"),
                "--corpus", "2wikimultihopqa", "--corpus_path", ws["corpus_path"],
                "--index_folder", ws["index"], "--embedding_size", "32",
                "--retriever_model_name_or_path", ws["enc_dir"], "--compute_dtype", "float32",
                "--llm", ws["llm_dir"], "--aligner_model_name_or_path", ws["enc_dir"],
                "--num_turns", "2", "--topk", "3", "--num_candidate_triples", "5",
                "--concurrent_questions", str(concurrent), "--save_dir",
                str(ws["root"] / f"{name}_{tag}"), "--name", "kirag", "--save_file",
                "results.json", *argv_extra]
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["prog"] + argv)
            jax_retrieve.main()
            paths[name] = str(ws["root"] / f"{name}_{tag}" / "kirag" / "results.json")
        else:
            paths[name] = retrieve.main(argv, device="cpu")
        with open(paths[name]) as f:
            results[name] = json.load(f)
    return paths, results

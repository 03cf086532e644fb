"""``cli/retrieve --mesh_data 2`` and ``--mesh_model 2`` over two gloo ranks
on the CPU against the JAX CLI with the same flags.

The whole ``cli/retrieve`` at ``--mesh_data 2`` against the JAX CLI costs
well over a minute here (an LLM decode in both packages), so this file holds
the part the mesh changes: ``setup_retriever_model`` (the CLI's
``build_mesh`` -> ``TorchIndexer(mesh=)`` -> ``deserialize_from``) and the
retrieval of every question, in two ranks (``tests/torch_dist.py``), at
``--mesh_data 2`` and at ``--mesh_model 2``, against the JAX CLI's
``setup_retriever_model`` with the same flags over its virtual CPU devices.
Scores within 1e-5, ids equal except at near-ties; both ranks get the same
documents, and ``RetrievalEngine`` over the sharded retriever (the first
rank leading, the other following) serves the same documents.
"""

import json
import sys

import numpy as np
import pytest
import torch

from kirag_tpu_torch.index import TorchIndexer
from torch_dist import check_near_ties, run_ranks


@pytest.fixture(scope="module")
def retriever_workspace(tmp_path_factory):
    """A tiny E5 checkpoint and tokenizer, a corpus and an index of random
    rows under the corpus's ids, written by the port."""
    import transformers

    from tests.helpers import BASE_VOCAB, WORDS, make_corpus_json

    root = tmp_path_factory.mktemp("mesh_retriever")
    (root / "vocab.txt").write_text("\n".join(BASE_VOCAB + WORDS))
    tok = transformers.BertTokenizerFast(vocab_file=str(root / "vocab.txt"), do_lower_case=True)
    torch.manual_seed(0)
    enc_dir = root / "e5-tiny"
    transformers.BertModel(transformers.BertConfig(
        vocab_size=tok.vocab_size, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=128)).save_pretrained(str(enc_dir))
    tok.save_pretrained(str(enc_dir))
    corpus_path, docs = make_corpus_json(root, n=300)
    ix = TorchIndexer(32, device="cpu")
    ix.index_data([d["id"] for d in docs],
                  np.random.RandomState(1).randn(len(docs), 32).astype(np.float32))
    ix.serialize(str(root / "index"))
    argv = ["--dataset", "2wikimultihopqa", "--query_file", str(root / "q.json"),
            "--corpus", "2wikimultihopqa", "--corpus_path", corpus_path,
            "--index_folder", str(root / "index"), "--embedding_size", "32",
            "--retriever_model_name_or_path", str(enc_dir), "--compute_dtype", "float32",
            "--llm", "unused", "--aligner_model_name_or_path", str(enc_dir),
            "--save_file", "r.json"]
    questions = [f"what is w{i} ?" for i in range(6)]
    return {"root": root, "argv": argv, "questions": questions}


MESHES = {"data2": (["--mesh_data", "2"], {"data": 2, "model": 1}),
          "model2": (["--mesh_model", "2"], {"data": 1, "model": 2})}


@pytest.fixture(scope="module")
def ranks(retriever_workspace):
    ws = retriever_workspace
    argvs = [ws["argv"] + flags for flags, _ in MESHES.values()]
    got = run_ranks("retriever", 2, {"argvs": argvs, "questions": ws["questions"], "topk": 7},
                    ws["root"])
    return {name: [r[i] for r in got] for i, name in enumerate(MESHES)}


@pytest.mark.parametrize("name", list(MESHES))
def test_retrieve_cli_retriever_over_a_mesh(name, ranks, retriever_workspace, monkeypatch):
    """--mesh_data 2 shards the index over both ranks; --mesh_model 2 makes
    a data axis of one rank, over which the index is replicated (the
    reference's mesh, over its 8 virtual devices, is 4 x 2 then)."""
    from kirag_tpu.cli import retrieve as jax_retrieve

    ws = retriever_workspace
    flags, shape = MESHES[name]
    got = ranks[name]
    for r in got:
        assert r["shape"] == shape and r["indexer_mesh"]
        assert r["docs"] == got[0]["docs"]
    # the engine serves the sharded retriever: the first rank leads and gets
    # the CLI's documents, the other rank searched its one batch
    assert got[0]["engine"] == got[0]["docs"]
    assert got[1]["engine"] == {"requests": 0, "batches": 1, "queries": len(ws["questions"])}
    monkeypatch.setattr(sys, "argv", ["prog"] + ws["argv"] + flags)
    args = jax_retrieve.setup_parser()
    retriever, _ = jax_retrieve.setup_retriever_model(args)
    ref = retriever.batch_retrieve(ws["questions"], topk=7)
    for one, ref_one in zip(got[0]["docs"], ref):
        ids, scores = [d[0] for d in one], np.asarray([d[1] for d in one])
        ref_scores = np.asarray([d["score"] for d in ref_one])
        check_near_ties([ids], scores[None], [[d["id"] for d in ref_one]], ref_scores[None],
                        1e-5)
    json.dumps(got[0]["docs"])  # plain data, as the CLI writes it

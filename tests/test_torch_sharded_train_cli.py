"""``cli/train_aligner --mesh_data 2`` and ``--mesh_model 2`` and
``cli/compute_corpus_embeddings --mesh_model 2`` over two gloo ranks on the
CPU against the port's single-process CLI with the same arguments.

The single-process port CLI is held to the JAX CLI by
``tests/test_torch_training.py`` and ``tests/test_torch_cli.py``; the JAX
CLI under a mesh costs over a minute here, so the meshes are held to the
port's own unsharded run, on the tiny HF checkpoint of those tests (hidden
32, 2 layers, 4 heads) and a hotpotqa-style folder. Both runs take the
same word-level stand-in tokenizer over the checkpoint's vocabulary
(``torch_dist_tasks.WordTokenizer``): importing transformers costs a rank
about 12 s. Every rank runs the
loop (``tests/torch_dist.py``; only the first writes, which
``tests/test_torch_sharded_training.py`` checks). Tolerances, f32:
losses within 1e-5, the dev MRR equal, the saved encoder's weights within
1e-5 (the reference's CLI test's); the embedding shards within 1e-5 of the
largest magnitude, ids equal.
"""

import json
import os

import numpy as np
import pytest
import transformers

from kirag_tpu_torch.cli import compute_corpus_embeddings, train_aligner

import torch_dist_tasks as tasks
from tests.helpers import BASE_VOCAB, WORDS, make_corpus_json
from tests.test_torch_cli import embed_args, read_shards, save_hf_encoder
from tests.test_torch_training import write_aligner_data
from torch_dist import run_ranks

TRAIN = ["--per_device_batch_size", "4", "--num_negatives", "3", "--num_train_epochs", "1",
         "--learning_rate", "3e-4", "--compute_dtype", "float32", "--remat", "none"]
MESHES = {"data2": ["--mesh_data", "2"], "model2": ["--mesh_model", "2"]}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_train_cli")
    (root / "vocab.txt").write_text("\n".join(BASE_VOCAB + WORDS))
    tok = transformers.BertTokenizerFast(vocab_file=str(root / "vocab.txt"), do_lower_case=True)
    enc_dir = save_hf_encoder(root / "e5-tiny", tok.vocab_size)
    tok.save_pretrained(enc_dir)
    folder = write_aligner_data(root / "hotpotqa")
    corpus_path, _ = make_corpus_json(root)
    ws = {"root": root, "enc_dir": enc_dir, "corpus_path": corpus_path,
          "vocab": BASE_VOCAB + WORDS}

    def train_argv(name, extra=()):
        return ["--retriever_model_name_or_path", enc_dir, "--data_folders", folder, *TRAIN,
                "--save_dir", str(root / "runs"), "--name", name, *extra]

    ws["train_argv"] = train_argv
    ws["embed_argv"] = lambda name, extra=(): embed_args(ws, str(root / name), extra)
    return ws


@pytest.fixture(scope="module")
def ranks(workspace):
    ws = workspace
    cases = [{"cli": "train_aligner", "argv": ws["train_argv"](name, flags),
              "root": str(ws["root"] / "runs"), "vocab": ws["vocab"]}
             for name, flags in MESHES.items()]
    cases.append({"cli": "compute_corpus_embeddings",
                  "argv": ws["embed_argv"]("embed_model2", ["--mesh_model", "2"]),
                  "root": str(ws["root"] / "embed_model2"), "vocab": ws["vocab"]})
    got = run_ranks("cli", 2, cases, ws["root"])
    return {name: [r[i] for r in got] for i, name in enumerate([*MESHES, "embed"])}


@pytest.fixture(scope="module")
def unsharded(workspace, monkeypatch_module):
    import functools

    import kirag_tpu_torch.training as training

    monkeypatch_module.setattr(training, "TrainerConfig",
                               functools.partial(training.TrainerConfig, log_steps=1))
    return train_aligner.main(workspace["train_argv"]("single"), device="cpu",
                              tokenizer=tasks.WordTokenizer(workspace["vocab"]))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def run_files(root, name):
    run = root / "runs" / name
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    with np.load(run / "encoder" / "params.npz") as params:
        weights = dict(params)
    return {"losses": [r["loss"] for r in records if "loss" in r],
            "eval": [r["eval_metric"] for r in records if "eval_metric" in r],
            "params": weights, "latest": os.listdir(run / "latest")}


@pytest.mark.parametrize("name", list(MESHES))
def test_train_aligner_over_a_mesh_matches_one_process(name, workspace, ranks, unsharded):
    root = workspace["root"]
    want, got = run_files(root, "single"), run_files(root, name)
    assert len(got["losses"]) == len(want["losses"]) == unsharded["steps"] == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=1e-5)
    assert got["eval"] == want["eval"] and got["latest"] == want["latest"]
    assert got["params"].keys() == want["params"].keys()
    for key, value in want["params"].items():
        np.testing.assert_allclose(got["params"][key], value, rtol=1e-5, atol=1e-5, err_msg=key)
    first, other = ranks[name]
    assert first["result"]["steps"] == other["result"]["steps"] == 4
    assert first["result"]["final_metric"] == other["result"]["final_metric"] == want["eval"][-1]
    # one directory: each rank sees the first rank's files once it returns
    assert other["new_files"] == first["new_files"]
    assert any(f.endswith("encoder/params.npz") for f in first["new_files"])


def test_compute_corpus_embeddings_over_a_model_axis(workspace, ranks):
    ws = workspace
    want_dir = compute_corpus_embeddings.main(ws["embed_argv"]("embed_single"), device="cpu",
                                              tokenizer=tasks.WordTokenizer(ws["vocab"]))
    first, other = ranks["embed"]
    assert first["result"] == other["result"]
    assert other["new_files"] == first["new_files"] != []
    got, want = read_shards(first["result"]), read_shards(want_dir)
    assert list(got) == list(want)
    for name, (emb, ids) in want.items():
        assert got[name][1] == ids
        np.testing.assert_allclose(got[name][0], emb, rtol=0, atol=1e-5 * np.abs(emb).max())

"""The port's index-build entry points held against the JAX package.

Checkpoint loading (HF safetensors / pytorch_model.bin, read without the
``safetensors`` package), the corpus loaders, the collators, and the two
CLIs ``compute_corpus_embeddings`` -> ``build_index``: the same arguments
through both packages give the same shard files, and the port's index is
read and searched by ``kirag_tpu``'s ``TPUIndexer``. Everything runs on the
CPU with ``device="cpu"``; f32, tolerance 1e-5 (2-layer encoders, sums in
different orders).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
import transformers

from kirag_tpu.cli import build_index as jax_build_index
from kirag_tpu.cli import compute_corpus_embeddings as jax_embed
from kirag_tpu.data import COLLATOR_MAP as JAX_COLLATOR_MAP
from kirag_tpu.data import CORPUS_MAP as JAX_CORPUS_MAP
from kirag_tpu.data.corpus import load_psg_data as jax_load_psg_data
from kirag_tpu.index import TPUIndexer
from kirag_tpu.models.encoders import load_encoder as jax_load_encoder
from kirag_tpu.models.registry import resolve_model_path as jax_resolve_model_path
from kirag_tpu.utils.io import load_json as jax_load_json
from kirag_tpu_torch.cli import build_index, compute_corpus_embeddings
from kirag_tpu_torch.cli.common import build_encoder
from kirag_tpu_torch.data import COLLATOR_MAP, CORPUS_MAP, load_psg_data
from kirag_tpu_torch.index import TorchIndexer
from kirag_tpu_torch.models import BertConfig, Encoder, load_encoder
from kirag_tpu_torch.models.encoders import read_safetensors
from kirag_tpu_torch.models.registry import resolve_model_path
from kirag_tpu_torch.utils.io import save_json

from tests.helpers import BASE_VOCAB, WORDS, make_corpus_json, make_tokenizer

TOL = dict(atol=1e-5, rtol=1e-5)


def save_hf_encoder(path, vocab_size, safe_serialization=True, dtype=torch.float32):
    torch.manual_seed(0)
    cfg = transformers.BertConfig(
        vocab_size=vocab_size, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=128, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    transformers.BertModel(cfg).to(dtype).save_pretrained(
        str(path), safe_serialization=safe_serialization)
    return str(path)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A tiny HF encoder checkpoint with its tokenizer, and a corpus.json."""
    root = tmp_path_factory.mktemp("torch_cli")
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(BASE_VOCAB + WORDS))
    tok = transformers.BertTokenizerFast(vocab_file=str(vocab), do_lower_case=True)
    enc_dir = save_hf_encoder(root / "e5-tiny", tok.vocab_size)
    tok.save_pretrained(enc_dir)
    corpus_path, _ = make_corpus_json(root)
    return {"root": root, "enc_dir": enc_dir, "corpus_path": corpus_path}


def token_batch(tmp_path):
    tok = make_tokenizer(tmp_path)
    texts = ["w1 is the alpha .", "w2 of w3 in the city , born", "a"]
    out = COLLATOR_MAP["E5Retriever"](tok, 32, 32).encode_doc(texts)
    return tok, out["input_ids"], out["attention_mask"]


@pytest.mark.parametrize("fmt", ["model.safetensors", "pytorch_model.bin"])
def test_load_encoder_reads_hf_checkpoints_like_jax(tmp_path, fmt):
    tok, ids, mask = token_batch(tmp_path)
    path = save_hf_encoder(tmp_path / "ckpt", tok.vocab_size,
                           safe_serialization=fmt == "model.safetensors")
    assert fmt in os.listdir(path)
    got = load_encoder(path, "e5", device="cpu")(ids, mask)
    want = jax_load_encoder(path, "e5")(ids, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    from safetensors.torch import load_file

    path = save_hf_encoder(tmp_path, 50, dtype=dtype)
    want = load_file(os.path.join(path, "model.safetensors"))
    got = read_safetensors(os.path.join(path, "model.safetensors"))
    assert sorted(got) == sorted(want)
    for name, tensor in want.items():
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], tensor.float()), name


def test_entry_points_default_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no GPU")
    path = save_hf_encoder(tmp_path, 50)
    jax_encoder = jax_load_encoder(path)
    args = compute_corpus_embeddings.setup_parser(["--retriever_model_name_or_path", path])
    for call in (lambda: TorchIndexer(8),
                 lambda: Encoder.from_jax(jax.tree.map(np.asarray, jax_encoder.params),
                                          BertConfig(**jax_encoder.config.__dict__)),
                 lambda: load_encoder(path),
                 lambda: build_encoder(args)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_resolve_model_path_matches_jax(tmp_path, monkeypatch):
    (tmp_path / "e5-large-v2").mkdir()
    monkeypatch.setenv("KIRAG_MODEL_DIR", str(tmp_path))
    for name in ("e5", "intfloat/e5-large-v2", str(tmp_path)):
        assert resolve_model_path(name) == jax_resolve_model_path(name)
    with pytest.raises(FileNotFoundError):
        resolve_model_path("bge")


def test_psg_loader_and_corpora_match_jax(tmp_path):
    tsv = tmp_path / "psgs.tsv"
    tsv.write_text(
        "id\ttext\ttitle\n"
        '1\t"He said ""yes"" to w3."\tAlpha\n'
        "2\tplain text of w4\t(Beta)\n"
        "3\tonly two fields\n"
        "4\t.leading and trailing!\tGamma,\n", encoding="utf-8")
    # native=None: the C++ parser's lazy rows, as the reference's default
    assert list(load_psg_data(str(tsv))) == jax_load_psg_data(str(tsv), native=False)
    assert load_psg_data(str(tsv), native=False) == jax_load_psg_data(str(tsv), native=False)
    kwargs = {"title_prefix": "title:", "passage_prefix": "text:"}
    corpus_json, _ = make_corpus_json(tmp_path, n=6)
    for name, path in (("wikipedia", str(tsv)), ("hotpotqa", corpus_json),
                       ("2wikimultihopqa", corpus_json), ("musique", corpus_json)):
        port = CORPUS_MAP[name](corpus_path=path, **kwargs)
        ref = JAX_CORPUS_MAP[name](corpus_path=path, **kwargs)
        assert len(port) == len(ref) and list(port) == list(ref)
        pid = ref[1]["passage_id"]
        assert port.get_document(pid) == ref.get_document(pid)
        assert port.get_document_text(pid) == ref.get_document_text(pid)


@pytest.mark.parametrize("name", ["E5Retriever", "BGERetriever", "e5", "bge"])
def test_collators_match_jax(tmp_path, name):
    tok = make_tokenizer(tmp_path)
    texts = ["what is w3 ?", "w5 of the river , born in w7 , wrote the film"]
    port, ref = COLLATOR_MAP[name](tok, 64, 64), JAX_COLLATOR_MAP[name](tok, 64, 64)
    for method in ("encode_query", "encode_doc"):
        got, want = getattr(port, method)(texts), getattr(ref, method)(texts)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[key], want[key])


def test_save_json_is_read_back_by_jax(tmp_path):
    data = [{"id": "q0", "answers": ["w1", "w2"]}, {"id": "q1", "answers": []}]
    for fmt in ("json", "jsonl"):
        path = save_json(data, str(tmp_path / f"d.{fmt}"), type=fmt)
        assert jax_load_json(path, type=fmt) == data


def embed_args(ws, out, extra=()):
    return ["--retriever_model_name_or_path", ws["enc_dir"], "--corpus", "2wikimultihopqa",
            "--corpus_path", ws["corpus_path"], "--per_device_batch_size", "8",
            "--compute_dtype", "float32", "--num_passage_per_index_file", "12",
            "--save_dir", out, "--name", "e5_tiny", *extra]


def run_jax_cli(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    module.main()


def read_shards(shard_dir):
    """{file name: (embeddings, passage ids)} in the order of the start offsets."""
    names = sorted((f for f in os.listdir(shard_dir) if f.startswith("corpus_embeddings")),
                   key=lambda f: int(f.split("_")[2]))
    shards = {}
    for name in names:
        with np.load(os.path.join(shard_dir, name), allow_pickle=True) as data:
            assert data["embeddings"].dtype == np.float32
            assert data["passage_ids"].dtype == object
            shards[name] = (data["embeddings"], list(data["passage_ids"]))
    return shards


@pytest.mark.parametrize("process_count", [1, 2])
def test_cli_writes_the_jax_shards_and_an_index_jax_reads(workspace, monkeypatch,
                                                          process_count):
    out = workspace["root"] / f"p{process_count}"
    port_dir, jax_dir = str(out / "port"), str(out / "jax")
    for index in range(process_count):
        slicing = ["--process_index", str(index), "--process_count", str(process_count)]
        shard_dir = compute_corpus_embeddings.main(embed_args(workspace, port_dir, slicing),
                                                   device="cpu")
        run_jax_cli(jax_embed, embed_args(workspace, jax_dir, slicing), monkeypatch)
    port_shards = read_shards(shard_dir)
    jax_shards = read_shards(os.path.join(jax_dir, "e5_tiny"))
    assert list(port_shards) == list(jax_shards)
    assert list(port_shards) == (
        ["corpus_embeddings_0_16.npz", "corpus_embeddings_16_20.npz"] if process_count == 1
        else ["corpus_embeddings_0_10.npz", "corpus_embeddings_10_20.npz"])
    for name, (emb, ids) in port_shards.items():
        assert ids == jax_shards[name][1]
        np.testing.assert_allclose(emb, jax_shards[name][0], **TOL)

    port_index = build_index.main(["--embeddings_dir", shard_dir, "--embedding_size", "32",
                                   "--save_dir", str(out / "port_index")], device="cpu")
    run_jax_cli(jax_build_index, ["--embeddings_dir", os.path.join(jax_dir, "e5_tiny"),
                                  "--embedding_size", "32",
                                  "--save_dir", str(out / "jax_index")], monkeypatch)
    queries = np.concatenate([e for e, _ in port_shards.values()])[::3]
    reader = TPUIndexer(32)
    reader.deserialize_from(port_index)
    jax_built = TPUIndexer(32)
    jax_built.deserialize_from(str(out / "jax_index"))
    port_reader = TorchIndexer(32, device="cpu")
    port_reader.deserialize_from(port_index)
    got = reader.search_knn(queries, 5)
    for other in (jax_built.search_knn(queries, 5), port_reader.search_knn(queries, 5)):
        for (g_ids, g_scores), (w_ids, w_scores) in zip(got, other):
            assert g_ids == w_ids
            np.testing.assert_allclose(g_scores, w_scores, **TOL)
    ids = [pid for _, pids in port_shards.values() for pid in pids]
    assert [r[0][0] for r in got] == ids[::3]  # each stored row finds itself


def test_cli_refuses_what_is_not_ported(workspace):
    out = str(workspace["root"] / "refused")
    # a mesh is ported; one that the world's ranks cannot fill is refused
    with pytest.raises(ValueError, match="does not divide the world size 1"):
        compute_corpus_embeddings.main(embed_args(workspace, out, ["--mesh_model", "2"]),
                                       device="cpu")


@pytest.mark.parametrize("flags", [["--shuffle_rows", "--shuffle_seed", "3"],
                                   ["--metric", "l2", "--compression", "int8"],
                                   ["--metric", "l2", "--compression", "int4", "--shuffle_rows"]])
def test_build_index_shuffle_and_l2_match_jax(tmp_path, monkeypatch, flags):
    """Both packages' build_index over the same shards write the same files
    (the shuffled layout byte for byte, the metric and compression in the
    config), and each reloaded index searches like the other, exact and
    approximate."""
    rng = np.random.RandomState(2)
    rows = rng.randn(1200, 256).astype(np.float32)
    rows *= (rng.uniform(0.5, 2.0, (1200, 1)) / np.linalg.norm(rows, axis=1,
                                                              keepdims=True)).astype(np.float32)
    ids = [f"p{i}" for i in range(1200)]
    shards = tmp_path / "shards"
    shards.mkdir()
    for start, end in ((0, 700), (700, 1200)):
        np.savez(shards / f"corpus_embeddings_{start}_{end}.npz", embeddings=rows[start:end],
                 passage_ids=np.asarray(ids[start:end], dtype=object))
    argv = ["--embeddings_dir", str(shards), "--embedding_size", "256", *flags, "--save_dir"]
    port_dir = build_index.main(argv + [str(tmp_path / "port")], device="cpu")
    jax_dir = str(tmp_path / "jax")
    run_jax_cli(jax_build_index, argv + [jax_dir], monkeypatch)
    names = sorted(f for f in os.listdir(port_dir) if not f.endswith(".log"))
    assert names == sorted(f for f in os.listdir(jax_dir) if not f.endswith(".log"))
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    if "--shuffle_rows" in flags:
        seed = int(flags[flags.index("--shuffle_seed") + 1]) if "--shuffle_seed" in flags else 0
        perm = np.random.default_rng(seed).permutation(1200)
        np.testing.assert_array_equal(np.load(tmp_path / "port" / names[0]), rows[perm])
    port, ref = TorchIndexer(256, device="cpu"), TPUIndexer(256)
    port.deserialize_from(port_dir)
    ref.deserialize_from(jax_dir)
    queries = rows[[5, 999]]
    for mode in ("exact", "approx"):
        got, want = port.search_knn(queries, 5, mode=mode), ref.search_knn(queries, 5, mode=mode)
        for (g_ids, g_scores), (w_ids, w_scores) in zip(got, want):
            assert g_ids == w_ids
            # scores or squared distances up to about 8: f32 sums of 256
            # products in two orders
            np.testing.assert_allclose(g_scores, w_scores, atol=1e-4, rtol=0)


@pytest.mark.parametrize("fused_qkv", [True, False])
def test_encoder_save_is_read_by_jax(tmp_path, fused_qkv):
    from kirag_tpu.models.encoders import Encoder as JaxEncoder
    from kirag_tpu_torch.models import BertModel

    tok, ids, mask = token_batch(tmp_path)
    config = BertConfig(vocab_size=tok.vocab_size, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=64,
                        max_position_embeddings=64, fused_qkv=fused_qkv)
    model = BertModel(config, generator=torch.Generator().manual_seed(3))
    port = Encoder(model, "bge")
    port.save(str(tmp_path / "saved"))
    ref = JaxEncoder.load(str(tmp_path / "saved"))
    assert ref.encoder_type == "bge" and ref.config.fused_qkv == fused_qkv
    np.testing.assert_allclose(port(ids, mask).numpy(), np.asarray(ref(ids, mask)), **TOL)
    again = load_encoder(str(tmp_path / "saved"), device="cpu")
    np.testing.assert_array_equal(again(ids, mask).numpy(), port(ids, mask).numpy())

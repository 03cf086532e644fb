"""The port's index, retriever and engine held against the JAX package.

``TorchIndexer`` reads and writes ``TPUIndexer``'s on-disk format (shuffled
layouts and l2 configs included), its search re-dispatches the checked exact
search when the capture flag is False, its approximate and l2 searches give
``TPUIndexer``'s results, and the whole slice (RetrievalEngine ->
DenseRetriever -> Encoder -> TorchIndexer -> exact or approximate search, the
kernels' plain versions on the CPU) returns the doc ids the JAX package
returns for the same texts and parameters.
"""

import json
import os
import pickle
import threading

import jax
import numpy as np
import pytest
import torch

from kirag_tpu.data import E5Collator as JaxE5Collator
from kirag_tpu.index import TPUIndexer
from kirag_tpu.retrieval import DenseRetriever as JaxDenseRetriever
from kirag_tpu.serving import RetrievalEngine as JaxRetrievalEngine
from kirag_tpu_torch.data import E5Collator
from kirag_tpu_torch.index import TorchIndexer
from kirag_tpu_torch.models import BertConfig, Encoder
from kirag_tpu_torch.retrieval import DenseRetriever
from kirag_tpu_torch.serving import RetrievalEngine

from tests.helpers import make_corpus_json, make_tiny_encoder, make_tokenizer


def unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def numpy_topk_ids(q, c, k):
    s = q.astype(np.float64) @ c.T.astype(np.float64)
    return np.lexsort((np.broadcast_to(np.arange(s.shape[1]), s.shape), -s), axis=1)[:, :k]


@pytest.mark.parametrize("direction", ["tpu_to_torch", "torch_to_tpu"])
def test_serialized_index_loads_across_packages(rng, tmp_path, direction):
    rows = unit_rows(rng, 3000, 16)
    ids = [f"d{i}" for i in range(3000)]
    queries = unit_rows(rng, 5, 16)
    writer = TPUIndexer(16) if direction == "tpu_to_torch" else TorchIndexer(16, device="cpu")
    writer.index_data(ids, rows)
    writer.serialize(str(tmp_path), rows_per_file=1000)
    reader = TorchIndexer(16, device="cpu") if direction == "tpu_to_torch" else TPUIndexer(16)
    reader.deserialize_from(str(tmp_path))
    assert len(reader) == 3000
    want = writer.search_knn(queries, 7)
    got = reader.search_knn(queries, 7)
    for (w_ids, w_scores), (g_ids, g_scores) in zip(want, got):
        assert g_ids == w_ids
        np.testing.assert_allclose(g_scores, w_scores, atol=1e-5, rtol=1e-6)
    oracle = numpy_topk_ids(queries, rows, 7)
    assert [r[0] for r in got] == [[f"d{i}" for i in row] for row in oracle]


def test_search_knn_redispatches_on_miss_and_stays_exact(rng):
    # chunk-clustered top rows: the capture misses and the flag says so
    c = (rng.randn(65536, 16) * 0.01).astype(np.float32)
    hot = np.arange(30) * 64
    c[hot] = (rng.randn(30, 16) + 5.0).astype(np.float32)
    index = TorchIndexer(16, device="cpu", exact_impl="kernel", pallas_chunk_size=2048)
    index.index_data(list(range(65536)), c)
    q = np.ones((8, 16), dtype=np.float32)
    out = index.search_knn(q, 30)
    assert index.redispatches == 1
    oracle = numpy_topk_ids(q, c, 30)
    assert [r[0] for r in out] == [[str(i) for i in row] for row in oracle]


def test_zero_padded_batch_redispatches(rng):
    # 8 chunks of 16 groups, capture 8: a partial capture, so a tie can fail it
    rows = unit_rows(rng, 16384, 32)
    index = TorchIndexer(32, device="cpu", exact_impl="kernel", pallas_chunk_size=2048)
    index.index_data(list(range(16384)), rows)
    full = unit_rows(rng, 8, 32)
    index.search_knn(full, 10)
    assert index.redispatches == 0
    one = index.search_knn(full[:1], 10)  # padded to 8 rows with zeros
    assert index.redispatches == 1
    assert one[0][0] == [str(i) for i in numpy_topk_ids(full[:1], rows, 10)[0]]


def test_to_device_pads_to_the_chunk_grid(rng):
    rows = unit_rows(rng, 5000, 8)
    index = TorchIndexer(8, device="cpu", pallas_chunk_size=2048)
    index.index_data(list(range(5000)), rows)
    index.to_device()
    assert index._device_corpus.shape == (6144, 8) and index._device_rows == 5000
    assert torch.equal(index._device_corpus[:5000], torch.from_numpy(rows))
    assert not index._device_corpus[5000:].any()
    plain = TorchIndexer(8, device="cpu", exact_impl="plain", pallas_chunk_size=2048)
    plain.index_data(list(range(5000)), rows)
    plain.to_device()
    assert plain._device_corpus.shape == (5120, 8)  # whole 128-row groups (approx search)


def test_bf16_index_matches_reference(rng):
    import jax.numpy as jnp

    rows = unit_rows(rng, 4096, 32)
    queries = unit_rows(rng, 3, 32)
    ref = TPUIndexer(32, device_dtype=jnp.bfloat16)
    port = TorchIndexer(32, device="cpu", device_dtype=torch.bfloat16, exact_impl="kernel",
                        pallas_chunk_size=1024)
    for index in (ref, port):
        index.index_data(list(range(4096)), rows)
    for (w_ids, w_scores), (g_ids, g_scores) in zip(ref.search_knn(queries, 10),
                                                    port.search_knn(queries, 10)):
        assert g_ids == w_ids
        np.testing.assert_allclose(g_scores, w_scores, atol=1e-5, rtol=1e-6)


def test_unported_options_raise():
    # every selection of the reference is ported; an unknown one is refused
    # as the reference refuses it
    with pytest.raises(KeyError, match="pallas_select"):
        TorchIndexer(8, device="cpu", pallas_select="heir")
    with pytest.raises(KeyError, match="pallas_select"):
        TPUIndexer(8, pallas_select="heir")
    for select in ("hier", "flat", "capdom", "merge"):
        assert TorchIndexer(8, device="cpu", pallas_select=select).pallas_select == select
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchIndexer(8, device="cpu", mesh=object())
    # streaming is ported (tests/test_torch_streaming.py); with PQ it is
    # refused, as the reference refuses it
    assert TorchIndexer(8, device="cpu", max_device_rows=64).max_device_rows == 64
    with pytest.raises(ValueError, match="streaming"):
        TorchIndexer(8, device="cpu", compression="pq", max_device_rows=64)
    # product quantization is ported: both requests build a PQ index
    assert TorchIndexer(8, device="cpu", n_subquantizers=8).compression == "pq"
    assert TorchIndexer(8, device="cpu", compression="pq").pq_m == 2


def test_indexer_checks_its_options():
    with pytest.raises(KeyError, match="metric"):
        TorchIndexer(8, metric="cosine", device="cpu")
    for winners in (0, 129):
        with pytest.raises(ValueError, match="approx_winners"):
            TorchIndexer(8, approx_winners=winners, device="cpu")
    index = TorchIndexer(8, device="cpu")
    index.index_data(["a"], np.ones((1, 8), np.float32))
    with pytest.raises(ValueError, match="mode"):
        index.search_knn(np.ones((1, 8), np.float32), 1, mode="fast")
    # the card's int4 kernels take depths up to 2048: refused when built, not
    # at the first search (the CPU's plain versions take any depth)
    with pytest.raises(ValueError, match="2048"):
        TorchIndexer(2304, compression="int4", device="cuda")
    with pytest.raises(ValueError, match="2048"):
        TorchIndexer(2048, metric="l2", compression="int4", device="cuda")
    TorchIndexer(1792, metric="l2", compression="int4", device="cuda")
    assert TorchIndexer(2304, compression="int4", device="cpu").compression == "int4"


def assert_same_hits(got, want, atol):
    """Ranked hits: scores within ``atol``, ids equal except where the
    reference holds another score within ``atol`` (a near-tie that two
    summation orders may swap)."""
    for (g_ids, g_scores), (w_ids, w_scores) in zip(got, want):
        np.testing.assert_allclose(g_scores, w_scores, atol=atol, rtol=0)
        for slot, (g, w) in enumerate(zip(g_ids, w_ids)):
            if g != w:
                gaps = np.abs(np.asarray(w_scores) - w_scores[slot])
                gaps[slot] = np.inf
                assert gaps.min() <= atol, (slot, g, w)


@pytest.mark.parametrize("winners", [1, 2])
def test_approx_search_knn_matches_tpu_indexer(rng, winners):
    """Unit rows, f32 index: the group-sampled search of both packages (the
    plain K5 here, JAX's interpret-mode kernel there) within 1e-5 (f32 sums
    of 32 products in two orders), the same ids; each stored row finds
    itself."""
    rows = unit_rows(rng, 3000, 32)
    queries = np.concatenate([rows[[4, 2999]], unit_rows(rng, 3, 32)])
    ids = [f"d{i}" for i in range(3000)]
    ref = TPUIndexer(32, approx_winners=winners)
    port = TorchIndexer(32, device="cpu", approx_winners=winners)
    for index in (ref, port):
        index.index_data(ids, rows)
    want = ref.search_knn(queries, 10, mode="approx")
    got = port.search_knn(queries, 10, mode="approx")
    assert_same_hits(got, want, 1e-5)
    assert [got[0][0][0], got[1][0][0]] == ["d4", "d2999"]
    assert port._device_corpus.shape == (3072, 32)  # whole 128-row groups
    exact = port.search_knn(queries, 10)
    assert [r[0][0] for r in exact] == [r[0][0] for r in got]


def test_shuffled_layout_and_shards_match_tpu_indexer(rng, tmp_path):
    """``shuffle_rows``: both packages write the rows and ids of
    ``default_rng(3).permutation`` (appended rows join the shuffle), shard
    for shard byte-equal, and search the shuffled index alike."""
    rows = unit_rows(rng, 2500, 16)
    ids = [f"d{i}" for i in range(2500)]
    ref = TPUIndexer(16, shuffle_rows=True, shuffle_seed=3)
    port = TorchIndexer(16, device="cpu", shuffle_rows=True, shuffle_seed=3)
    for name, index in (("ref", ref), ("port", port)):
        index.index_data(ids[:1000], rows[:1000])
        index.index_data(ids[1000:], rows[1000:])
        index.serialize(str(tmp_path / name), rows_per_file=1000)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "ref"))
    for name in names:
        if name.endswith(".npy"):
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "ref" / name).read_bytes()
    with open(tmp_path / "port" / "index_config.json") as f, \
            open(tmp_path / "ref" / "index_config.json") as g:
        assert json.load(f) == json.load(g)
    perm = np.random.default_rng(3).permutation(2500)
    with open(tmp_path / "port" / "index_meta.pkl", "rb") as f:
        assert pickle.load(f) == [ids[i] for i in perm]
    np.testing.assert_array_equal(np.load(tmp_path / "port" / names[0]), rows[perm[:1000]])
    queries = rows[[17, 2222]]
    for mode in ("exact", "approx"):
        got, want = port.search_knn(queries, 5, mode=mode), ref.search_knn(queries, 5, mode=mode)
        assert_same_hits(got, want, 1e-5)
        assert [r[0][0] for r in got] == ["d17", "d2222"]


def l2_pair(fmt, d, **kw):
    import jax.numpy as jnp

    jax_kw, port_kw = dict(kw), dict(kw, device="cpu")
    if fmt == "bfloat16":
        jax_kw["device_dtype"], port_kw["device_dtype"] = jnp.bfloat16, torch.bfloat16
    elif fmt in ("int8", "int4"):
        jax_kw["compression"] = port_kw["compression"] = fmt
    return TPUIndexer(d, metric="l2", **jax_kw), TorchIndexer(d, metric="l2", **port_kw)


@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("fmt", ["float32", "bfloat16", "int8", "int4"])
def test_l2_index_matches_tpu_indexer(rng, fmt, mode):
    """Rows of norms 0.5-2 (so int8 fits an alpha): squared distances within
    1e-5 of their scale (f32 sums in two orders), ids equal but at
    near-ties; the stored rows find themselves at distance about 0."""
    d = 256 if fmt == "int4" else 32
    rows = unit_rows(rng, 3000, d) * rng.uniform(0.5, 2.0, (3000, 1)).astype(np.float32)
    queries = np.concatenate([rows[[7, 2100]], unit_rows(rng, 3, d)])
    ref, port = l2_pair(fmt, d)
    for index in (ref, port):
        index.index_data([f"d{i}" for i in range(3000)], rows)
    want = ref.search_knn(queries, 10, mode=mode)
    got = port.search_knn(queries, 10, mode=mode)
    scale = max(float(np.abs(w).max()) for _, w in want)
    assert_same_hits(got, want, 1e-5 * scale)
    assert port._l2_alpha == ref._l2_alpha
    assert all(np.all(np.diff(s) >= 0) for _, s in got)  # distances ascending
    if fmt != "int4":  # int4's score noise exceeds the gap to a stored row's neighbours
        assert [got[0][0][0], got[1][0][0]] == ["d7", "d2100"]
        assert abs(got[0][1][0]) < 0.05 * scale


@pytest.mark.parametrize("direction", ["tpu_to_torch", "torch_to_tpu"])
def test_l2_shuffled_int8_index_loads_across_packages(rng, tmp_path, direction):
    rows = unit_rows(rng, 2000, 32) * rng.uniform(0.5, 2.0, (2000, 1)).astype(np.float32)
    ids = [f"d{i}" for i in range(2000)]
    kw = dict(metric="l2", compression="int8", shuffle_rows=True, shuffle_seed=5)
    if direction == "tpu_to_torch":
        writer, reader = TPUIndexer(32, **kw), TorchIndexer(32, device="cpu")
    else:
        writer, reader = TorchIndexer(32, device="cpu", **kw), TPUIndexer(32)
    writer.index_data(ids, rows)
    writer.serialize(str(tmp_path), rows_per_file=800)
    reader.deserialize_from(str(tmp_path))
    assert (reader.metric, reader.compression) == ("l2", "int8")
    queries = rows[[3, 1500]]
    for mode in ("exact", "approx"):
        want, got = writer.search_knn(queries, 5, mode=mode), reader.search_knn(queries, 5,
                                                                             mode=mode)
        assert_same_hits(got, want, 1e-4)
        assert [r[0][0] for r in got] == ["d3", "d1500"]


def test_retriever_helpers_match_jax(tmp_path):
    from kirag_tpu.data import HotPotQA

    jax_ret, port_ret, texts = build_slice(tmp_path)
    queries, docs = texts[:3], texts[3:9]
    want = jax_ret.encode_score_rank(queries, docs, 4)
    got = port_ret.encode_score_rank(queries, docs, 4)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    path, _ = make_corpus_json(tmp_path)
    port_ret.corpus = HotPotQA(title_prefix="title:", passage_prefix="text:",
                               corpus_path=path)
    ranked = port_ret.get_documents({"doc1": 0.2, "doc5": 0.9, "doc3": 0.5})
    assert [d["id"] for d in ranked] == ["doc5", "doc3", "doc1"] and ranked[0]["score"] == 0.9
    assert [d["id"] for d in port_ret.get_documents(["doc2", "doc0"])] == ["doc2", "doc0"]
    one = port_ret(texts[7], topk=2)  # a single string: one ranked list, joined
    assert one[0]["id"] == "doc7" and "sentences" in one[0]


def build_slice(tmp_path, n_fill=4076):
    """Both packages' retrievers over the same tokenizer, encoder parameters
    and documents, plus seeded filler rows so that the port's search runs
    the stream-capture path (4096 rows, 2 chunks of 2048, capture 8 of 16
    groups)."""
    tok = make_tokenizer(tmp_path)
    jax_enc = make_tiny_encoder(vocab_size=tok.vocab_size)
    port_enc = Encoder.from_jax(jax.tree.map(np.asarray, jax_enc.params),
                                BertConfig(**jax_enc.config.__dict__), "e5", device="cpu")
    _, docs = make_corpus_json(tmp_path)
    texts = [" ".join([d["title"]] + d["sentences"]) for d in docs]
    fill = 0.1 * unit_rows(np.random.RandomState(1), n_fill, 32)
    jax_ret = JaxDenseRetriever(jax_enc, JaxE5Collator(tok, 64, 64),
                                indexer=TPUIndexer(32, chunk_size=1024), batch_size=4)
    port_ret = DenseRetriever(port_enc, E5Collator(tok, 64, 64),
                              indexer=TorchIndexer(32, device="cpu", exact_impl="kernel",
                                                   pallas_chunk_size=2048),
                              batch_size=4)
    for ret in (jax_ret, port_ret):
        ret.indexer.index_data([f"doc{i}" for i in range(len(texts))],
                               ret.calculate_document_embeddings(texts))
        ret.indexer.index_data([f"fill{i}" for i in range(n_fill)], fill)
    return jax_ret, port_ret, texts


def test_engine_slice_matches_jax(tmp_path):
    jax_ret, port_ret, texts = build_slice(tmp_path)
    jax_eng = JaxRetrievalEngine(jax_ret, max_batch=16, max_wait_ms=20, topk_buckets=(3, 5))
    port_eng = RetrievalEngine(port_ret, max_batch=16, max_wait_ms=20, topk_buckets=(3, 5))
    try:
        # one query alone: its batch is zero-padded to 8 rows, which fails the
        # capture flag and re-dispatches the checked search
        before = port_ret.indexer.redispatches
        single = port_eng.search([texts[3]], topk=5)
        assert port_ret.indexer.redispatches > before
        assert single[0][0]["id"] == "doc3"
        assert [d["id"] for d in single[0]] == [
            d["id"] for d in jax_eng.search([texts[3]], topk=5)[0]]

        results, errors = {}, []

        def worker(i):
            try:
                results[i] = (port_eng.search(texts[i:i + 2], topk=3),
                              jax_eng.search(texts[i:i + 2], topk=3))
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(0, 12, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors and not any(t.is_alive() for t in threads)
        for i, (port_rows, jax_rows) in results.items():
            for j, (p, r) in enumerate(zip(port_rows, jax_rows)):
                assert p[0]["id"] == f"doc{i + j}"
                assert [d["id"] for d in p] == [d["id"] for d in r]
                np.testing.assert_allclose([d["score"] for d in p], [d["score"] for d in r],
                                           atol=1e-5)
    finally:
        port_eng.close()
        jax_eng.close()


def test_engine_slice_approx_matches_jax(tmp_path):
    """The slice under ``search_mode="approx"`` (the retriever's mode, which
    the engine's ``mode=None`` defers to) with two winners a group."""
    jax_ret, port_ret, texts = build_slice(tmp_path)
    for ret in (jax_ret, port_ret):
        ret.search_mode = "approx"
        ret.indexer.approx_winners = 2
    jax_eng = JaxRetrievalEngine(jax_ret, max_batch=16, max_wait_ms=20, topk_buckets=(5,))
    port_eng = RetrievalEngine(port_ret, max_batch=16, max_wait_ms=20, topk_buckets=(5,))
    try:
        for i in (0, 4, 9):
            got = port_eng.search(texts[i:i + 3], topk=5)
            want = jax_eng.search(texts[i:i + 3], topk=5)
            for j, (p, r) in enumerate(zip(got, want)):
                assert p[0]["id"] == f"doc{i + j}"
                assert [d["id"] for d in p] == [d["id"] for d in r]
                np.testing.assert_allclose([d["score"] for d in p], [d["score"] for d in r],
                                           atol=1e-5)
        assert port_ret.indexer.redispatches == 0  # no exact search ran
    finally:
        port_eng.close()
        jax_eng.close()

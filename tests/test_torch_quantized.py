"""The port's compressed index (int8 and packed int4) held against the JAX
package.

The quantizers (numpy byte for byte, torch bitwise against numpy), the plain
versions of K1/K2 with K4's int8/int4 scoring against JAX's stream kernel in
Pallas interpret mode (``exact_topk_mips(..., scales=..., impl="stream",
select="capdom")``), the tiny-corpus path against ``_dense_scores``, the
chunked scans ``topk_mips_int8/int4``, ``TorchIndexer(compression=...)``
against ``TPUIndexer``, indexes serialized by either package loaded by the
other, and both ``build_index --compression int4`` CLIs under a
``DenseRetriever``. Shapes stay below the reference's chunk clamps (2048 x
256, chunk 512), so both sides run one geometry.

Tolerances: integer-valued fixtures (small-integer queries, exact in bf16,
and power-of-two scales) are exact in any summation order and compare
bitwise, ids and tie order included; on random unit rows the two packages
sum the same exact f32 products in other orders, within 1e-5 (values about
0.1-1).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kirag_tpu.ops import quantized as jq
from kirag_tpu.ops.pallas_exact import _dense_scores as jax_dense_scores
from kirag_tpu.ops.pallas_exact import exact_topk_mips as jax_exact
from kirag_tpu_torch.kernels import gather_groups, quant_scores, stream_capture
from kirag_tpu_torch.ops import quantized as tq
from kirag_tpu_torch.ops.exact import exact_topk_mips

ATOL = 1e-5
QUANTIZERS = {"int8": (jq.quantize_rows_int8, tq.quantize_rows_int8,
                       tq.quantize_rows_int8_torch),
              "int4": (jq.quantize_rows_int4, tq.quantize_rows_int4,
                       tq.quantize_rows_int4_torch)}


def unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def hard_rows(rng, d):
    """Rows whose quantization has half-way ties (int8: absmax 127 gives
    scale 1 and codes at k + 0.5; int4: absmax 7.5 gives scale 1 and levels
    at k + 0.5 + 7.5), a zero row, all-negative rows and random rows."""
    ties8 = np.tile(np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5],
                             np.float32), d // 8)
    ties4 = np.tile(np.array([7.5, 0.0, 1.0, -1.0, 2.0, -7.0, 0.5, -0.5], np.float32), d // 8)
    negative = -np.abs(unit_rows(rng, 2, d))
    return np.concatenate([ties8[None], ties4[None], np.zeros((1, d), np.float32), negative,
                           unit_rows(rng, 27, d), 3.0 * unit_rows(rng, 3, d)])


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantizers_match_jax_and_numpy(rng, quant):
    jax_fn, np_fn, torch_fn = QUANTIZERS[quant]
    rows = hard_rows(rng, 512)
    want = jax_fn(rows)
    got = np_fn(rows)
    on_torch = torch_fn(torch.from_numpy(rows))
    for w, g, t in zip(want, got, on_torch):
        assert g.dtype == w.dtype and np.array_equal(g, w)      # byte for byte
        assert np.array_equal(t.numpy(), w)                     # bitwise
        assert t.numpy().dtype == w.dtype
    if quant == "int4":
        np.testing.assert_array_equal(tq.dequantize_rows_int4(*got),
                                      jq.dequantize_rows_int4(*want))
        assert not got[1][2].any() and (got[0][2] == 0x88).all()  # zero row: 7.5 -> 8


def quantize(quant, rows):
    codes, scales = QUANTIZERS[quant][1](rows)
    return codes, scales


def integer_corpus(rng, quant, n, d):
    """Codes and power-of-two scales (a few distinct values: ties at every
    selection boundary)."""
    if quant == "int8":
        codes = rng.randint(-2, 3, (n, d)).astype(np.int8)
        scales = np.exp2(rng.randint(-3, 0, n)).astype(np.float32)
    else:
        codes = rng.randint(0, 256, (n, d // 2)).astype(np.uint8)
        scales = np.exp2(rng.randint(-3, 0, (n, d // 128))).astype(np.float32)
    return codes, scales


def run_both(q, codes, scales, k, chunk, on_miss, valid_rows=None):
    j = jax_exact(jnp.asarray(q), jnp.asarray(codes), k, chunk_size=chunk,
                  valid_rows=valid_rows, interpret=True, impl="stream", select="capdom",
                  on_miss=on_miss, scales=jnp.asarray(scales))
    t = exact_topk_mips(torch.from_numpy(q), torch.from_numpy(codes), k, chunk_size=chunk,
                        valid_rows=valid_rows, on_miss=on_miss, scales=torch.from_numpy(scales),
                        select="capdom", impl="stream")
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("on_miss", ["flag", "fallback"])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_random_rows_match_jax_stream_kernel(rng, quant, on_miss):
    c = unit_rows(rng, 2048, 256)
    codes, scales = quantize(quant, c)
    q = unit_rows(rng, 8, 256)
    q[:4] = c[[5, 700, 1500, 2047]]  # stored rows: each finds itself
    j, t = run_both(q, codes, scales, 10, 512, on_miss, valid_rows=2040)
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_allclose(t[0], j[0], atol=ATOL, rtol=0)
    assert list(t[1][:3, 0]) == [5, 700, 1500]
    assert t[1].max() < 2040                      # row 2047 lies past valid_rows
    if on_miss == "flag":
        assert bool(t[2]) == bool(j[2])


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_integer_data_equal_ids_and_tie_order(rng, quant):
    codes, scales = integer_corpus(rng, quant, 4096, 256)
    q = rng.randint(-1, 2, (8, 256)).astype(np.float32)
    q[7] = 0  # a zero row: every score ties
    dense = np.asarray(jax_dense_scores(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales),
                                        quant, 4096))
    # 2 chunks of 16 groups, capture 8 of them: the zero row ties its
    # residual, the flag fails, and the fallback re-scores through K2; then
    # 8 chunks of 4 groups, all captured, k = 20
    for chunk, k, on_misses in ((2048, 8, ("flag", "fallback")), (512, 20, ("flag",))):
        for on_miss in on_misses:
            j, t = run_both(q, codes, scales, k, chunk, on_miss)
            np.testing.assert_array_equal(t[0], j[0])
            np.testing.assert_array_equal(t[1], j[1])
            if on_miss == "flag":
                assert bool(t[2]) == bool(j[2]) == (chunk == 512)
        # FAISS order on the exact scores: descending, ties to the lower row id
        order = np.lexsort((np.broadcast_to(np.arange(4096), dense.shape), -dense),
                           axis=1)[:, :k]
        np.testing.assert_array_equal(t[1], order)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_kernel_plain_versions_score_as_the_reference(rng, quant):
    """K1's captures and K2's re-scores of the same groups, on the CPU (the
    plain versions), equal the reference's dense dequant scores."""
    codes, scales = integer_corpus(rng, quant, 1024, 256)
    q = rng.randint(-2, 3, (3, 256)).astype(np.float32)
    qt, ct, st = map(torch.from_numpy, (q, codes, scales))
    dense = np.asarray(jax_dense_scores(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales),
                                        quant, 1024))                # unmasked
    gmax, capture, gids, _, _ = stream_capture(qt, ct, 1000, 512, 2, st, quant)
    captured = gids.permute(2, 0, 1).reshape(3, -1)
    rescored = gather_groups(qt, ct, captured, st, quant)
    np.testing.assert_array_equal(rescored.view(3, 2, 2, 128).transpose(0, 1).numpy(),
                                  capture.view(2, 3, 2, 128).numpy())
    rows = captured.numpy()[..., None] * 128 + np.arange(128)
    np.testing.assert_array_equal(rescored.numpy(), np.take_along_axis(
        dense, rows.reshape(3, -1), axis=1).reshape(3, -1, 128))
    masked = np.where(np.arange(1024) < 1000, dense, -1e30)
    np.testing.assert_array_equal(gmax.numpy(), masked.reshape(3, 2, 4, 128).max(-1)
                                  .transpose(1, 2, 0))


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_tiny_corpus_path_matches_dense_scores(rng, quant):
    c = unit_rows(rng, 100, 256)
    codes, scales = quantize(quant, c)
    q = unit_rows(rng, 3, 256)
    want = np.asarray(jax_dense_scores(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales),
                                       quant, 100))
    got = quant_scores(*map(torch.from_numpy, (q, codes, scales)), quant).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # one 128-row group: the dense path of both searches, masked tail to row 0
    j = jax_exact(jnp.asarray(q), jnp.asarray(codes), 95, chunk_size=128, valid_rows=90,
                  interpret=True, impl="stream", select="capdom", scales=jnp.asarray(scales))
    t = exact_topk_mips(*map(torch.from_numpy, (q, codes)), 95, chunk_size=128, valid_rows=90,
                        scales=torch.from_numpy(scales), select="capdom", impl="stream")
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=ATOL, rtol=0)
    assert np.isneginf(t[0][:, 90:]).all() and not t[1][:, 90:].any()


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_chunked_scans_match_jax(rng, quant):
    jax_scan = {"int8": jq.topk_mips_int8, "int4": jq.topk_mips_int4}[quant]
    port_scan = {"int8": tq.topk_mips_int8, "int4": tq.topk_mips_int4}[quant]
    c = unit_rows(rng, 3000, 256)
    codes, scales = quantize(quant, c)
    q = unit_rows(rng, 6, 256)
    for valid in (None, 2500):
        jv, ji = jax_scan(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales), 25,
                          chunk_size=512, valid_rows=valid)
        tv, ti = port_scan(torch.from_numpy(q), torch.from_numpy(codes),
                           torch.from_numpy(scales), 25, chunk_size=512, valid_rows=valid)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    # integer-valued: equal values and tie order
    codes, scales = integer_corpus(rng, quant, 3000, 256)
    qi = rng.randint(-1, 2, (4, 256)).astype(np.float32)
    jv, ji = jax_scan(jnp.asarray(qi), jnp.asarray(codes), jnp.asarray(scales), 30,
                      chunk_size=1024)
    tv, ti = port_scan(*map(torch.from_numpy, (qi, codes, scales)), 30, chunk_size=1024)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def assert_same_hits(got, want, atol):
    """Ranked hits: scores within ``atol``, ids equal except where the
    reference holds another score within ``atol`` (the encoders' outputs
    differ in the last bits, and a query value may then round to another
    bf16 value)."""
    for (g_ids, g_scores), (w_ids, w_scores) in zip(got, want):
        np.testing.assert_allclose(g_scores, w_scores, atol=atol, rtol=0)
        for slot, (g, w) in enumerate(zip(g_ids, w_ids)):
            if g != w:
                gaps = np.abs(np.asarray(w_scores) - w_scores[slot])
                gaps[slot] = np.inf
                assert gaps.min() <= atol, (slot, g, w)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_indexer_matches_tpu_indexer(rng, quant):
    from kirag_tpu.index import TPUIndexer
    from kirag_tpu_torch.index import TorchIndexer

    rows = unit_rows(rng, 3000, 256)
    queries = np.concatenate([rows[[3, 1999]], unit_rows(rng, 3, 256)])
    ids = [f"d{i}" for i in range(3000)]
    ref = TPUIndexer(256, compression=quant)
    port = TorchIndexer(256, compression=quant, device="cpu")
    for index in (ref, port):
        index.index_data(ids, rows)
    want, got = ref.search_knn(queries, 7), port.search_knn(queries, 7)
    for (w_ids, w_scores), (g_ids, g_scores) in zip(want, got):
        assert g_ids == w_ids
        np.testing.assert_allclose(g_scores, w_scores, atol=ATOL, rtol=0)
    assert [got[0][0][0], got[1][0][0]] == ["d3", "d1999"]
    # the kernel path (plain versions here) against the reference's Pallas path
    # (interpret mode), one batch each
    ref_kernel = TPUIndexer(256, compression=quant, exact_impl="pallas",
                            pallas_chunk_size=2048)
    port_kernel = TorchIndexer(256, compression=quant, device="cpu", exact_impl="kernel",
                               pallas_chunk_size=2048)
    for index in (ref_kernel, port_kernel):
        index.index_data(ids, rows)
    want, got = ref_kernel.search_knn(queries, 7), port_kernel.search_knn(queries, 7)
    for (w_ids, w_scores), (g_ids, g_scores) in zip(want, got):
        assert g_ids == w_ids
        np.testing.assert_allclose(g_scores, w_scores, atol=ATOL, rtol=0)
    # 2 chunks, capture 8 of 16 groups; 5 queries are padded to 8 rows with
    # zeros: the flag fails, as in JAX, and the search re-dispatches
    assert port_kernel.redispatches == 1
    codes, scales = quantize(quant, rows)
    assert port_kernel._device_corpus.shape == (4096,) + codes.shape[1:]
    assert torch.equal(port_kernel._device_corpus[:3000], torch.from_numpy(codes))
    assert torch.equal(port_kernel._device_scales[:3000], torch.from_numpy(scales))
    assert not port_kernel._device_corpus[3000:].any()
    assert not port_kernel._device_scales[3000:].any()


@pytest.mark.parametrize("direction", ["tpu_to_torch", "torch_to_tpu"])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_compressed_index_loads_across_packages(rng, tmp_path, quant, direction):
    from kirag_tpu.index import TPUIndexer
    from kirag_tpu_torch.index import TorchIndexer

    rows = unit_rows(rng, 2500, 256)
    queries = rows[::500]
    ids = [f"d{i}" for i in range(2500)]
    if direction == "tpu_to_torch":
        writer, reader = TPUIndexer(256, compression=quant), TorchIndexer(256, device="cpu")
    else:
        writer, reader = TorchIndexer(256, compression=quant, device="cpu"), TPUIndexer(256)
    writer.index_data(ids, rows)
    writer.serialize(str(tmp_path), rows_per_file=1000)
    with open(tmp_path / "index_config.json") as f:
        assert json.load(f)["compression"] == quant
    for name in sorted(os.listdir(tmp_path)):
        if name.startswith("index_0"):
            assert np.load(tmp_path / name).dtype == np.float32  # shards stay f32
    reader.deserialize_from(str(tmp_path))
    assert reader.compression == quant and len(reader) == 2500
    want, got = writer.search_knn(queries, 5), reader.search_knn(queries, 5)
    for (w_ids, w_scores), (g_ids, g_scores) in zip(want, got):
        assert g_ids == w_ids
        np.testing.assert_allclose(g_scores, w_scores, atol=ATOL, rtol=0)
    assert [r[0][0] for r in got] == ids[::500]


def test_build_index_cli_and_retriever_slice(tmp_path, monkeypatch):
    """The slice as a whole: the same embedding shards through both packages'
    ``build_index --compression int4``, then a DenseRetriever of each package
    over each package's compressed index, through the exact kernel search."""
    import sys

    import jax

    from kirag_tpu.cli import build_index as jax_build_index
    from kirag_tpu.data import E5Collator as JaxE5Collator
    from kirag_tpu.index import TPUIndexer
    from kirag_tpu.retrieval import DenseRetriever as JaxDenseRetriever
    from kirag_tpu_torch.cli import build_index
    from kirag_tpu_torch.data import E5Collator
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.models import BertConfig, Encoder
    from kirag_tpu_torch.retrieval import DenseRetriever

    from tests.helpers import make_corpus_json, make_tiny_encoder, make_tokenizer

    tok = make_tokenizer(tmp_path)
    jax_enc = make_tiny_encoder(vocab_size=tok.vocab_size, hidden=256)
    port_enc = Encoder.from_jax(jax.tree.map(np.asarray, jax_enc.params),
                                BertConfig(**jax_enc.config.__dict__), "e5", device="cpu")
    _, docs = make_corpus_json(tmp_path)
    texts = [" ".join([d["title"]] + d["sentences"]) for d in docs]
    jax_ret = JaxDenseRetriever(jax_enc, JaxE5Collator(tok, 64, 64), batch_size=4)
    emb = np.concatenate([jax_ret.calculate_document_embeddings(texts),
                          0.1 * unit_rows(np.random.RandomState(1), 1004, 256)])
    ids = [f"doc{i}" for i in range(len(texts))] + [f"fill{i}" for i in range(1004)]
    shards = tmp_path / "shards"
    shards.mkdir()
    for start, end in ((0, 600), (600, 1024)):
        np.savez(shards / f"corpus_embeddings_{start}_{end}.npz", embeddings=emb[start:end],
                 passage_ids=np.asarray(ids[start:end], dtype=object))
    argv = ["--embeddings_dir", str(shards), "--embedding_size", "256", "--compression",
            "int4", "--save_dir"]
    port_dir = build_index.main(argv + [str(tmp_path / "port_index")], device="cpu")
    monkeypatch.setattr(sys, "argv", ["prog"] + argv + [str(tmp_path / "jax_index")])
    jax_build_index.main()
    jax_dir = str(tmp_path / "jax_index")
    for path in (port_dir, jax_dir):
        with open(os.path.join(path, "index_config.json")) as f:
            assert json.load(f)["compression"] == "int4"

    hits = {}
    for label, path in (("port", port_dir), ("jax", jax_dir)):
        # both through the exact kernel search: JAX's Pallas kernels in
        # interpret mode, the port's plain versions of K1/K2
        jax_index = TPUIndexer(256, exact_impl="pallas", pallas_chunk_size=512)
        jax_index.deserialize_from(path)
        port_index = TorchIndexer(256, device="cpu", exact_impl="kernel", pallas_chunk_size=512)
        port_index.deserialize_from(path)
        assert jax_index.compression == port_index.compression == "int4"
        retrievers = {"jax": JaxDenseRetriever(jax_enc, JaxE5Collator(tok, 64, 64),
                                               indexer=jax_index, batch_size=4),
                      "port": DenseRetriever(port_enc, E5Collator(tok, 64, 64),
                                             indexer=port_index, batch_size=4)}
        for package, ret in retrievers.items():
            ranked = ret.batch_retrieve(texts[:8], topk=5)
            hits[label, package] = [([h["id"] for h in row], [h["score"] for h in row])
                                    for row in ranked]
    want = hits["jax", "jax"]
    for key, got in hits.items():
        assert_same_hits(got, want, atol=ATOL if key[1] == "port" else 0)

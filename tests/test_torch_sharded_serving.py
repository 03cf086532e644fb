"""``RetrievalEngine`` over a row-sharded ``TorchIndexer(mesh=)`` on gloo
ranks on the CPU, against JAX's ``RetrievalEngine`` over ``TPUIndexer(mesh=)``
of as many shards on conftest's virtual devices.

The slice is ``tests/test_torch_serving.py``'s (a tiny E5 of two layers, its
tokenizer, the texts' own rows and seeded filler rows, 4096 in all), its
weights carried into the port by ``Encoder.from_jax``. Each world size
starts its ranks once (``tests/torch_dist.py``, task ``engine``): over a
``(2, 1)`` mesh at 2 ranks and a ``(2, 2)`` mesh at 4, every rank builds the
index and the engine for float32 and int8 in exact and approximate
(W = 1) mode. The first rank serves concurrent requests, lone requests
trimmed below their top-k bucket, a request that fails before its batch is
broadcast and one more request, then closes; every other rank's constructor
follows the batches until then. Ids equal except at near-ties, scores
within 1e-5 of the reference's. Then an engine's search raises on every
rank, and each rank raises it; and the leader's warm-up fails, and every
rank's constructor raises.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from kirag_tpu.data import E5Collator as JaxE5Collator
from kirag_tpu.index import TPUIndexer
from kirag_tpu.parallel import create_mesh as jax_create_mesh
from kirag_tpu.retrieval import DenseRetriever as JaxDenseRetriever
from kirag_tpu.serving import RetrievalEngine as JaxRetrievalEngine
from kirag_tpu_torch.data import E5Collator
from kirag_tpu_torch.models import BertConfig, Encoder
from kirag_tpu_torch.retrieval import DenseRetriever
from torch_dist import check_near_ties, run_ranks

from tests.helpers import make_corpus_json, make_tiny_encoder, make_tokenizer

MESHES = {2: (2, 1), 4: (2, 2)}
VARIANTS = [("none", "exact"), ("none", "approx"), ("int8", "exact"), ("int8", "approx")]
DIM, N_FILL = 32, 4076


def unit_rows(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_serving")
    tok = make_tokenizer(tmp)
    jax_enc = make_tiny_encoder(vocab_size=tok.vocab_size)
    tree = jax.tree.map(np.asarray, jax_enc.params)
    cfg = dict(jax_enc.config.__dict__)
    _, docs = make_corpus_json(tmp)
    texts = [" ".join([d["title"]] + d["sentences"]) for d in docs]
    ids = [f"doc{i}" for i in range(len(texts))] + [f"fill{i}" for i in range(N_FILL)]
    fill = 0.1 * unit_rows(np.random.RandomState(1), N_FILL, DIM)
    port_enc = Encoder.from_jax(tree, BertConfig(**cfg), "e5", device="cpu")
    port_docs = DenseRetriever(port_enc, E5Collator(tok, 64, 64),
                               batch_size=4).calculate_document_embeddings(texts)
    cases = {"vocab": str(tmp / "vocab.txt"), "tree": tree, "cfg": cfg, "dim": DIM,
             "ids": ids, "rows": np.concatenate([port_docs, fill]), "texts": texts,
             "variants": VARIANTS, "fail": True}
    # both worlds' ranks run while this process computes the references
    pool = ThreadPoolExecutor(len(MESHES))
    launched = {world: pool.submit(run_ranks, "engine", world, dict(cases, mesh=mesh), tmp,
                                   timeout=120)
                for world, mesh in MESHES.items()}

    # the reference: JAX's engine over the same shard count, one batch of
    # every text at the largest bucket
    jax_docs = None
    refs = {}
    for world, (data, model) in MESHES.items():
        mesh = jax_create_mesh(data, model, devices=jax.devices()[:world])
        for compression, mode in VARIANTS:
            ix = TPUIndexer(DIM, chunk_size=1024, mesh=mesh, approx_winners=1,
                            compression=compression)
            ret = JaxDenseRetriever(jax_enc, JaxE5Collator(tok, 64, 64), indexer=ix,
                                    batch_size=4, search_mode=mode)
            if jax_docs is None:
                jax_docs = ret.calculate_document_embeddings(texts)
            ix.index_data(ids, np.concatenate([jax_docs, fill]))
            eng = JaxRetrievalEngine(ret, max_batch=32, warmup=False, topk_buckets=(5,))
            try:
                refs[(world, compression, mode)] = eng.search(texts, topk=5)
            finally:
                eng.close()
    ranks = {world: job.result() for world, job in launched.items()}
    pool.shutdown()
    return {"ranks": ranks, "refs": refs, "texts": texts}


@pytest.mark.parametrize("world,compression,mode",
                         [(w, c, m) for w in MESHES for c, m in VARIANTS])
def test_sharded_engine_matches_jax(world, compression, mode, served):
    """Every request the leader served: the reference's rows of its texts,
    trimmed to its top-k (buckets of 3 and 5: requests of top 2 and 4 are
    cut from the larger search); in exact mode each text's own document
    first."""
    leader = served["ranks"][world][0]["variants"][(compression, mode)]
    ref = served["refs"][(world, compression, mode)]
    assert len(leader["served"]) == 9
    for nums, k, rows in leader["served"]:
        assert len(rows) == len(nums) and all(len(row) == k for row in rows)
        ids = [[d[0] for d in row] for row in rows]
        scores = np.asarray([[d[1] for d in row] for row in rows])
        ref_rows = [ref[i][:k] for i in nums]
        check_near_ties(ids, scores, [[d["id"] for d in row] for row in ref_rows],
                        np.asarray([[d["score"] for d in row] for row in ref_rows]), 1e-5)
        if mode == "exact":
            assert [row[0] for row in ids] == [f"doc{i}" for i in nums]


@pytest.mark.parametrize("world", list(MESHES))
def test_requests_coalesce_and_every_rank_searches_each_batch(world, served):
    """Six concurrent requests take fewer batches than requests; each
    follower searched every batch the leader served (its stats) and encoded
    nothing; the leader encoded."""
    ranks = served["ranks"][world]
    assert [r["rank"] for r in ranks] == list(range(world))
    for variant in VARIANTS:
        leader = ranks[0]["variants"][variant]["stats"]
        assert leader["requests"] == 9 and leader["batches"] < leader["requests"]
        assert ranks[0]["variants"][variant]["encoded"] > 0
        for r in ranks[1:]:
            got = r["variants"][variant]
            assert got["encoded"] == 0
            assert got["stats"]["batches"] == leader["batches"]
            assert got["stats"]["queries"] == leader["queries"]


@pytest.mark.parametrize("world", list(MESHES))
def test_request_failing_before_the_broadcast_reaches_its_caller(world, served):
    """An empty request fails in the leader's encoding: its caller gets the
    ValueError, nothing is broadcast, and the next request is served on
    every rank (the followers' batches are the leader's served ones)."""
    for variant in VARIANTS:
        got = served["ranks"][world][0]["variants"][variant]
        assert "non-empty list" in got["failed"]
        nums, k, rows = got["served"][-1]
        assert nums == [17, 18, 19] and len(rows) == 3


@pytest.mark.parametrize("world", list(MESHES))
def test_follower_search_raises(world, served):
    for r in served["ranks"][world][1:]:
        for variant in VARIANTS:
            msg = r["variants"][variant]["follower_search"]
            assert f"rank {r['rank']} follows" in msg and "rank 0" in msg
    assert all("follower_search" not in v for v in served["ranks"][world][0]["variants"].values())


@pytest.mark.parametrize("world", list(MESHES))
def test_search_failure_is_raised_on_every_rank(world, served):
    """A search that raises on every rank: each follower's constructor
    raises it, the leader's caller gets it, and the leader serves no more
    batches (no fallback search). Every rank's process exited 0 after its
    engines closed (``run_ranks`` checks the exit codes)."""
    ranks = served["ranks"][world]
    first, after = ranks[0]["fail"]
    assert first == "search failed on rank 0"
    assert "serves no more batches" in after
    for r in ranks[1:]:
        assert r["fail"] == [f"search failed on rank {r['rank']}"]


@pytest.mark.parametrize("world", list(MESHES))
def test_failed_warmup_aborts_the_followers(world, served):
    """The leader's encoder fails in the warm-up, before anything is
    broadcast: its constructor raises the error, and it sends the followers
    an abort, so their constructors raise at once instead of waiting in
    the next broadcast."""
    ranks = served["ranks"][world]
    assert ranks[0]["abort"] == "encoder failed on rank 0"
    for r in ranks[1:]:
        assert "rank 0 of the mesh, failed to start" in r["abort"]

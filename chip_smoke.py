#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``kirag_tpu_torch/csrc`` with nvcc,
holds each against its plain PyTorch version on the card, then drives the
retrieval server (``RetrievalEngine`` -> ``DenseRetriever`` -> E5-large
encoder in bf16 -> ``TorchIndexer`` over 1,000,000 x 1024 rows -> exact
search) with seeded random weights, once over a float32 and once over a
bfloat16 index: 400 requests from 4 threads, then requests of 1, 8 and 32
texts alone, each served batch's capture flag and result held against the
plain versions. On each index K1 and K2 are compared with their plain
versions again and timed. Every phase raises on failure. The last two lines of
standard output are one JSON object with each kernel's launches, error and
times, and the result line ``{"ok": true, "device": {...}}``. Without a CUDA
device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import re
import runpy
import statistics
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import torch

SEED = 0
ATOL = 1e-4  # f32 sums of 1024 products of unit-scale values, two summation orders
N_ROWS = 1_000_000
DIM = 1024
CHUNK = 16384
K = 100
N_TEXTS = 64
CHECK_ROWS = 131072  # phase 3's corpora
N_REQUESTS = 400     # phase 4's traffic per index, from 4 threads


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def unit_rows(n: int, gen: torch.Generator, device) -> torch.Tensor:
    return torch.nn.functional.normalize(torch.randn(n, DIM, generator=gen, device=device),
                                         dim=-1)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median over ``reps`` runs of one call, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_topk_close(vals, idx, ref_vals, ref_idx, what: str) -> None:
    """Values within ATOL; ids equal except where the reference row holds a
    near-tie (another value within ATOL) that the two orders may swap."""
    vals, idx = vals.float().cpu(), idx.long().cpu()
    ref_vals, ref_idx = ref_vals.float().cpu(), ref_idx.long().cpu()
    err = float((vals - ref_vals).abs().max())
    if not err <= ATOL:
        raise AssertionError(f"{what}: top-k values differ by {err} > {ATOL}")
    for row in torch.nonzero((idx != ref_idx).any(-1)).flatten().tolist():
        v = ref_vals[row]
        for j in torch.nonzero(idx[row] != ref_idx[row]).flatten().tolist():
            gaps = (v - v[j]).abs()
            gaps[j] = float("inf")
            if not float(gaps.min()) <= ATOL:
                raise AssertionError(f"{what}: query {row} slot {j} holds row "
                                     f"{int(idx[row, j])}, reference {int(ref_idx[row, j])}, "
                                     "and no near-tie explains it")


def capture_error(got, want, what: str):
    """K1's five outputs against its plain version's: gmax, capmax and resid
    everywhere, the captured scores where both peeled the same group (a
    near-tie may swap two groups; capmax then shows the tie within ATOL).
    Returns the largest difference and the count of swapped gids."""
    same_gid = got[2] == want[2]                                      # [C, b, Q]
    cap_mask = same_gid.permute(0, 2, 1).repeat_interleave(128, dim=2)
    err = max(float((got[i] - want[i]).abs().max()) for i in (0, 3, 4))
    err = max(err, float((got[1] - want[1]).abs()[cap_mask].max()))
    if not err <= ATOL:
        raise AssertionError(f"{what}: K1 differs from plain by {err} > {ATOL}")
    return err, int((~same_gid).sum())


def gather_error(cand, cand_plain, what: str) -> float:
    err = float((cand - cand_plain).abs().max())
    if not err <= ATOL:
        raise AssertionError(f"{what}: K2 differs from plain by {err} > {ATOL}")
    return err


# ----------------------------------------------------------------- phase 3


def check_kernels(dev, gen) -> dict:
    """K1/K2 against their plain versions at the main path's geometry on a
    131,072-row slice; returns the largest error seen on random data."""
    from kirag_tpu_torch.kernels import (gather_groups, gather_groups_plain, stream_capture,
                                         stream_capture_plain)
    from kirag_tpu_torch.ops import exact_topk_mips, hier_topk, topk_mips
    from kirag_tpu_torch.ops.exact import _capture_budget

    n = CHECK_ROWS
    valid = n - 1000
    b = _capture_budget(K, n // CHUNK, CHUNK // 128)
    err = {"stream_capture": 0.0, "gather_groups": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        ints = torch.randint(-2, 3, (n, DIM), generator=gen, device=dev).to(dtype)
        rand = unit_rows(n, gen, dev).to(dtype)
        for n_q in (8, 32):
            q_int = torch.randint(-2, 3, (n_q, DIM), generator=gen, device=dev).to(dtype)
            q_rand = unit_rows(n_q, gen, dev).to(dtype)
            for data, q, c in (("integer", q_int, ints), ("random", q_rand, rand)):
                what = f"{data} {str(dtype)[6:]} Q={n_q}"
                got = stream_capture(q, c, valid, CHUNK, b)
                want = stream_capture_plain(q, c, valid, CHUNK, b)
                gsel = torch.sort(hier_topk(got[0].reshape(-1, n_q).T, K)[1], dim=-1).values
                cand, cand_plain = gather_groups(q, c, gsel), gather_groups_plain(q, c, gsel)
                res = exact_topk_mips(q, c, K, chunk_size=CHUNK, valid_rows=valid,
                                      on_miss="flag")
                ref = exact_topk_mips(q, c, K, chunk_size=CHUNK, valid_rows=valid,
                                      on_miss="flag", plain=True)
                torch.cuda.synchronize()
                if data == "integer":  # exact in any summation order: bitwise
                    for name, x, y in zip(("gmax", "capture", "gids", "capmax", "resid"),
                                          got, want):
                        if not torch.equal(x, y):
                            raise AssertionError(f"{what}: K1 {name} differs from plain")
                    if not torch.equal(cand, cand_plain):
                        raise AssertionError(f"{what}: K2 differs from plain")
                    for x, y in zip(res, ref):
                        if not torch.equal(x, y):
                            raise AssertionError(f"{what}: exact search differs from plain")
                    log(f"  {what}: K1 5/5 outputs and K2 bitwise equal to plain; "
                        f"search bitwise equal, ok={bool(res[2])}")
                    continue
                k1_err, swapped = capture_error(got, want, what)
                k2_err = gather_error(cand, cand_plain, what)
                check_topk_close(res[0], res[1], ref[0], ref[1], f"{what} search")
                err["stream_capture"] = max(err["stream_capture"], k1_err)
                err["gather_groups"] = max(err["gather_groups"], k2_err)
                log(f"  {what}: K1 max abs err {k1_err:.3g} ({swapped} gids differ at "
                    f"near-ties), K2 max abs err {k2_err:.3g}, search ok="
                    f"{bool(res[2])}/{bool(ref[2])}")
        del ints, rand

    # chunk-clustered top rows (integer-valued, so exact in any order): the
    # capture misses, the flag says so, and the fallback is exact
    c = torch.randint(-1, 2, (n, DIM), generator=gen, device=dev).float()
    hot = torch.arange(2 * K, device=dev) * 64            # 200 rows over 100 groups of chunk 0
    c[hot] = torch.randint(4, 7, (2 * K, DIM), generator=gen, device=dev).float()
    q = torch.ones(3, DIM, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        cd, qd = c.to(dtype), q.to(dtype)
        _, _, ok = exact_topk_mips(qd, cd, K, chunk_size=CHUNK, on_miss="flag")
        _, _, ok_plain = exact_topk_mips(qd, cd, K, chunk_size=CHUNK, on_miss="flag",
                                         plain=True)
        vals, idx = exact_topk_mips(qd, cd, K, chunk_size=CHUNK)
        ref_vals, ref_idx = topk_mips(qd, cd, K, chunk_size=CHUNK)
        if bool(ok) or bool(ok_plain):
            raise AssertionError("adversarial cluster: the capture flag should be False")
        if not (torch.equal(vals, ref_vals) and torch.equal(idx, ref_idx)):
            raise AssertionError("adversarial cluster: fallback differs from topk_mips")
        log(f"  adversarial cluster {str(dtype)[6:]}: ok=False (kernel and plain), "
            "fallback bitwise equal to topk_mips")
    return err


# ----------------------------------------------------------------- phase 4


class HashTokenizer:
    """Stand-in WordPiece tokenizer: lower-cased words and punctuation hashed
    into the 30522-entry vocab, [CLS] ... [SEP] and right padding with 0.
    Callable as ``RetrieverCollator.encode`` calls a HuggingFace tokenizer."""

    pad_token_id, cls_id, sep_id, vocab = 0, 101, 102, 30522

    def __init__(self):
        self.padding_side = "right"

    def token_id(self, word: str) -> int:
        return 1000 + zlib.crc32(word.encode()) % (self.vocab - 1000)

    def __call__(self, texts, max_length, padding="max_length", truncation=True,
                 return_tensors="np"):
        ids = np.zeros((len(texts), max_length), dtype=np.int64)
        mask = np.zeros((len(texts), max_length), dtype=np.int64)
        for i, text in enumerate(texts):
            words = re.findall(r"\w+|[^\w\s]", text.lower())[:max_length - 2]
            row = [self.cls_id] + [self.token_id(w) for w in words] + [self.sep_id]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class RecordingIndex:
    """Passes searches through to the index and keeps each query batch, its
    result and whether the search re-dispatched, so the served results can be
    re-checked afterwards. The engine's one worker makes every search, so the
    change of the index's re-dispatch count during a call is that call's."""

    def __init__(self, index):
        self.index = index
        self.calls = []

    def search_knn(self, query_vectors, top_docs, **kwargs):
        before = self.index.redispatches
        out = self.index.search_knn(query_vectors, top_docs, **kwargs)
        self.calls.append((np.array(query_vectors, dtype=np.float32), top_docs, out,
                           self.index.redispatches != before))
        return out


def make_requests(n_requests: int, n_texts: int):
    """Requests of 1, 2, ..., 5 texts in turn, walking through the texts
    cyclically; each request is a list of text numbers."""
    requests, pos = [], 0
    for i in range(n_requests):
        n = 1 + i % 5
        requests.append([(pos + j) % n_texts for j in range(n)])
        pos += n
    return requests


def serve(label, encoder, collator, index, texts, text_rows, power) -> dict:
    """Drive RetrievalEngine over ``index``: N_REQUESTS requests from 4
    threads, then one request at a time of 1, 8 and 32 texts. Checks the
    self-hits, the kernels' launch counts, and every served batch (its
    capture flag and its result) against the same search through the plain
    versions."""
    from kirag_tpu_torch.kernels import launch_counts, reset_launch_counts
    from kirag_tpu_torch.ops import exact_topk_mips
    from kirag_tpu_torch.retrieval import DenseRetriever
    from kirag_tpu_torch.serving import RetrievalEngine

    recorder = RecordingIndex(index)
    retriever = DenseRetriever(encoder, collator, indexer=recorder, batch_size=32)
    engine = RetrievalEngine(retriever, max_batch=32, max_wait_ms=5.0, topk_buckets=(10, K))
    recorder.calls.clear()  # warmup searches are not part of the run
    requests = make_requests(N_REQUESTS, len(texts))
    results, latencies, errors = {}, {}, []

    def worker(mine):
        for r in mine:
            t0 = time.perf_counter()
            try:
                results[r] = engine.search([texts[i] for i in requests[r]], topk=K)
            except Exception as e:  # reported below
                errors.append(e)
            latencies[r] = time.perf_counter() - t0

    reset_launch_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(range(i, len(requests), 4),))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"{label}: serving failed: {errors}")
    n_threaded = len(recorder.calls)
    # then requests alone, as a quiet server gets them: one question (padded
    # to 8 rows) and full batches of 8 and 32 texts (no pad rows)
    for n in (1, 8, 32):
        requests.append(list(range(n)))
        results[len(requests) - 1] = engine.search(texts[:n], topk=K)
    counts = launch_counts()
    engine.close()
    if not (counts["stream_capture"] > 0 and counts["gather_groups"] > 0):
        raise AssertionError(f"{label}: a kernel of the path was not launched: {counts}")

    margins = []
    for r, request in enumerate(requests):
        for j, row in zip(request, results[r]):
            want = str(text_rows[j])
            if row[0]["id"] != want or len(row) != K:
                raise AssertionError(f"{label}: text {j} top-1 is {row[0]['id']}, "
                                     f"not its own row {want}")
            margins.append(row[0]["score"] - row[1]["score"])

    corpus = index._device_corpus
    by_rows, from_capture = {}, []
    for q, top_docs, out, redispatched in recorder.calls:
        q_pad = np.zeros((max(8, 1 << (len(q) - 1).bit_length()), q.shape[1]), np.float32)
        q_pad[:len(q)] = q
        qt = torch.from_numpy(q_pad).to(device=corpus.device, dtype=corpus.dtype)
        what = f"{label} served batch of {len(q)}"
        ref_vals, ref_idx, ref_ok = exact_topk_mips(
            qt, corpus, top_docs, chunk_size=CHUNK, valid_rows=index._device_rows,
            on_miss="flag", plain=True)
        if bool(ref_ok) == redispatched:
            raise AssertionError(f"{what}: capture flag {not redispatched} with the kernels, "
                                 f"{bool(ref_ok)} with the plain versions")
        if redispatched:
            ref_vals, ref_idx = exact_topk_mips(qt, corpus, top_docs, chunk_size=CHUNK,
                                                valid_rows=index._device_rows, plain=True)
        else:
            from_capture.append(len(q))
        vals = torch.tensor(np.stack([s for _, s in out]))
        idx = torch.tensor([[int(i) for i in ids] for ids, _ in out])
        check_topk_close(vals, idx, ref_vals[:len(q)], ref_idx[:len(q)], what)
        by_rows[len(q_pad)] = by_rows.get(len(q_pad), 0) + 1
    if not from_capture:
        raise AssertionError(f"{label}: no search was answered from the capture")

    lat = np.array([latencies[r] for r in range(N_REQUESTS)]) * 1e3
    stats = {"rps": N_REQUESTS / wall,
             "texts_per_s": sum(len(requests[r]) for r in range(N_REQUESTS)) / wall,
             "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
             "launches": counts}
    n_redispatched = len(recorder.calls) - len(from_capture)
    log(f"  {label}: {N_REQUESTS} requests from 4 threads in {n_threaded} batches, then "
        f"requests of 1, 8 and 32 texts alone: all self-hits at top-1 (smallest margin "
        f"{min(margins):.4f}); {len(recorder.calls)} searches by padded rows "
        f"{dict(sorted(by_rows.items()))}, {n_redispatched} re-dispatched, "
        f"{len(from_capture)} answered from the capture (real rows {from_capture}); "
        f"launches {counts}; every served batch's flag and result match the plain search")
    log(f"  [{power}] {label} engine: {stats['rps']:.2f} requests/s "
        f"({stats['texts_per_s']:.2f} texts/s), latency p50 {stats['p50_ms']:.2f} ms, "
        f"p95 {stats['p95_ms']:.2f} ms ({N_REQUESTS} requests, host clock, 4 threads)")
    return stats


def index_kernels(label, index, gen, power, err) -> dict:
    """K1 and K2 against their plain versions on the served index itself
    (its rows, its capture budget): outputs compared as in phase 3 (largest
    errors into ``err``), then timed with CUDA events, median of 10 runs."""
    from kirag_tpu_torch.kernels import (gather_groups, gather_groups_plain, stream_capture,
                                         stream_capture_plain)
    from kirag_tpu_torch.ops import hier_topk
    from kirag_tpu_torch.ops.exact import _capture_budget

    corpus, valid = index._device_corpus, index._device_rows
    b = _capture_budget(K, len(corpus) // CHUNK, CHUNK // 128)
    times = {}
    for n_q in (8, 16, 32):
        what = f"{label} Q={n_q}"
        q = unit_rows(n_q, gen, corpus.device).to(corpus.dtype)
        got = stream_capture(q, corpus, valid, CHUNK, b)
        k1_err, swapped = capture_error(got, stream_capture_plain(q, corpus, valid, CHUNK, b),
                                        what)
        gsel = torch.sort(hier_topk(got[0].reshape(-1, n_q).T, K)[1], dim=-1).values
        k2_err = gather_error(gather_groups(q, corpus, gsel),
                              gather_groups_plain(q, corpus, gsel), what)
        del got
        err["stream_capture"] = max(err["stream_capture"], k1_err)
        err["gather_groups"] = max(err["gather_groups"], k2_err)
        t = {
            "stream_capture": cuda_ms(lambda: stream_capture(q, corpus, valid, CHUNK, b)),
            "stream_capture_plain": cuda_ms(
                lambda: stream_capture_plain(q, corpus, valid, CHUNK, b)),
            "gather_groups": cuda_ms(lambda: gather_groups(q, corpus, gsel)),
            "gather_groups_plain": cuda_ms(lambda: gather_groups_plain(q, corpus, gsel)),
        }
        times[n_q] = t
        log(f"  {what}: K1 max abs err {k1_err:.3g} ({swapped} gids differ at near-ties), "
            f"K2 max abs err {k2_err:.3g}")
        log(f"  [{power}] {what}, {len(corpus)} x {DIM}, k={K}, capture {b} of "
            f"{CHUNK // 128} groups per chunk: K1 {t['stream_capture']:.3f} ms vs plain "
            f"{t['stream_capture_plain']:.3f} ms; K2 {t['gather_groups']:.3f} ms vs plain "
            f"{t['gather_groups_plain']:.3f} ms (CUDA events, median of 10)")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from kirag_tpu_torch.data import E5Collator
    from kirag_tpu_torch.device import require_cuda, tf32_flags
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.kernels import build, load_library
    from kirag_tpu_torch.models import BertConfig, BertModel, Encoder
    from kirag_tpu_torch.retrieval import DenseRetriever

    dev = require_cuda()
    # float32 parity is claimed below: both TF32 switches off (matmul's is off
    # by default; the port runs no convolution, cuDNN's is set for the record)
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on")
    name = torch.cuda.get_device_name(0)
    power = nvidia_smi("name,power.limit")
    log("phase 1: device")
    log(f"  {name}, {torch.cuda.device_count()} device(s), driver "
        f"{nvidia_smi('driver_version')}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}; {tf32_flags()}")
    log(power)

    log("phase 2: build")
    info = build()
    load_library()
    log(f"  nvcc -gencode arch=compute_90a,code=sm_90a: {info.seconds:.1f} s -> "
        f"{info.path.name}")
    for line in info.log.splitlines():
        if "registers" in line:
            log("  " + line.strip())

    gen = torch.Generator(device=dev).manual_seed(SEED)
    log(f"phase 3: kernels vs plain versions ({CHECK_ROWS} x {DIM}, chunk {CHUNK}, k={K})")
    err = check_kernels(dev, gen)

    log("phase 4: the retrieval server (E5-large geometry, bf16 compute, seeded weights)")
    config = BertConfig()
    model = BertModel(config, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    encoder = Encoder(model, "e5", compute_dtype=torch.bfloat16)
    collator = E5Collator(HashTokenizer(), query_maxlength=64, doc_maxlength=512)
    # the repo's bundled real-text questions (a data file; read by path, since
    # an installed package may own the name `tests`)
    fixtures = runpy.run_path(str(Path(__file__).resolve().parent / "tests"
                                  / "fixtures_realtext.py"))
    texts = [r["question"] for r in fixtures["REALTEXT_QA"]][:N_TEXTS]
    text_emb = DenseRetriever(encoder, collator).calculate_query_embeddings(texts)
    # the same weights in f32 are the reference for the bf16 encoder
    ref_model = BertModel(config, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED))
    ref_emb = DenseRetriever(Encoder(ref_model, "e5"), collator).calculate_query_embeddings(texts)
    del ref_model
    cos = np.sum(text_emb * ref_emb, axis=-1)
    if not (text_emb.shape == (N_TEXTS, DIM) and np.isfinite(text_emb).all()
            and np.allclose(np.linalg.norm(text_emb, axis=-1), 1.0, atol=1e-5)
            and cos.min() > 0.99):
        raise AssertionError(f"encoder: shape {text_emb.shape}, min cosine to f32 {cos.min()}")
    others = text_emb @ text_emb.T - 2 * np.eye(N_TEXTS)
    log(f"  encoder: {config.num_hidden_layers} layers x {config.hidden_size}, {N_TEXTS} "
        f"texts -> unit rows; cosine to the f32 encoder >= {cos.min():.5f}; largest "
        f"cosine between two texts {others.max():.4f}")
    for bs in (8, 32):
        args = collator.encode_query(texts[:bs])
        ms = cuda_ms(lambda: encoder(args["input_ids"], args["attention_mask"]))
        log(f"  [{power}] encoder batch {bs} x {args['input_ids'].shape[1]} tokens: "
            f"{ms:.2f} ms per batch (CUDA events, median of 10)")

    # the texts' embeddings at known rows spread over the corpus, seeded unit
    # rows everywhere else
    text_rows = [i * (N_ROWS // N_TEXTS) + 7 for i in range(N_TEXTS)]
    rows = unit_rows(N_ROWS, gen, dev)
    rows[text_rows] = torch.from_numpy(text_emb).to(dev)
    host_rows = rows.cpu().numpy()
    del rows
    ids = list(range(N_ROWS))
    served, timed = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        label = f"{str(dtype)[6:]} index"
        index = TorchIndexer(DIM, device=dev, device_dtype=dtype, pallas_chunk_size=CHUNK)
        index.index_data(ids, host_rows)
        index.to_device()
        served[label] = serve(label, encoder, collator, index, texts, text_rows, power)
        log(f"phase 5: kernels vs plain versions on the {label}, and their times")
        timed[label] = index_kernels(label, index, gen, power, err)
        del index
        torch.cuda.empty_cache()

    headline = timed["float32 index"][32]
    sources = {"stream_capture": ("kirag_tpu_torch/csrc/stream_capture.cu",
                                  "kirag_tpu/ops/pallas_exact.py:467"),
               "gather_groups": ("kirag_tpu_torch/csrc/gather_groups.cu",
                                 "kirag_tpu/ops/pallas_exact.py:785")}
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": sum(s["launches"][k] for s in served.values()),
                "max_abs_err": err[k], "ms": headline[k], "plain_ms": headline[k + "_plain"],
                "at": f"Q=32, float32 index {N_ROWS} x {DIM}, chunk {CHUNK}, k={K}"}
               for k, (src, rep) in sources.items()]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

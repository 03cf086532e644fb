#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``kirag_tpu_torch/csrc`` with nvcc (one
process per source, in parallel), holds each against its plain PyTorch
version on the card, then drives the paths of the system with seeded random
weights at E5-large and Llama-3-8B-Instruct width:

- the retrieval server (phases 4-5): ``RetrievalEngine`` -> ``DenseRetriever``
  -> E5-large encoder in bf16 -> ``TorchIndexer`` over 1,000,000 x 1024 rows
  -> exact search, once over a float32 and once over a bfloat16 index: 400
  requests from 4 threads, then requests of 1, 8 and 32 texts alone, each
  served batch's capture flag and result held against the plain versions;
  K1 and K2 compared with their plain versions again and timed (K2 also on
  phase 6's built index, where the queries share most groups);
- the offline index build (phase 6): a 16,384-passage DPR-format TSV through
  ``compute_corpus_embeddings`` (bf16, batch 128, buckets of 128, 256 and 512
  tokens, every encoder layer through the flash attention kernel K3) and
  ``build_index``, then the built index reloaded and searched; K3 held
  against its plain version at the encoder's shapes and timed beside
  ``scaled_dot_product_attention``;
- the KiRAG loop (phases 7-9): the 4-bit matmul kernel K6 held against its
  plain version at every projection shape of Llama-3-8B and timed; the LLM
  at Llama-3-8B-Instruct geometry with NF4 weights quantized on the card,
  decoding 4 prompts through ``TorchLlamaBackend`` (225 K6 launches a step),
  held against the same run through K6's plain version, with ``load_llama``
  reading a full-width 2-layer checkpoint; then
  ``kirag_tpu_torch.cli.retrieve`` over phase 6's index and encoder with that
  LLM handed in, timed by stage; and the evaluation pipeline around it
  (phase 16) with the same LLM: ``cli/construct_kg_corpus`` over 8
  documents, the int8 KV cache (its quantizer on the card bitwise the CPU's,
  16 decode steps held against the bf16 cache, both caches' bytes and step
  times, ``cli/retrieve --llm_kv_quant_bits 8`` as run E), ``cli/qa_eval``
  over run E's results (the reader's ids through K6 against the plain
  formulation's) and ``TripleSelector.retrieve`` with its option step;
  then (phase 17) greedy speculative decoding with a seeded bf16 draft at
  Llama-3.2-1B geometry (scripted, the draft's own argmax, segmented, with
  logits: ids against phase 8's greedy stream, K6's launches a verify
  round, the acceptance histogram, a draft with the int8 cache refused,
  K6's row-count invariance), the prefix-KV pool at full width (bf16 and
  int8 caches, seeding and reusing calls against plain greedy) and
  ``cli/retrieve`` with ``--draft_llm`` (run F) and
  ``--llm_prefix_cache_groups`` (run G);
- the Aligner's contrastive training (phase 10): K3's two backward kernels
  held against their plain version and timed beside the backward of
  ``scaled_dot_product_attention``; a training step's gradients through the
  kernels against the plain K3 and across the remat modes; then
  ``kirag_tpu_torch.cli.train_aligner`` at its defaults for one epoch over a
  seeded hotpotqa-format folder, from phase 6's E5-large npz to a saved
  encoder; and step times at the JAX package's training-benchmark geometry;
- the compressed index (phase 11): K1 and K2 with K4's int8 and int4
  scoring held against their plain versions (bitwise on integer data); the
  mma order of that scoring across kernels: one (row, query) pair at every
  place of the mma fragments scores the same bits, and on random data K1's
  captures equal K2's re-scores, K7a's maxima K1's and K5's W = 1 values
  K1's maxima, bitwise (int8 at D = 1024, int4 at 1024 and 2048), and each
  wrapper's device kernels a call, counted in a fresh process; the
  server of phase 4 over the same 1,000,000 rows as int8 and int4 indexes
  quantized on the card, K1/K2 timed at Q = 8, 16, 32, 256;
  ``build_index --compression`` over phase 6's shards
  and the reloaded index; and the DPR corpus's 21,015,324 x 1024 rows made
  and quantized on the card, int4 then int8, searched at Q = 8, 32, 256 with
  K1/K2 timed, self-hits checked and recall@10/@100 against the exact
  float32 top-100;
- the approximate search and the l2 metric (phases 12-13): K5, the group
  top-W kernel, held against its plain version in four formats and at W =
  1, 2, 8, 128 (bitwise on integer data, and at W = 1 bitwise K1's group
  maxima), with K1/K2 at the int4 depths 1280 and 2048; the server of phase
  4 with ``search_mode="approx"`` over the same rows shuffled
  (``shuffle_rows``) as float32 and int4 indexes at W = 1 and 2, recall
  against the exact search over the same index; ``build_index
  --shuffle_rows``, ``cli/retrieve --search_mode approx`` (run C, beside
  phase 9 while its LLM is on the card) and ``cli/retrieval_eval``; K5 over
  the DPR-scale codes of phase 11 (d); and phase 4's rows as l2 indexes in
  float32, int8 and int4 (depth 1280), served exactly and approximately;
- product quantization (phase 14): K1, K2 and K7a with K4's pq4 scoring
  (the mma order) held against their plain versions at m = 128, 256, 512
  (bitwise on integer data; the position probe; K1's captures bitwise K2's
  re-scores and K7a's scores); k-means and the encoder on the card; the
  server of phase 4 over the same rows as a PQ index (m = 256) trained and
  encoded on the card by ``TorchIndexer(compression="pq")``, with
  ``mode="approx"`` serving the exact results and a ``serialize`` ->
  ``deserialize_from`` round trip;
  ``cli/retrieve --index_folder`` over phase 6's embeddings as a PQ index
  (run D, beside phase 9); and the DPR corpus's 21,015,324 rows as a PQ
  index (2.69 GB of codes), searched at Q = 8, 32, 256 with recall@10/@100
  against the exact float32 top-100;
- the exact-search variants (phase 15): K7a (every score and the group
  maxima, stored chunk-major, row-major or not at all), K7b and K8 (group
  copies, on int64 and int32 indices, one device kernel a call by
  torch.profiler) and K9 (merge's running window, with the count of
  queries that took the reference's steps) held against their plain
  versions in five formats (K7a's maxima bitwise K1's); every
  ``(impl, select)`` of ``exact_topk_mips`` over phase 4's 1,000,000 rows
  as float32, bfloat16, int8, int4 and PQ indexes at Q = 8, 32, 256,
  bitwise equal to stream/capdom, K7b and K8 timed at each Q beside
  ``index_select``; phase 4's server with
  ``pallas_select="merge"`` and ``"hier"``; and ``impl="single"``,
  ``"twopass"`` and ``select="merge"`` over the DPR corpus's int4 codes,
  equal to the capdom search, with K7a, K7b, K8 and K9 timed;
- streaming search (phase 18): 2,097,152 x 1024 seeded rows (8.6 GB of
  float32, then int8) held in pinned host memory in blocks of
  ``max_device_rows`` = 524,288 and copied block by block into two device
  buffers on a side stream while K1/K2 (exact) or K5 (approximate) search
  the block before: the streamed exact search bitwise the resident one, the
  approximate one against its plain version, the copy's GB/s, the ms a
  search against the resident index's and the copy the searches hide, the
  server over the streamed index (the resident ids), and the host C++
  (``csrc/host``: the DPR TSV parser against the Python loader, the CPU flat
  index against the card's exact search);
- the T5 reader backend (phase 19): a seeded state dict at Flan-T5-XL's
  published geometry (24 + 24 layers x 2048, gated-gelu, untied lm_head)
  under HF's names, converted by ``convert_hf_t5_state_dict``; 4 prompts of
  300-512 tokens through ``TorchT5Backend`` in bf16 (ids the argmax of their
  logits, a row made to finish early emitting eos, against float32 compute
  up to each row's first near-tie; encoder and decoder-step times), the
  port at 2 + 2 layers on the card against the CPU, ``qa_eval.evaluate``
  over phase 16's run E with an ``AnswerGenerator`` over T5, the bf16 call
  inside ``utils.tracing.trace``/``annotate`` with a ``StepTimer``, and the
  host utilities (``preprocessing.odqa.main``, ``WandbTracker`` over a
  stub). No kernel of the port is on this path;
- the mesh (phase 20, after phase 18): (a) NCCL at world size 1 in this
  process, every ``sharded_*`` search over a 1 x 1 mesh of phase 4's rows
  (float32, int8, int4) bitwise its unsharded counterpart, one
  ``all_gather_cols`` and a sharded search timed, and ``RetrievalEngine``
  over ``TorchIndexer(mesh=)`` of that mesh, its answers bitwise phase 4's
  engine's; (b) two spawned ranks on the one card over gloo, each making
  the same seeded 1,000,000 x 1024 rows and keeping its shard (the valid
  rows ending inside shard 1): the merged exact (capdom) and approximate
  (W = 1) searches in five formats at Q = 8 and 32 bitwise the first rank's
  unsharded kernel search; (d) in the same ranks, ``RetrievalEngine`` over
  ``TorchIndexer(mesh=)`` of those rows with phase 4's texts at their rows
  (float32 exact and approximate, int8 exact): the first rank encodes and
  serves phase 4's traffic, the other follows its batches into the
  search's collectives, every batch bitwise the first rank's unsharded
  kernel search, requests/s and p50/p95; then Llama TP over the two ranks
  at phase 9's depth (bf16, NF4 through K6) and at 2 layers (f32) against
  the unsharded decode; (c) ``torchrun`` of one rank
  running ``cli/retrieve --mesh_data 1`` with run A's arguments (through
  this script's ``--mesh-retrieve``, which hands in phase 9's tokenizers
  and LLM), its ``--save_file`` equal to run A's;
- training over a mesh (phase 21, after phase 20): (a) NCCL at world size 1
  in this process, ``AlignerTrainer(mesh=create_mesh(1, 1),
  batch_sharding="data")`` at E5-large (bf16 over f32 weights, remat dots,
  phase 10 (d)'s batch) bitwise the unsharded trainer for 3 micro steps, and
  ``Encoder.shard_params`` over the 1 x 1 mesh bitwise the unsharded
  encoder; (b) two spawned ranks on the one card over gloo at E5-large
  width with 4 of its 24 layers: DP (2, 1) and TP (1, 2) steps at f32 and
  bf16 (and TP at remat dots) against rank 0's unsharded step, a TP
  checkpoint resumed bitwise and read by an unsharded trainer,
  ``save_encoder`` under TP read back, ``Encoder.shard_params`` over (1, 2)
  against the unsharded encoder, K3's three kernels on each rank's 8 heads;
  (c) ``torchrun`` of one rank running ``cli/train_aligner --mesh_data 1``
  with phase 10 (c)'s arguments (through this script's ``--train-mesh``),
  its losses and saved encoder against phase 10 (c)'s (bitwise up to the
  first update at a non-zero rate; after it within what two runs of the
  same CLI in one process differ by: PyTorch's backward sums its repeated
  indices in an order of its own each run).

Every phase raises on failure. The last lines of standard output are K2's
main-path launches by shape, the card's name and power limit, one JSON
object with each kernel's launches, error, times and bound, and the result
line ``{"ok": true, "device": {...}}``. Without a CUDA device it exits with
code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import resource
import runpy
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
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
# phase 6: passages per section and words per passage; each section's batches
# of 128 land in one bucket (128, 256, 512 tokens); the middle one is DPR's
# psgs_w100 shape
SECTIONS = ((4096, (48, 84), 128), (8192, (100, 100), 256), (4096, (280, 420), 512))
BATCH = 128
SHARD_ROWS = 8192
# phase 8: the first decode step's logits through K6 and through its plain
# version may differ by these shares of the largest logit. bf16: the two runs
# round a few outputs of each projection one bf16 ulp apart (phase 7), and 32
# layers of random weights amplify that; f32: the same path, whose two runs
# differ only in the order of f32 sums
LOGIT_TOL = 2.0 ** -3
LOGIT_TOL_F32 = 1e-3
# a spin of about 2 ms at the H100's 1.98 GHz, longer than the host takes to
# enqueue any timed call (see cuda_ms)
QUEUE_CYCLES = 4_000_000
# the spins that open each torch.profiler window whose kernels are counted
# (profile_lead_in): PROFILE_LEAD_SPINS short ones, then one of about 20 ms;
# SPIN_KERNEL is their kernel, left out of every tally
PROFILE_LEAD_CYCLES = 40_000_000
PROFILE_LEAD_SPINS = 4
SPIN_KERNEL = "spin_kernel"
# the card's peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s, f32 FMA
# on the CUDA cores and bf16 tensor-core operations per second
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
# f32-grade products on the tensor cores: the data sheet's dense TF32 rate
# (495 TFLOP/s) over the three passes of a split-f32 ("3xTF32") product, each
# operand a = hi + lo in TF32, a b = lo.hi + hi.lo + hi.hi. K3's f32 work (the
# forward and both backward kernels) is bound at this rate, whatever
# implements it: the card can do it so (SDPA's f32 path does). The float
# search kernels (K1, K2, K5, K7a) keep F32_FLOP_S: their contract is one fma
# order, bitwise across four kernels, which tensor-core sums cannot give.
TF32X3_FLOP_S = 495e12 / 3
# the exact search the indexer served until the port had every variant, and
# which phases 3-14 hold to its plain version: stream capture, capture-domain
# selection (the reference's defaults are impl="auto", select="flat")
CAPDOM = {"select": "capdom", "impl": "stream"}


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def unit_rows(n: int, gen: torch.Generator, device, d: int = 0) -> torch.Tensor:
    """n seeded unit rows of depth d (default DIM)."""
    return torch.nn.functional.normalize(
        torch.randn(n, d or DIM, generator=gen, device=device), dim=-1)


def cuda_ms(fn, reps: int = 10, flush=None) -> float:
    """Median over ``reps`` runs of one call, timed with CUDA events on the
    card alone: before each, ``flush`` runs and then a spin of QUEUE_CYCLES
    keeps the card busy while the host enqueues the call, so the host's
    launch time (tens of microseconds in a Python wrapper) is not counted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(QUEUE_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float, ops_s: float):
    """The least time the card could take for this work, in ms, and what
    bounds it: each input read once and each output written once at the HBM
    rate, or the operations at their peak rate, whichever is longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / ops_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# K2's launches in the main-path runs, by the shape its wrapper names
# (format, Q, k, the corpus's groups), added up by main_path_counts()
K2_SHAPES: dict = {}


def shapes_of(*formats) -> dict:
    """K2_SHAPES' entries of these formats, the most launched first."""
    return dict(sorted(((k, n) for k, n in K2_SHAPES.items() if k.split()[0] in formats),
                       key=lambda kv: -kv[1]))


def main_path_counts() -> dict:
    """``launch_counts()`` at the end of a main-path run (the runs whose
    launches the kernels line counts), K2's launches by shape added to
    K2_SHAPES."""
    from kirag_tpu_torch.kernels import launch_counts, launch_shapes

    for name, by in launch_shapes().items():
        if name.startswith("gather_groups"):
            for shape, n in by.items():
                K2_SHAPES[shape] = K2_SHAPES.get(shape, 0) + n
    return launch_counts()


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
                                      on_miss="flag", **CAPDOM)
                ref = exact_topk_mips(q, c, K, chunk_size=CHUNK, valid_rows=valid,
                                      on_miss="flag", plain=True, **CAPDOM)
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
        _, _, ok = exact_topk_mips(qd, cd, K, chunk_size=CHUNK, on_miss="flag", **CAPDOM)
        _, _, ok_plain = exact_topk_mips(qd, cd, K, chunk_size=CHUNK, on_miss="flag",
                                         plain=True, **CAPDOM)
        vals, idx = exact_topk_mips(qd, cd, K, chunk_size=CHUNK, **CAPDOM)
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

    def __getattr__(self, name):  # the engine reads the index's mesh, device and width
        return getattr(self.index, name)

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


LONE_REQUESTS = (1, 8, 32)  # texts of the requests sent alone after the threaded ones


def drive_engine(engine, texts, n_requests: int, label: str):
    """``n_requests`` requests (:func:`make_requests`) from 4 threads, then
    one request at a time of LONE_REQUESTS texts, as a quiet server gets
    them (one question, padded to 8 rows, and full batches), all at top K:
    ``(requests, results, latencies, wall)``, the requests as text numbers,
    the threaded ones' latencies and their wall time in seconds (host
    clock)."""
    requests = make_requests(n_requests, len(texts))
    results, latencies, errors = {}, {}, []

    def worker(mine):
        for r in mine:
            t0 = time.perf_counter()
            try:
                results[r] = engine.search([texts[i] for i in requests[r]], topk=K)
            except Exception as e:  # reported below
                errors.append(e)
            latencies[r] = time.perf_counter() - t0

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
    for n in LONE_REQUESTS:
        requests.append(list(range(n)))
        results[len(requests) - 1] = engine.search(texts[:n], topk=K)
    return requests, results, np.array([latencies[r] for r in range(n_requests)]), wall


def traffic_stats(requests, latencies: np.ndarray, wall: float) -> dict:
    """Requests/s, texts/s and the latencies' p50/p95 (ms) of the threaded
    requests, the first ``len(latencies)`` of ``requests``."""
    n = len(latencies)
    lat = latencies * 1e3
    return {"rps": n / wall, "texts_per_s": sum(len(r) for r in requests[:n]) / wall,
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95))}


def realtext_questions() -> list:
    """The first N_TEXTS of the repo's bundled real-text questions (a data
    file; read by path, since an installed package may own the name
    `tests`)."""
    fixtures = runpy.run_path(str(Path(__file__).resolve().parent / "tests"
                                  / "fixtures_realtext.py"))
    return [r["question"] for r in fixtures["REALTEXT_QA"]][:N_TEXTS]


def phase4_text_rows() -> list:
    """The rows that hold the texts' embeddings, spread over the corpus."""
    return [i * (N_ROWS // N_TEXTS) + 7 for i in range(N_TEXTS)]


def kernel_quant(compression: str) -> str:
    """The kernels' corpus format of an index compression ("pq" is scored
    as "pq4")."""
    return "pq4" if compression == "pq" else compression


def kernel_names(compression: str):
    """The launch counts of K1 and K2 for an index of this compression."""
    quant = kernel_quant(compression)
    suffix = "" if quant == "none" else f"_{quant}"
    return f"stream_capture{suffix}", f"gather_groups{suffix}"


def k5_name(quant: str) -> str:
    """The launch count of K5 for a corpus of this format."""
    return "group_max" if quant == "none" else f"group_max_{quant}"


def plain_search(index, q_pad: np.ndarray, top_docs: int, mode: str):
    """The indexer's search of a padded query batch through the kernels'
    plain versions over the same device layout: ``(vals, idx, ok)``, vals
    as ``search_knn`` reports them (squared distances for l2), ok the exact
    capture's flag (None for approx)."""
    from kirag_tpu_torch.ops import approx_topk_mips, exact_topk_mips

    corpus, scales = index._group_view() if mode == "approx" else (index._device_corpus,
                                                                   index._device_scales)
    qt = torch.from_numpy(q_pad).to(device=corpus.device, dtype=index.device_dtype)
    qs = index._search_queries(qt)
    ok = None
    if mode == "approx":
        vals, idx = approx_topk_mips(qs, corpus, top_docs, valid_rows=index._device_rows,
                                     scales=scales, winners_per_group=index.approx_winners,
                                     plain=True)
    else:
        search = dict(chunk_size=CHUNK, valid_rows=index._device_rows, plain=True,
                      scales=scales, quant=kernel_quant(index.compression),
                      select=index.pallas_select)
        vals, idx, ok = exact_topk_mips(qs, corpus, top_docs, on_miss="flag", **search)
        if not bool(ok):
            vals, idx = exact_topk_mips(qs, corpus, top_docs, **search)
    if index.metric == "l2":
        vals = (qt.float() ** 2).sum(dim=1, keepdim=True) - 2.0 * vals
    return vals, idx, ok


def serve(label, encoder, collator, index, texts, text_rows, power,
          n_requests: int = N_REQUESTS, mode: str = "exact", self_tol=None) -> dict:
    """Drive RetrievalEngine over ``index``: ``n_requests`` requests from 4
    threads, then one request at a time of 1, 8 and 32 texts. Checks the
    self-hits, the kernels' launch counts, and every served batch (its
    capture flag and its result) against the same search through the plain
    versions. ``mode`` is the retriever's ``search_mode`` (the engine keeps
    ``mode=None``); for an l2 index each text's own row must lie within
    ``self_tol`` (squared distance)."""
    from kirag_tpu_torch.kernels import reset_launch_counts
    from kirag_tpu_torch.retrieval import DenseRetriever
    from kirag_tpu_torch.serving import RetrievalEngine

    recorder = RecordingIndex(index)
    retriever = DenseRetriever(encoder, collator, indexer=recorder, batch_size=32,
                               search_mode=mode)
    engine = RetrievalEngine(retriever, max_batch=32, max_wait_ms=5.0, topk_buckets=(10, K))
    recorder.calls.clear()  # warmup searches are not part of the run
    reset_launch_counts()
    requests, results, latencies, wall = drive_engine(engine, texts, n_requests, label)
    n_threaded = len(recorder.calls) - len(LONE_REQUESTS)  # a lone request is one batch
    lone = {n: results[n_requests + i] for i, n in enumerate(LONE_REQUESTS)}
    counts = main_path_counts()
    engine.close()
    quant = index.compression
    # K2 runs when a search re-dispatches: padded batches do on an inner-product
    # index (their zero rows fail the flag), not on an l2 one (the norm column
    # gives a zero row real scores). select="merge" never re-dispatches: it runs
    # K2 inside the search when its window check fails, and reports True
    merge = mode == "exact" and index.pallas_select == "merge"
    names = (k5_name(quant),) if mode == "approx" else kernel_names(quant)[:1]
    if merge:
        names += ("window_merge",)
    if not all(counts[k] > 0 for k in names):
        raise AssertionError(f"{label}: a kernel of the path was not launched: {counts}")

    margins, self_dist = [], 0.0
    for r, request in enumerate(requests):
        for j, row in zip(request, results[r]):
            want = str(text_rows[j])
            if row[0]["id"] != want or len(row) != K:
                raise AssertionError(f"{label}: text {j} top-1 is {row[0]['id']}, "
                                     f"not its own row {want}")
            margins.append(abs(row[0]["score"] - row[1]["score"]))
            if index.metric == "l2":
                self_dist = max(self_dist, abs(row[0]["score"]))
    if index.metric == "l2" and not self_dist <= self_tol:
        raise AssertionError(f"{label}: a text lies {self_dist} from its own row "
                             f"(limit {self_tol})")

    # the engine's batches searched again through the plain versions; the
    # stored ids are row numbers (shuffled layouts map them back to rows)
    row_of = {str(db_id): i for i, db_id in enumerate(index.index_id_to_db_id)}
    by_rows, from_capture = {}, []
    for q, top_docs, out, redispatched in recorder.calls:
        q_pad = np.zeros((max(8, 1 << (len(q) - 1).bit_length()), q.shape[1]), np.float32)
        q_pad[:len(q)] = q
        what = f"{label} served batch of {len(q)}"
        ref_vals, ref_idx, ref_ok = plain_search(index, q_pad, top_docs, mode)
        if ref_ok is not None:
            if bool(ref_ok) == redispatched:
                raise AssertionError(f"{what}: capture flag {not redispatched} with the "
                                     f"kernels, {bool(ref_ok)} with the plain versions")
            if not redispatched:
                from_capture.append(len(q))
        vals = torch.tensor(np.stack([s for _, s in out]))
        idx = torch.tensor([[row_of[i] for i in ids] for ids, _ in out])
        check_topk_close(vals, idx, ref_vals[:len(q)], ref_idx[:len(q)], what)
        by_rows[len(q_pad)] = by_rows.get(len(q_pad), 0) + 1
    if mode == "exact" and not from_capture:
        raise AssertionError(f"{label}: no search was answered from the capture")
    redispatched = len(recorder.calls) - len(from_capture)
    if mode == "exact" and not merge and (
            (redispatched > 0) != (counts[kernel_names(quant)[1]] > 0)):
        raise AssertionError(f"{label}: {redispatched} searches re-dispatched, launches {counts}")

    stats = {**traffic_stats(requests, latencies, wall), "launches": counts,
             "searches": len(recorder.calls), "redispatched": redispatched, "lone": lone}
    if merge:
        searched = (f"none re-dispatched (merge), K2 ran inside "
                    f"{counts[kernel_names(quant)[1]]} of them (window check failed); ")
    elif mode == "exact":
        searched = (f"{redispatched} re-dispatched, {len(from_capture)} answered from the "
                    f"capture (real rows {from_capture}); ")
    else:
        searched = f"approximate, {index.approx_winners} winners a group; "
    l2 = f", largest distance to its own row {self_dist:.3g}" if index.metric == "l2" else ""
    log(f"  {label}: {n_requests} requests from 4 threads in {n_threaded} batches, then "
        f"requests of 1, 8 and 32 texts alone: all self-hits at top-1 (smallest margin "
        f"{min(margins):.4f}{l2}); {len(recorder.calls)} searches by padded rows "
        f"{dict(sorted(by_rows.items()))}, {searched}"
        f"launches { {k: v for k, v in counts.items() if v} }; every served batch's "
        "result matches the plain search")
    log(f"  [{power}] {label} engine: {stats['rps']:.2f} requests/s "
        f"({stats['texts_per_s']:.2f} texts/s), latency p50 {stats['p50_ms']:.2f} ms, "
        f"p95 {stats['p95_ms']:.2f} ms ({n_requests} requests, host clock, 4 threads)")
    return stats


def index_kernels(label, index, gen, power, err, query_counts=(8, 16, 32)) -> dict:
    """K1 and K2 against their plain versions on the served index itself
    (its rows, its capture budget): outputs compared as in phase 3 (largest
    errors into ``err``), then timed with CUDA events, median of 10 runs."""
    from kirag_tpu_torch.kernels import (gather_groups, gather_groups_plain, stream_capture,
                                         stream_capture_plain)
    from kirag_tpu_torch.ops import hier_topk
    from kirag_tpu_torch.ops.exact import _capture_budget

    corpus, scales, valid = index._device_corpus, index._device_scales, index._device_rows
    quant = kernel_quant(index.compression)
    k1, k2 = kernel_names(quant)
    b = _capture_budget(K, len(corpus) // CHUNK, CHUNK // 128)
    times = {}
    for n_q in query_counts:
        what = f"{label} Q={n_q}"
        q = unit_rows(n_q, gen, corpus.device).to(index.device_dtype)
        got = stream_capture(q, corpus, valid, CHUNK, b, scales, quant)
        k1_err, swapped = capture_error(
            got, stream_capture_plain(q, corpus, valid, CHUNK, b, scales, quant), what)
        gsel = torch.sort(hier_topk(got[0].reshape(-1, n_q).T, K)[1], dim=-1).values
        cand = gather_groups(q, corpus, gsel, scales, quant)
        k2_err = gather_error(cand, gather_groups_plain(q, corpus, gsel, scales, quant), what)
        k1_bound = search_bound(q, corpus, scales, quant, got)
        k2_bound = gather_bound(q, corpus, scales, quant, gsel, cand)
        del got, cand
        err[k1] = max(err.get(k1, 0.0), k1_err)
        err[k2] = max(err.get(k2, 0.0), k2_err)
        t = {
            "stream_capture": cuda_ms(
                lambda: stream_capture(q, corpus, valid, CHUNK, b, scales, quant)),
            "stream_capture_plain": cuda_ms(
                lambda: stream_capture_plain(q, corpus, valid, CHUNK, b, scales, quant)),
            "gather_groups": cuda_ms(lambda: gather_groups(q, corpus, gsel, scales, quant)),
            "gather_groups_plain": cuda_ms(
                lambda: gather_groups_plain(q, corpus, gsel, scales, quant)),
            "stream_capture_bound": k1_bound, "gather_groups_bound": k2_bound,
        }
        lib = ""
        lib2 = ""
        if quant == "none":  # the PyTorch calls for K1's maxima alone and for K2
            t["stream_capture_library"] = cuda_ms(lambda: library_gmax(q, corpus))
            t["gather_groups_library"] = cuda_ms(lambda: library_gather(q, corpus, gsel))
            lib = (f", library (matmul + amax, the maxima only) "
                   f"{t['stream_capture_library']:.3f} ms; {plan_text(n_q, corpus, b)}")
            lib2 = (f", library (gather of the groups' rows + a batched product"
                    f"{', bf16 scores' if corpus.dtype == torch.bfloat16 else ''}) "
                    f"{t['gather_groups_library']:.3f} ms")
            # one sweep and one peel kernel a call: the counts of a profiled
            # window agree. The profiler can drop a record of these short
            # kernels, so a window that disagrees is profiled again, up to
            # three; a call that started other kernels disagrees in every one.
            for window in range(1, 4):
                split = kernels_per_call(
                    lambda: stream_capture(q, corpus, valid, CHUNK, b, scales, quant),
                    FLOAT_K1_KERNELS)
                seen = [split.get(k, [0])[0] for k in FLOAT_K1_KERNELS] if split else []
                if split is None or (len(set(seen)) == 1 and seen[0] >= 1):
                    break
                log(f"  {what}: profiled window {window} saw {split}")
            else:
                raise AssertionError(f"{what}: float K1 calls are not one sweep and one peel "
                                     f"kernel each in 3 profiled windows: {split}")
            t["stream_capture_kernels"] = split
            lib += "; " + kernels_text(split)
        else:  # the sweep and peel kernels' device time, reported (the kernels a call
            # are checked in a fresh process, phase 11 a)
            split = kernels_per_call(
                lambda: stream_capture(q, corpus, valid, CHUNK, b, scales, quant),
                FLOAT_K1_KERNELS)
            t["stream_capture_kernels"] = split
            lib = f"; {plan_text(n_q, corpus, b, scales, quant)}; " + kernels_text(split)
        times[n_q] = t
        log(f"  {what}: K1 max abs err {k1_err:.3g} ({swapped} gids differ at near-ties), "
            f"K2 max abs err {k2_err:.3g}")
        log(f"  [{power}] {what}, {len(corpus)} x {DIM}, k={K}, capture {b} of "
            f"{CHUNK // 128} groups per chunk: K1 {t['stream_capture']:.3f} ms vs plain "
            f"{t['stream_capture_plain']:.3f} ms (bound {k1_bound[0]:.3f} ms, {k1_bound[1]}{lib}); "
            f"K2 {t['gather_groups']:.3f} ms vs plain {t['gather_groups_plain']:.3f} ms "
            f"(bound {k2_bound[0]:.3f} ms, {k2_bound[1]}, "
            f"{int(torch.unique(gsel).numel())} distinct groups{lib2}) (CUDA events, median "
            "of 10)")
    return times


def search_bound(q, corpus, scales, quant: str, outs):
    """K1's bound: the corpus (and its scales) and the queries read once,
    the outputs written once; 2 * Q * N * D operations, on the CUDA cores'
    f32 rate for a float corpus (not TF32X3_FLOP_S: the float sweeps share
    one fma order bitwise, which tensor-core sums cannot keep) and at the
    bf16 tensor-core rate for a quantized one (its codes and levels are
    exact in bf16, as on the reference's matrix unit)."""
    n_q, d = q.shape
    ops_s = F32_FLOP_S if quant == "none" else BF16_FLOP_S
    extra = () if scales is None else (scales,)
    return bound(nbytes(q, corpus, *extra, *outs), 2 * n_q * len(corpus) * d, ops_s)


def library_gmax(q, corpus):
    """One PyTorch call's worth of K1's and K7a's work on a float corpus:
    every score by ``torch.matmul`` (TF32 off; a bf16 corpus gives bf16
    scores) and the 128-row group maxima by ``amax``. It computes the maxima
    only, not the capture or the stored scores."""
    return torch.matmul(q, corpus.T).view(len(q), -1, 128).amax(-1)


def library_group_max(q, corpus, winners: int):
    """One PyTorch call's worth of K5's work on a float corpus: every score by
    ``torch.matmul`` (TF32 off; a bf16 corpus gives bf16 scores) viewed
    [Q, G, 128], then ``max`` (W = 1: values and a maximal lane) or
    ``topk`` (W > 1: the W largest and their lanes) over each group."""
    s = torch.matmul(q, corpus.T).view(len(q), -1, 128)
    return s.max(-1) if winners == 1 else s.topk(winners, -1)


def library_gather(q, corpus, gsel):
    """One PyTorch call's worth of K2's work on a float corpus: the selected
    groups' rows by ``index_select`` on the [G, 128 D] view and their scores
    by a batched product (TF32 off; bf16 rows give bf16 scores)."""
    d = corpus.shape[1]
    rows = corpus.view(-1, 128 * d).index_select(0, gsel.reshape(-1))  # [Q k, 128 D]
    return torch.matmul(rows.view(len(q), -1, d), q[:, :, None]).view(len(q), -1, 128)


FLOAT_K1_KERNELS = ("capture_sweep_kernel", "peel_capture_kernel")  # one K1 launch count
# (every format's K1 alike)


def profile_lead_in() -> None:
    """The first thing inside a torch.profiler window: PROFILE_LEAD_SPINS
    short spins, then one of PROFILE_LEAD_CYCLES, each waited out by the
    host, so the kernels the window counts run well after it opens and
    after several kernel records. On some H100 machines, late in a long
    process, the profiler loses a window's first kernel records: the same
    1-3 K1 kernels missing from each of three windows running, once all 30
    kernels of ten short calls, and behind one 20 ms spin still one K1
    sweep in each of three windows (in another run one whole K1 call)."""
    for _ in range(PROFILE_LEAD_SPINS):
        torch.cuda._sleep(PROFILE_LEAD_CYCLES // 100)
        torch.cuda.synchronize()
    torch.cuda._sleep(PROFILE_LEAD_CYCLES)
    torch.cuda.synchronize()


def kernels_per_call(fn, names, reps: int = 10):
    """The kernels ``reps`` profiled calls of ``fn`` start (torch.profiler),
    by the first of ``names`` in each kernel's name: {name: [kernels seen,
    device ms each]}, or None when the profiler saw no device time (not
    measured). The profiler may miss a call's kernels: compare the counts
    with each other, not with ``reps``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profile_lead_in()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {n: [0, 0.0] for n in (*names, "other")}
    for evt in prof.events():
        if (evt.device_type == DeviceType.CUDA and evt.device_time_total > 0
                and SPIN_KERNEL not in evt.name):
            slot = out[next((n for n in names if n in evt.name), "other")]
            slot[0] += 1
            slot[1] += evt.device_time_total / 1e3
    if not any(n for n, _ in out.values()):
        return None
    return {k: [n, ms / n] for k, (n, ms) in out.items() if n}


def kernels_text(split) -> str:
    if split is None:
        return "kernels of 10 calls: not measured (the profiler saw no device time)"
    return ("kernels of 10 calls (torch.profiler): "
            + ", ".join(f"{n} x {k} {ms:.4f} ms each" for k, (n, ms) in split.items()))


def plan_text(n_q: int, corpus, b: int = 0, scales=None, quant: str = "none") -> str:
    """How the tree's K1 (b > 0) or K7a (b == 0) cuts a call over ``corpus``
    stored in ``quant``'s format (chunk CHUNK), for the timing lines."""
    from kirag_tpu_torch.kernels.exact import corpus_plan
    p = corpus_plan(n_q, len(corpus) // CHUNK, CHUNK // 128, corpus, scales, quant, b)
    held = (f", scratch slots a (range, query): {p.slots}"
            + (" holding the best" if p.tracks_best else "")) if b else ""
    return (f"plan: {p.q_tiles} x {p.q_tile}-query tiles, {p.splits} ranges a chunk of "
            f"{p.groups_per_block} group(s), {p.blocks} blocks, {p.smem} B of shared "
            f"memory{held}")


def gather_bound(q, corpus, scales, quant: str, gsel, cand):
    """K2's bound: the selected groups' rows (each distinct group once) and
    their scales (pq4: the one level table), the queries and group ids read,
    the scores written; 2 * Q * k * 128 * D operations (rates as in
    :func:`search_bound`)."""
    n_q, d = q.shape
    groups = int(torch.unique(gsel).numel())
    row_bytes = corpus.shape[1] * corpus.element_size()
    shared = nbytes(q, gsel, cand)
    if quant == "pq4":
        shared += nbytes(scales)
    elif scales is not None:
        row_bytes += scales[0].numel() * scales.element_size()
    ops_s = F32_FLOP_S if quant == "none" else BF16_FLOP_S
    return bound(groups * 128 * row_bytes + shared, 2 * gsel.numel() * 128 * d, ops_s)


# ----------------------------------------------------------------- phase 6

# a fixed list of 400 made-up words, from which the passages are drawn
WORDS = [a + b for a in ("ka", "lo", "mi", "ne", "ru", "sa", "to", "vi", "ze", "qu", "bra",
                         "stel", "mon", "dar", "fen", "gil", "hor", "jun", "pel", "wex")
         for b in ("n", "ra", "tis", "lo", "ven", "dor", "ka", "mir", "sel", "ton", "ar", "us",
                   "eth", "ine", "ock", "ba", "zu", "rel", "ix", "om")]


def write_corpus(path: Path) -> None:
    """A DPR-format passage TSV (``id \t text \t title`` and a header row),
    made from SEED: the SECTIONS of passages in turn, words from WORDS, one in
    five followed by a comma or a full stop."""
    rng = np.random.RandomState(SEED)
    words = np.array(WORDS)
    lines, pid = ["id\ttext\ttitle"], 0
    for n_psg, (lo, hi), _ in SECTIONS:
        for n in rng.randint(lo, hi + 1, n_psg):
            marks = rng.choice(np.array(["", ",", "."]), size=n, p=[0.8, 0.12, 0.08])
            text = " ".join(np.char.add(words[rng.randint(0, len(words), n)], marks))
            title = " ".join(words[rng.randint(0, len(words), 2)]).title()
            pid += 1
            lines.append(f"{pid}\t{text}\t{title}")
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


class TimedTokenizer(HashTokenizer):
    """The hashing tokenizer, adding up the host seconds it takes."""

    def __init__(self):
        super().__init__()
        self.seconds = 0.0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return super().__call__(*args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0


class TimedEncoder:
    """Passes batches through to the encoder and records each batch's token
    length and host seconds up to ``torch.cuda.synchronize()``."""

    def __init__(self, encoder):
        self.encoder = encoder
        self.batches = []

    def __call__(self, input_ids, attention_mask):
        t0 = time.perf_counter()
        out = self.encoder(input_ids, attention_mask)
        torch.cuda.synchronize()
        self.batches.append((input_ids.shape[1], time.perf_counter() - t0))
        return out


def flash_segments(b: int, t: int, dev) -> torch.Tensor:
    """[b, t] segment ids, four kinds of row in turn: right-padded (random
    length), unpadded, all padding, and 2-4 packed documents with a padded
    tail."""
    rng = np.random.RandomState(t)
    seg = np.zeros((b, t), np.int32)
    for i in range(b):
        kind = i % 4
        if kind == 0:
            seg[i, :rng.randint(1, t)] = 1
        elif kind == 1:
            seg[i] = 1
        elif kind == 3:
            cuts = np.sort(rng.choice(np.arange(1, t), rng.randint(2, 5), replace=False))
            for j, (lo, hi) in enumerate(zip(np.r_[0, cuts[:-1]], cuts)):
                seg[i, lo:hi] = j + 1
    return torch.from_numpy(seg).to(dev)


def bf16_ulps(x: torch.Tensor, n: int = 2) -> float:
    """n bf16 ulps at the largest magnitude of x (8 significant bits)."""
    return n * 2.0 ** (math.floor(math.log2(float(x.abs().max()))) - 7)


def check_flash(dev, gen, heads: int, power) -> dict:
    """K3 against its plain version at the encoder's shapes ([128, 16, T, 64],
    T = 128, 256, 512; q, k, v as views of one fused projection, as the
    encoder passes them), bf16 and f32, on flash_segments' mixed rows and
    with every token real: the output, each row's lse (m + log l, what the
    backward reads) within 1e-5 of the plain logsumexp, and a second launch
    bitwise the first. Then K3, the plain version and
    scaled_dot_product_attention with the same-segment boolean mask (the
    library's call for this function, a yardstick only), timed with CUDA
    events, median of 10. Keyed (dtype, T, layout)."""
    from kirag_tpu_torch.kernels import flash_attention, flash_attention_plain
    from kirag_tpu_torch.kernels.attention import _forward

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for t in (128, 256, 512):
            for layout in BWD_LAYOUTS:
                what = f"K3 {str(dtype)[6:]} [{BATCH}, {heads}, {t}, 64] {layout}"
                seg = bwd_segments(layout, BATCH, t, dev)
                qkv = torch.randn(BATCH, t, 3 * heads * 64, generator=gen, device=dev).to(dtype)
                q, k, v = (x.view(BATCH, t, heads, 64).transpose(1, 2)
                           for x in qkv.split(heads * 64, dim=-1))
                got = flash_attention(q, k, v, seg, 0.125)
                again, lse = _forward(q, k, v, seg, 0.125, with_lse=True)
                want, want_lse = flash_attention_plain(q, k, v, seg, 0.125, return_lse=True)
                mask = (seg[:, None, :, None] == seg[:, None, None, :])
                sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, attn_mask=mask, scale=0.125)
                lib_err = float((sdpa().float() - want.float()).abs().max())
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                lse_err = float((lse - want_lse).abs().max())
                tol = 1e-5 if dtype == torch.float32 else bf16_ulps(want)
                if not (torch.isfinite(got).all() and err <= tol and lse_err <= 1e-5):
                    raise AssertionError(f"{what}: K3 differs from plain by {err} > {tol}, "
                                         f"or its lse by {lse_err} > 1e-5, or is not finite")
                if not torch.equal(got, again):
                    raise AssertionError(f"{what}: two launches on the same inputs differ")
                # each input read once, the output written once; 4 * 64 flops per
                # same-segment (query, key) pair and head, in QK^T and PV; f32 at
                # the split-TF32 rate, and beside it at the CUDA cores' (the rate
                # the f32 kernels were first bound at)
                pairs = int((seg[:, :, None] == seg[:, None, :]).sum())
                kb = bound(nbytes(q, k, v, got, seg), 4 * 64 * heads * pairs,
                           BF16_FLOP_S if dtype == torch.bfloat16 else TF32X3_FLOP_S)
                kb_cc = bound(nbytes(q, k, v, got, seg), 4 * 64 * heads * pairs, F32_FLOP_S)
                # the bf16 kernel's blocks own 64 queries, the f32 kernel's 128
                skipped = tile_pairs_skipped(seg, 64 if dtype == torch.bfloat16 else 128)
                r = {"err": err, "tol": tol, "bound": kb, "bound_cuda_cores": kb_cc,
                     "ms": cuda_ms(lambda: flash_attention(q, k, v, seg, 0.125)),
                     "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, seg, 0.125)),
                     "library_ms": cuda_ms(sdpa)}
                out[(dtype, t, layout)] = r
                log(f"  {what}: max abs err {err:.3g} (tolerance {tol:.3g}; SDPA vs plain "
                    f"{lib_err:.3g}); lse within {lse_err:.3g} (1e-5); a second launch "
                    f"bitwise equal; same-segment pairs {pairs / (BATCH * t * t):.3f} of all; "
                    f"(query block, key tile) pairs skipped {skipped:.3f} of all")
                cc = ("" if dtype == torch.bfloat16 else
                      f" at 3xTF32's {TF32X3_FLOP_S / 1e12:.0f} TFLOP/s; at the CUDA cores' "
                      f"{F32_FLOP_S / 1e12:.0f}: {kb_cc[0]:.4f} ms ({kb_cc[1]})")
                log(f"  [{power}] {what}: K3 {r['ms']:.4f} ms vs plain {r['plain_ms']:.3f} ms, "
                    f"SDPA with mask {r['library_ms']:.4f} ms; bound {kb[0]:.4f} ms ({kb[1]})"
                    f"{cc} (CUDA events, median of 10)")
                del q, k, v, qkv, got, again, want, lse, want_lse, mask
    return out


GEMM_WORDS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")  # cuBLAS's kernel names


def kernel_times(prof, groups):
    """Device time (microseconds) of a torch.profiler run's kernels, the
    kernels themselves and not the ops that launched them: by group, the
    first of ``groups`` ((label, words) pairs) one of whose words is in the
    kernel's lower-cased name, then "GEMM", else "other"; and by kernel
    name."""
    from torch.autograd import DeviceType

    groups = (*groups, ("GEMM", GEMM_WORDS))
    split = {label: 0.0 for label, _ in groups}
    split["other"] = 0.0
    by_name = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA or SPIN_KERNEL in evt.name:
            continue
        by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.device_time_total
        name = evt.name.lower()
        label = next((label for label, words in groups if any(w in name for w in words)),
                     "other")
        split[label] += evt.device_time_total
    return split, by_name


def profile_encoder(encoder, batches, power) -> None:
    """Device time of one encoder batch per bucket by kernel (torch.profiler):
    K3, the GEMMs, and the rest (LayerNorm, GELU, casts, copies)."""
    from torch.profiler import ProfilerActivity, profile

    for t, (ids, mask) in batches.items():
        encoder(ids, mask)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            encoder(ids, mask)
            torch.cuda.synchronize()
        split, by_name = kernel_times(prof, [("K3", ("flash_bf16_kernel",
                                                      "flash_f32_kernel"))])
        total = sum(split.values())
        if total <= 0:
            log(f"  profiler: no device time for the {t}-token batch (not measured)")
            continue
        log(f"  [{power}] encoder batch {BATCH} x {t} tokens, device time by kernel "
            f"(torch.profiler): total {total / 1e3:.2f} ms; "
            + ", ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / total:.1f}%)"
                        for k, v in split.items()))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log("    largest: " + "; ".join(f"{n[:70]} {v / 1e3:.2f} ms" for n, v in top))


def index_build(work: Path, dev, gen, config, power, err) -> dict:
    """Phase 6, the offline index build: write a DPR-format corpus, save the
    seeded encoder in the reference's npz format, run the port's
    compute_corpus_embeddings and build_index CLIs, reload the index on the
    card and search it. Then hold K3, the encoder and the index against
    their references, and time K3. Everything is written under ``work``;
    returns the launches, K3's figures and the paths phase 9 reads."""
    from kirag_tpu_torch.cli import build_index
    from kirag_tpu_torch.cli import compute_corpus_embeddings as embed_cli
    from kirag_tpu_torch.data import CORPUS_MAP, E5Collator
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.kernels import launch_counts, reset_launch_counts
    from kirag_tpu_torch.models import BertModel, Encoder, load_encoder
    from kirag_tpu_torch.retrieval import DenseRetriever

    t0 = time.perf_counter()
    tsv = work / "psgs_w100.tsv"
    write_corpus(tsv)
    corpus = CORPUS_MAP["wikipedia"](corpus_path=str(tsv), title_prefix="title:",
                                     passage_prefix="text:")
    n_psg = sum(n for n, _, _ in SECTIONS)
    if len(corpus) != n_psg:
        raise AssertionError(f"corpus holds {len(corpus)} passages, wrote {n_psg}")
    model_dir = work / "e5-large-seeded"
    model = BertModel(config, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    Encoder(model, "e5").save(str(model_dir))
    del model
    log(f"  corpus: {n_psg} passages in sections of {[n for n, _, _ in SECTIONS]} "
        f"({os.path.getsize(tsv) / 1e6:.1f} MB TSV); encoder saved as npz; "
        f"{time.perf_counter() - t0:.1f} s of set-up")

    tokenizer = TimedTokenizer()
    argv = ["--retriever_model_name_or_path", str(model_dir), "--corpus", "wikipedia",
            "--corpus_path", str(tsv), "--per_device_batch_size", str(BATCH),
            "--num_passage_per_index_file", str(SHARD_ROWS), "--save_dir", str(work),
            "--name", "e5_seeded"]
    build_encoder, timed = embed_cli.build_encoder, []

    def build_timed(args, device=None):  # records each batch the CLI embeds
        t0 = time.perf_counter()
        timed.append(TimedEncoder(build_encoder(args, device)))
        timed[-1].load_s = time.perf_counter() - t0
        return timed[-1]

    embed_cli.build_encoder = build_timed
    reset_launch_counts()
    try:
        t0 = time.perf_counter()
        shard_dir = embed_cli.main(argv, tokenizer=tokenizer)
        embed_s = time.perf_counter() - t0
    finally:
        embed_cli.build_encoder = build_encoder
    t0 = time.perf_counter()
    index_dir = build_index.main(["--embeddings_dir", shard_dir, "--embedding_size",
                                  str(DIM), "--save_dir", str(work / "index")])
    index_s = time.perf_counter() - t0
    # the retrieve step: a fresh index on the card loads what was built
    t0 = time.perf_counter()
    index = TorchIndexer(DIM, device=dev)
    index.deserialize_from(index_dir)
    encoder = timed[0].encoder
    collator = E5Collator(tokenizer, 512, 512)
    retriever = DenseRetriever(encoder, collator, indexer=index, corpus=corpus)
    shard_files = build_index.discover_shards(shard_dir)
    stored, ids = [], []
    for path in shard_files:
        with np.load(path, allow_pickle=True) as data:
            stored.append(data["embeddings"])
            ids.extend(data["passage_ids"])
    stored = np.concatenate(stored)
    rows = np.sort(np.random.RandomState(SEED).choice(n_psg, 64, replace=False))
    found = index.search_knn(stored[rows], top_docs=10)
    docs = retriever.get_documents([ids[r] for r in rows])
    again = retriever.calculate_document_embeddings([corpus[r]["passage"] for r in rows])
    # three passages asked as questions: the batch is padded to 4 rows by
    # the retriever and to 8 by the index, fails the capture flag and
    # re-dispatches through K2
    before = index.redispatches
    asked = retriever([corpus[r]["passage"] for r in rows[:3]], topk=10)
    torch.cuda.synchronize()
    retrieve_s = time.perf_counter() - t0
    counts = main_path_counts()

    # -- K1 and K2 against their plain versions at this index's shapes
    k2_built = index_kernels("built index", index, gen, power, err, query_counts=(8, 64))

    # -- the path ran through every kernel, and its outputs are right
    lengths = [t for t, _ in timed[0].batches]
    want_lengths = [t for n, _, t in SECTIONS for _ in range(n // BATCH)]
    if lengths != want_lengths:
        raise AssertionError(f"batches landed in buckets {sorted(set(lengths))}, not "
                             f"the sections' {[t for _, _, t in SECTIONS]}")
    if counts["flash_attention"] < config.num_hidden_layers * len(lengths) or not (
            counts["stream_capture"] > 0 and counts["gather_groups"] > 0):
        raise AssertionError(f"index build: a kernel of the path was not launched "
                             f"(or too few times): {counts}")
    norms = np.linalg.norm(stored, axis=-1)
    if not (stored.shape == (n_psg, DIM) and stored.dtype == np.float32
            and np.isfinite(stored).all() and np.abs(norms - 1).max() < 1e-5
            and len(shard_files) == n_psg // SHARD_ROWS
            and ids == [corpus[i]["passage_id"] for i in range(n_psg)]):
        raise AssertionError(f"shards: {len(shard_files)} files, {stored.shape}, "
                             f"norms {norms.min()}..{norms.max()}")
    if not (rows.min() < SHARD_ROWS <= rows.max()):
        raise AssertionError("the sampled rows do not span both shards")
    for r, (db_ids, scores) in zip(rows, found):
        if db_ids[0] != ids[r] or abs(float(scores[0]) - 1.0) > 1e-4:
            raise AssertionError(f"stored row {r} found {db_ids[0]} at {scores[0]}, "
                                 f"not itself ({ids[r]}) at 1")
    if [d["title"] for d in docs] != [corpus.data[r]["title"] for r in rows]:
        raise AssertionError("get_documents returned other titles")
    cos = np.sum(again * stored[rows], axis=-1)
    if not cos.min() >= 0.999:
        raise AssertionError(f"re-embedded passages: cosine {cos.min()} < 0.999")
    if index.redispatches <= before or not all(
            len(hits) == 10 and all(h["title"] for h in hits) for hits in asked):
        raise AssertionError("the padded retrieval did not re-dispatch or lacks hits")
    others = stored[rows] @ stored[rows].T - 2 * np.eye(len(rows))
    log(f"  compute_corpus_embeddings -> {len(shard_files)} shards of {stored.shape}: "
        f"{embed_s:.2f} s; build_index {index_s:.2f} s; reload + search + retrieve "
        f"{retrieve_s:.2f} s; launches {counts}")
    log(f"  64 stored rows across both shards found themselves at top-1 (score within "
        f"{max(abs(float(s[0]) - 1) for _, s in found):.2g} of 1; largest cosine "
        f"between two of them {others.max():.4f}); titles joined; re-embedded through "
        f"DenseRetriever: cosine >= {cos.min():.6f}; 3 passages asked as questions: "
        f"re-dispatched, 10 hits each")
    enc_s = sum(s for _, s in timed[0].batches)
    for _, _, t in SECTIONS:
        secs = [s for n, s in timed[0].batches if n == t]
        log(f"  [{power}] bucket {t}: {len(secs)} batches of {BATCH}, "
            f"{len(secs) * BATCH / sum(secs):.1f} passages/s in the encoder (host clock "
            f"to torch.cuda.synchronize())")
    load_s = timed[0].load_s
    log(f"  [{power}] whole embedding run: {n_psg / embed_s:.1f} passages/s; of "
        f"{embed_s:.2f} s, loading the encoder (npz -> card) {load_s:.2f} s, encoder "
        f"batches {enc_s:.2f} s, tokenizing {tokenizer.seconds:.2f} s, the rest (corpus "
        f"rendering, copies to the host, np.savez) "
        f"{embed_s - load_s - enc_s - tokenizer.seconds:.2f} s (host clock); the card "
        f"waits on the host for at least {embed_s - enc_s:.2f} s "
        f"({100 * (embed_s - enc_s) / embed_s:.1f}%)")
    log(f"  K3 launches: {counts['flash_attention']} = {config.num_hidden_layers} layers "
        f"x ({len(lengths)} CLI batches + the retriever's re-embedding and question "
        f"batches)")

    # -- K3 against its plain version, and its times
    flash = check_flash(dev, gen, config.num_attention_heads, power)
    err["flash_attention"] = max(r["err"] for (d, _, _), r in flash.items()
                                 if d == torch.bfloat16)
    err["flash_attention_f32"] = max(r["err"] for (d, _, _), r in flash.items()
                                     if d == torch.float32)

    # -- the encoder through K3 and through the plain attention path, one
    # batch per bucket, bf16 and f32 compute on the same weights
    batches = {}
    for start, (n, _, t) in zip(np.cumsum([0] + [n for n, _, _ in SECTIONS[:-1]]),
                                SECTIONS):
        enc = collator.encode_doc([corpus[i]["passage"] for i in range(start,
                                                                    start + BATCH)])
        if enc["input_ids"].shape[1] != t:
            raise AssertionError(f"section at {start}: bucket "
                                 f"{enc['input_ids'].shape[1]}, not {t}")
        batches[t] = (enc["input_ids"], enc["attention_mask"])
    f32 = load_encoder(str(model_dir), "e5", compute_dtype=torch.float32, device=dev)
    for label, model_enc in (("bf16", encoder), ("f32", f32)):
        flash_enc = Encoder(model_enc.model, "e5", model_enc.compute_dtype, "flash")
        plain_enc = Encoder(model_enc.model, "e5", model_enc.compute_dtype, "xla")
        for t, (ids_, mask) in batches.items():
            reset_launch_counts()
            a = flash_enc(ids_, mask)
            launched = launch_counts()["flash_attention"]
            b = plain_enc(ids_, mask)
            cos = float(torch.sum(a * b, dim=-1).min())
            diff = float((a - b).abs().max())
            # bf16: the two attention paths round differently; f32: 1e-4
            ok = cos >= 0.999 if label == "bf16" else diff <= 1e-4
            if not (ok and torch.isfinite(a).all()
                    and launched == config.num_hidden_layers):
                raise AssertionError(f"encoder {label} T={t}: K3 vs plain attention "
                                     f"cosine {cos}, max abs diff {diff}, {launched} "
                                     "K3 launches")
            log(f"  encoder {label}, batch {BATCH} x {t}: through K3 vs the plain "
                f"attention path, pooled cosine >= {cos:.7f}, max abs diff {diff:.3g}")
    del f32
    profile_encoder(encoder, batches, power)
    return {"launches": counts, "flash": flash, "k2": k2_built, "tsv": tsv,
            "model_dir": model_dir, "index_dir": index_dir, "shard_dir": shard_dir,
            "stored": stored, "ids": ids}


# ----------------------------------------------------------------- phase 7

# Llama-3-8B-Instruct's projections (LlamaConfig()): the distinct [in, out]
# shapes, each named by the projections that have it
QMM_SHAPES = (("q_proj, o_proj", 4096, 4096), ("k_proj, v_proj", 4096, 1024),
              ("gate_proj, up_proj", 4096, 14336), ("down_proj", 14336, 4096),
              ("lm_head", 4096, 128256))
QMM_ROWS = (1, 4, 16, 32)
L2_FLUSH_BYTES = 256 << 20  # more than the H100's 50 MB L2: each timed launch reads cold


def int4_error(got, want, abs_sum):
    """K6 against its plain version: each element within one bf16 ulp of
    |plain|, or, where the sum is near zero, within 2^-18 of the sum of its
    products' magnitudes (two f32 summation orders). Returns the largest
    difference, the elements over one ulp, and whether all are within."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    bound_ = torch.maximum(ulp, abs_sum * 2.0 ** -18)
    return float(diff.max()), int((diff > ulp).sum()), bool((diff <= bound_).all())


def check_qmm(dev, gen, power) -> dict:
    """K6 against its plain version at every projection shape of the 8B
    model, 1, 4, 16 and 32 rows, NF4 and linear int4, bf16 x, and a second
    launch bitwise the first; then K6, the plain version and torch.matmul of
    x with the dequantized bf16 kernel (the bf16 model's product for the same
    layer, 4x the weight bytes; a yardstick only), timed with CUDA events,
    median of 10, the L2 cache flushed before each run. K6 is also timed at
    every cluster size the shape allows (``qmm.launch``), the evidence for
    ``qmm.SPLIT_RULE``."""
    from kirag_tpu_torch.kernels import int4_matmul, int4_matmul_plain
    from kirag_tpu_torch.kernels.qmm import MAX_CLUSTER, dequant_nibbles, launch, plan
    from kirag_tpu_torch.models.llm import _quantize_kernel_int4, _quantize_kernel_nf4

    scratch = torch.zeros(L2_FLUSH_BYTES // 4, device=dev)
    flush = scratch.sum  # reads evict the L2 without leaving dirty lines to write back
    out = {}
    for names, in_dim, out_dim in QMM_SHAPES:
        kernel = torch.randn(in_dim, out_dim, generator=gen, device=dev) * 0.02
        for fmt, quantize in (("nf4", _quantize_kernel_nf4), ("int4", _quantize_kernel_int4)):
            p = quantize(kernel)
            packed, scales, cb = p["kernel_q4"], p["kernel_scale4"], p.get("kernel_cb4")
            lo, hi = dequant_nibbles(packed, cb)
            block_scale = scales.repeat_interleave(64, dim=0)
            w_abs = torch.stack([lo.abs(), hi.abs()], dim=1).reshape(in_dim, out_dim) * block_scale
            w_bf16 = (torch.stack([lo, hi], dim=1).reshape(in_dim, out_dim)
                      * block_scale).to(torch.bfloat16)
            del lo, hi, block_scale
            for rows in QMM_ROWS:
                what = f"K6 {fmt} {names} [{in_dim // 2}, {out_dim}] x {rows} rows"
                x = torch.randn(rows, in_dim, generator=gen, device=dev).to(torch.bfloat16)
                got = int4_matmul(x, packed, scales, cb)
                again = int4_matmul(x, packed, scales, cb)
                want = int4_matmul_plain(x, packed, scales, cb)
                err, over_ulp, ok = int4_error(got, want, x.float().abs() @ w_abs)
                torch.cuda.synchronize()
                if not (ok and torch.isfinite(got).all() and got.dtype == torch.bfloat16):
                    raise AssertionError(f"{what}: differs from plain by {err} beyond one "
                                         "bf16 ulp and the f32 bound, or is not finite")
                if not torch.equal(got, again):
                    raise AssertionError(f"{what}: a second launch differs from the first")
                kb = bound(nbytes(x, packed, scales, got) + (64 if cb is not None else 0),
                           2 * rows * in_dim * out_dim, BF16_FLOP_S)
                r = {"err": err, "over_ulp": over_ulp, "bound": kb,
                     "ms": cuda_ms(lambda: int4_matmul(x, packed, scales, cb), flush=flush),
                     "plain_ms": cuda_ms(lambda: int4_matmul_plain(x, packed, scales, cb),
                                         flush=flush),
                     "library_ms": cuda_ms(lambda: torch.matmul(x, w_bf16), flush=flush)}
                cut = plan(rows, in_dim // 2, out_dim, cb is not None)
                r["clusters"] = {}
                for c in (2 ** i for i in range(MAX_CLUSTER.bit_length())):
                    if (in_dim // 64) % c == 0:
                        at_c = dataclasses.replace(cut, cluster=c, steps=in_dim // 64 // c)
                        r["clusters"][c] = cuda_ms(lambda: launch(x, packed, scales, cb, at_c),
                                                   flush=flush)
                r["planned"] = cut.cluster
                out[(fmt, names, rows)] = r
                log(f"  {what}: max abs err {err:.3g} ({over_ulp} of {got.numel()} elements "
                    f"beyond one bf16 ulp, all within the f32 bound), a second launch bitwise; "
                    f"[{power}] K6 {r['ms']:.4f} ms (grid {cut.grid}, clusters of "
                    f"{cut.cluster}) vs plain {r['plain_ms']:.3f} ms, bf16 matmul "
                    f"{r['library_ms']:.4f} ms; bound {kb[0]:.4f} ms ({kb[1]}) (CUDA events, "
                    "median of 10, cold L2); K6 by cluster size: " + ", ".join(
                        f"{c} {ms:.4f}" for c, ms in r["clusters"].items()))
            del p, packed, scales, cb, w_abs, w_bf16
        del kernel
        torch.cuda.empty_cache()
    behind = {key: r["clusters"][r["planned"]] / min(r["clusters"].values()) - 1
              for key, r in out.items()}
    worst = max(behind, key=behind.get)
    log(f"  [{power}] the plan's cluster size was the fastest in "
        f"{sum(v == 0 for v in behind.values())} of {len(out)} cases; at most "
        f"{100 * behind[worst]:.1f}% behind the fastest size ({' '.join(map(str, worst))})")
    return out


# ----------------------------------------------------------------- phase 8

LLM_ROWS = 4                             # the Generator's batch_size
LLM_PROMPTS = (1800, 900, 400, 100)      # prompt tokens per row: the 2048 bucket
LLM_NEW_TOKENS = 64                      # the constructor's max_new_tokens
PREFILL_BUCKETS = (128, 512, 2048, 4096)
EOS_ID = 128009                          # Llama-3-Instruct's <|eot_id|>


def left_padded_prompts(lengths, vocab: int, seed: int):
    rng = np.random.RandomState(seed)
    width = max(lengths)
    ids = np.zeros((len(lengths), width), np.int32)
    mask = np.zeros((len(lengths), width), np.int32)
    for i, n in enumerate(lengths):
        ids[i, width - n:] = rng.randint(0, min(vocab, 128000), n)
        mask[i, width - n:] = 1
    return ids, mask


def write_safetensors(path: Path, tensors: dict) -> None:
    """bf16 tensors into a ``.safetensors`` file: an 8-byte header length, a
    JSON header, then the raw little-endian bytes."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * 2
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.int16).cpu().numpy().tobytes())


def check_load_llama(work: Path, dev, config, power) -> dict:
    """load_llama reads a seeded full-width, 2-layer HF checkpoint (bf16
    safetensors) written here, quantizes it to NF4 on the card, and gives
    the bytes of quantizing the same tensors directly; 8 tokens through K6."""
    from kirag_tpu_torch.kernels import launch_counts, reset_launch_counts
    from kirag_tpu_torch.models.llm import _quantize_kernel_nf4, greedy_decode, load_llama

    cfg = dataclasses.replace(config, num_hidden_layers=2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    h, i, kv = cfg.hidden_size, cfg.intermediate_size, cfg.num_key_value_heads * cfg.head_dim
    rand = lambda *shape: (torch.randn(*shape, generator=gen, device=dev) * 0.02  # noqa: E731
                           ).to(torch.bfloat16)
    shapes = {"self_attn.q_proj": (h, h), "self_attn.k_proj": (kv, h),
              "self_attn.v_proj": (kv, h), "self_attn.o_proj": (h, h),
              "mlp.gate_proj": (i, h), "mlp.up_proj": (i, h), "mlp.down_proj": (h, i)}
    tensors = {"model.embed_tokens.weight": rand(cfg.vocab_size, h),
               "model.norm.weight": torch.ones(h, dtype=torch.bfloat16, device=dev),
               "lm_head.weight": rand(cfg.vocab_size, h)}
    for layer in range(2):
        pre = f"model.layers.{layer}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"{pre}.{norm}.weight"] = torch.ones(h, dtype=torch.bfloat16, device=dev)
        for name, shape in shapes.items():
            tensors[f"{pre}.{name}.weight"] = rand(*shape)
    ckpt = work / "llama3-8b-width-2-layers"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": cfg.vocab_size, "hidden_size": h,
        "num_hidden_layers": 2, "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads, "intermediate_size": i,
        "max_position_embeddings": 8192, "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
        "tie_word_embeddings": False, "hidden_act": "silu"}))
    t0 = time.perf_counter()
    write_safetensors(ckpt / "model.safetensors", tensors)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, loaded_cfg = load_llama(str(ckpt), compute_dtype=torch.bfloat16, quant_bits=4)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if loaded_cfg != dataclasses.replace(cfg, int4_impl="kernel"):
        raise AssertionError(f"load_llama read the config as {loaded_cfg}")
    checks = [(params["lm_head"], tensors["lm_head.weight"])]
    for layer in range(2):
        for name in shapes:
            checks.append((params["layers"][layer][name.split(".")[1]],
                           tensors[f"model.layers.{layer}.{name}.weight"]))
    for got, weight in checks:
        want = _quantize_kernel_nf4(weight.float().T)
        for key in ("kernel_q4", "kernel_scale4", "kernel_cb4"):
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"load_llama: {key} differs from quantizing the tensor")
    if not torch.equal(params["embed_tokens"], tensors["model.embed_tokens.weight"]):
        raise AssertionError("load_llama: embed_tokens differs from the written tensor")
    ids, mask = left_padded_prompts((60, 30, 45, 12), cfg.vocab_size, SEED + 3)
    reset_launch_counts()
    out, logits = greedy_decode(params, ids, mask, loaded_cfg, 8, torch.bfloat16)
    launched = launch_counts()["int4_matmul"]
    if not (torch.isfinite(logits).all() and launched == 7 * (2 * 7 + 1)):
        raise AssertionError(f"2-layer model: {launched} K6 launches, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    size = os.path.getsize(ckpt / "model.safetensors")
    shutil.rmtree(ckpt)
    log(f"  load_llama: a seeded {size / 1e9:.2f} GB bf16 safetensors checkpoint at "
        f"Llama-3-8B width, 2 layers (written in {write_s:.1f} s), read and quantized to "
        f"NF4 on the card in {load_s:.1f} s; {len(checks)} kernels byte-equal to quantizing "
        f"the written tensors, embeddings equal; 8 tokens through K6 ({launched} launches), "
        "logits finite")
    return {"load_s": load_s, "launches": launched}


K6_KERNEL = "qmm_kernel"  # K6's one kernel (csrc/int4_matmul.cu), one launch a call


def profile_decode(backend, ids, mask, steps: int, per_step: int, power) -> dict:
    """Device time of ``steps`` decode steps by kernel (torch.profiler): K6,
    the rest, and the share of the wall time the card is busy; K6 must have
    launched ``per_step`` kernels a step, one a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, _, state = backend.greedy_start(ids, mask, steps + 1, return_logits=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profile_lead_in()
        t0 = time.perf_counter()
        backend.greedy_resume(state, steps, return_logits=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split, _ = kernel_times(prof, [("K6", (K6_KERNEL,))])
    busy = sum(split.values()) / 1e6
    if busy <= 0:
        log("  profiler: no device time for the decode steps (not measured)")
        return {"busy_ms": None}
    k6_kernels = sum(1 for e in prof.events()
                     if e.device_type == DeviceType.CUDA and K6_KERNEL in e.name)
    if k6_kernels != per_step * steps:
        raise AssertionError(f"the profiler saw {k6_kernels} K6 kernels in {steps} decode "
                             f"steps, not {per_step} a step")
    log(f"  [{power}] {steps} decode steps, {LLM_ROWS} rows, device time by kernel "
        f"(torch.profiler): {busy * 1e3 / steps:.3f} ms per step of "
        f"{wall * 1e3 / steps:.3f} ms wall (profiled): busy {100 * busy / wall:.1f}%, idle "
        f"{100 * (1 - busy / wall):.1f}%; " + ", ".join(
            f"{k} {v / 1e3 / steps:.3f} ms ({100 * v / 1e6 / busy:.1f}%)"
            for k, v in split.items()) + f"; K6 {k6_kernels // steps} kernels a step")
    return {"busy_ms": busy * 1e3 / steps, "k6_share": split["K6"] / 1e6 / busy}


def llm_decode(work: Path, dev, power) -> dict:
    """Phase 8, the LLM at Llama-3-8B-Instruct geometry (LlamaConfig()),
    seeded, NF4 weights quantized on the card: greedy decode of 4 left-padded
    prompts through TorchLlamaBackend with K6, held against the same run
    with K6's plain version, start + resume against greedy, K6 launches per
    step, prefill and decode times, and load_llama at full width."""
    from kirag_tpu_torch.kernels import int4_matmul_plain, launch_counts, reset_launch_counts
    from kirag_tpu_torch.models import llm

    config = dataclasses.replace(llm.LlamaConfig(), int4_impl="kernel")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llm.init_llama_params(config, seed=SEED, device=dev, dtype=torch.bfloat16,
                                   quant_bits=4)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    quantized = sum(llm.param_bytes(p) for layer in params["layers"]
                    for p in layer.values()) + llm.param_bytes(params["lm_head"])
    log(f"  Llama-3-8B geometry ({config.num_hidden_layers} layers x {config.hidden_size}, "
        f"{config.num_attention_heads} heads / {config.num_key_value_heads} KV, MLP "
        f"{config.intermediate_size}, vocab {config.vocab_size}), NF4 built on the card in "
        f"{init_s:.1f} s: {llm.param_bytes(params) / 1e9:.3f} GB of parameters resident "
        f"({quantized / 1e9:.3f} GB packed projections + scales, embeddings "
        f"{llm.param_bytes(params['embed_tokens']) / 1e9:.3f} GB bf16); "
        f"torch.cuda.memory_allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB while building")
    backend = llm.TorchLlamaBackend(params, config, eos_token_id=EOS_ID)
    ids, mask = left_padded_prompts(LLM_PROMPTS, config.vocab_size, SEED)
    per_step = 7 * config.num_hidden_layers + 1
    steps = LLM_NEW_TOKENS - 1

    reset_launch_counts()
    got_ids, got_logits = backend.greedy(ids, mask, LLM_NEW_TOKENS)
    k6_run = launch_counts()["int4_matmul"]
    kernel_fn = llm.int4_matmul
    llm.int4_matmul = int4_matmul_plain  # _dense's K6 call -> the plain version
    try:
        plain_ids, plain_logits = backend.greedy(ids, mask, LLM_NEW_TOKENS)
    finally:
        llm.int4_matmul = kernel_fn
    if k6_run != per_step * steps:
        raise AssertionError(f"{k6_run} K6 launches for {steps} decode steps, not "
                             f"{per_step} per step")
    # the same two runs at f32 compute (K6 on f32 rows), one decode step
    f32 = {}
    for label, fn in (("K6", kernel_fn), ("plain", int4_matmul_plain)):
        llm.int4_matmul = fn
        try:
            f32[label] = llm.greedy_decode(params, ids, mask, config, 2, torch.float32)[1][:, 1]
        finally:
            llm.int4_matmul = kernel_fn
    f32_err = float((f32["K6"] - f32["plain"]).abs().max())
    f32_tol = LOGIT_TOL_F32 * float(f32["plain"].abs().max())
    if not f32_err <= f32_tol:
        raise AssertionError(f"f32 compute, first decode step: K6 logits differ from plain "
                             f"by {f32_err} > {f32_tol}")
    del f32
    # token 0 and its logits come from the prefill (the parity path, no K6):
    # the same in both runs; the first decode step's logits within LOGIT_TOL
    # of the plain run's; ids equal up to the first step whose plain top-2
    # margin is under that tolerance
    tol = LOGIT_TOL * float(np.abs(plain_logits[:, 1]).max())
    if not (np.array_equal(got_logits[:, 0], plain_logits[:, 0])
            and np.isfinite(got_logits).all()):
        raise AssertionError("prefill logits differ between the two runs, or are not finite")
    step1_err = float(np.abs(got_logits[:, 1] - plain_logits[:, 1]).max())
    if not step1_err <= tol:
        raise AssertionError(f"first decode step: K6 logits differ from plain by "
                             f"{step1_err} > {tol}")
    agree = near_tie_agreement(got_ids, plain_ids, plain_logits, tol, "K6 against plain")
    log(f"  greedy {LLM_NEW_TOKENS} tokens, {LLM_ROWS} rows of {list(LLM_PROMPTS)} prompt "
        f"tokens (bucket {backend._bucket(max(LLM_PROMPTS))}): {k6_run} K6 launches = "
        f"{per_step} x {steps} decode steps; first decode step's logits within "
        f"{step1_err:.3g} of the plain-K6 run (tolerance {tol:.3g} = {LOGIT_TOL} x max "
        f"|logit|; at f32 compute {f32_err:.3g}, tolerance {f32_tol:.3g} = {LOGIT_TOL_F32} "
        f"x max |logit|); ids equal to it for {agree} tokens per row (each up to its first "
        f"near-tie at least)")

    reset_launch_counts()
    first, _, state = backend.greedy_start(ids, mask, LLM_NEW_TOKENS, return_logits=False)
    parts = [first]
    for n in (steps // 3, steps // 3, steps - 2 * (steps // 3)):
        part, _, state = backend.greedy_resume(state, n, return_logits=False)
        parts.append(part)
    k6_resume = launch_counts()["int4_matmul"]
    if not (np.array_equal(np.concatenate(parts, axis=1), got_ids)
            and k6_resume == per_step * steps):
        raise AssertionError(f"greedy_start + greedy_resume differ from greedy, or "
                             f"{k6_resume} K6 launches")
    log(f"  greedy_start + 3 x greedy_resume ({steps} steps) == greedy: ids equal, "
        f"{k6_resume} K6 launches")

    # times: prefill per bucket (full rows, no K6), decode steps at 4 rows
    prefill = {}
    for t in PREFILL_BUCKETS:
        b_ids, b_mask = left_padded_prompts((t,) * LLM_ROWS, config.vocab_size, SEED + t)
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            backend.greedy(b_ids, b_mask, 1, return_logits=False)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        prefill[t] = statistics.median(secs)
    reset_launch_counts()
    _, _, state = backend.greedy_start(ids, mask, LLM_NEW_TOKENS, return_logits=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    backend.greedy_resume(state, steps, return_logits=False)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    k6_timed = launch_counts()["int4_matmul"]
    t_cache = backend._bucket(max(LLM_PROMPTS)) + LLM_NEW_TOKENS
    kv_bytes = (2 * config.num_hidden_layers * LLM_ROWS * t_cache * config.num_key_value_heads
                * config.head_dim * 2)
    step_bound = (quantized + kv_bytes) / HBM_BYTES_S
    log(f"  [{power}] prefill, {LLM_ROWS} rows (host clock to synchronize, median of 3): "
        + ", ".join(f"{t} tokens {s * 1e3:.1f} ms" for t, s in prefill.items()))
    log(f"  [{power}] decode, {LLM_ROWS} rows at a {t_cache}-slot cache: {step_s * 1e3:.3f} "
        f"ms per step, {LLM_ROWS / step_s:.1f} tokens/s (host clock over {steps} steps); "
        f"bound {step_bound * 1e3:.3f} ms (weights {quantized / 1e9:.3f} GB + KV "
        f"{kv_bytes / 1e9:.3f} GB at 3.35 TB/s)")
    profiled = profile_decode(backend, ids, mask, 8, per_step, power)
    if profiled["busy_ms"] is not None:
        idle = 1 - profiled["busy_ms"] / (step_s * 1e3)
        log(f"  [{power}] the card is busy {profiled['busy_ms']:.3f} ms of an unprofiled "
            f"{step_s * 1e3:.3f} ms step: idle {100 * idle:.1f}%")
    loaded = check_load_llama(work, dev, config, power)
    return {"params": params, "config": config, "launches": k6_run + k6_resume + k6_timed,
            "ids": got_ids, "logits": got_logits,
            "step_ms": step_s * 1e3, "step_bound_ms": step_bound * 1e3, "prefill": prefill,
            "init_s": init_s, "profile": profiled, "load": loaded}


# ----------------------------------------------------------------- phase 9

# questions per run, cut from 4 and 2, and the LLM's depth, cut from 32
# layers to 4 (phase 8 runs all 32), to keep the smoke near half its time
# limit: each question's 10 passages cost 3 KG batches of 512 decode steps,
# and a decode step's time is the host's, layer by layer
KIRAG_QUESTIONS = 1   # run A, the reference-shaped sequential loop
KIRAG_CACHED = 1      # run B, over a seeded KG cache
KIRAG_LAYERS = 4
# turns a question, cut from 2 when phase 17 came: a second turn's new
# documents cost a KG decode of 512 steps a batch in every run. The cached
# runs (B, E, F, G and phase 16's selector) read a cache that lacks KIRAG_HELD
# of the question's documents, so that their KG step, and K3 in its
# examplar ranking, still runs (a batch of 512 steps)
KIRAG_TURNS = 1
KIRAG_HELD = 2


class ByteLevelTokenizer:
    """Stand-in for Llama-3's tokenizer (its vocabulary file is not in the
    repository): ids 0-255 are UTF-8 bytes, the chat template's special
    tokens have Llama-3's ids, and every other id decodes to one fixed word
    of WORDS. Text round-trips, so stop words and the triple parser see real
    text. Callable as the Generator calls a HuggingFace tokenizer."""

    SPECIAL = {"<|begin_of_text|>": 128000, "<|end_of_text|>": 128001,
               "<|start_header_id|>": 128006, "<|end_header_id|>": 128007,
               "<|eot_id|>": 128009}
    eos_token_id = pad_token_id = EOS_ID
    bos_token_id = 128000
    _split = re.compile("(" + "|".join(re.escape(s) for s in SPECIAL) + ")")

    def __init__(self):
        self.padding_side, self.truncation_side = "left", "left"
        self.names = {v: k for k, v in self.SPECIAL.items()}

    def encode(self, text: str, add_special_tokens: bool = True):
        ids = [self.bos_token_id] if add_special_tokens else []
        for piece in self._split.split(text):
            ids.extend([self.SPECIAL[piece]] if piece in self.SPECIAL else piece.encode())
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out, run = [], bytearray()
        for i in (int(i) for i in ids):
            if i < 256:
                run.append(i)
                continue
            out.append(run.decode(errors="replace"))
            run = bytearray()
            if i in self.names:
                out.append("" if skip_special_tokens else self.names[i])
            else:
                out.append(" " + WORDS[i % len(WORDS)])
        out.append(run.decode(errors="replace"))
        return "".join(out)

    def batch_decode(self, rows, skip_special_tokens: bool = False):
        return [self.decode(r, skip_special_tokens) for r in rows]

    def __call__(self, text, max_length=None, padding=False, truncation=False,
                 return_tensors=None, add_special_tokens=True):
        if isinstance(text, str):
            return {"input_ids": self.encode(text, add_special_tokens)}
        rows = [self.encode(t, add_special_tokens) for t in text]
        if truncation and max_length:
            rows = [r[-max_length:] if self.truncation_side == "left" else r[:max_length]
                    for r in rows]
        width = max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            cols = slice(width - len(r), width) if self.padding_side == "left" else slice(0, len(r))
            ids[i, cols], mask[i, cols] = r, 1
        return {"input_ids": ids, "attention_mask": mask}


class StageTimer:
    """Host seconds spent in named calls, each of which ends with its results
    on the host (numpy or text), so the device work is inside the span."""

    def __init__(self):
        self.seconds = {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        return timed


class TimedRetriever:
    """The KiRAG loop's retriever, its searches timed as "retrieve"."""

    def __init__(self, retriever, timer: StageTimer):
        self.retriever = retriever
        self._call = timer.wrap("retrieve", retriever.__call__)

    def __call__(self, *args, **kwargs):
        return self._call(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.retriever, name)


def phase9_llm(decoded: dict) -> tuple:
    """The first KIRAG_LAYERS layers of phase 8's NF4 Llama, as a loaded
    ``(params, config)`` pair."""
    return ({**decoded["params"], "layers": decoded["params"]["layers"][:KIRAG_LAYERS]},
            dataclasses.replace(decoded["config"], num_hidden_layers=KIRAG_LAYERS))


def retrieve_run(work: Path, built: dict, llm, run: str, n_q: int, cache: Path, power,
                 extra=(), draft_llm=None) -> dict:
    """One run of kirag_tpu_torch.cli.retrieve.main over phase 6's index and
    encoder (retriever and Aligner) with ``llm`` (and ``draft_llm``) handed
    in, its stages timed; held to phase 9's checks: ``ctxs`` and ``paths``
    for every question, every id in the index, and K1, K2, K3 and K6
    launched. The result holds the constructor's backend."""
    import pickle

    from kirag_tpu_torch.cli import retrieve as retrieve_cli
    from kirag_tpu_torch.kernels import reset_launch_counts

    with open(Path(built["index_dir"]) / "index_meta.pkl", "rb") as f:
        index_ids = set(pickle.load(f))
    setup = retrieve_cli.setup_kirag_model
    timer = StageTimer()
    built_kirag = []

    def instrumented(*args, **kwargs):
        kirag = setup(*args, **kwargs)
        built_kirag.append(kirag)
        kirag.retriever = TimedRetriever(kirag.retriever, timer)
        kg_llm = kirag.kg_generator.generator
        kg_llm.generate_texts = timer.wrap("KG decode", kg_llm.generate_texts)
        kirag.filter_candidate_triples = timer.wrap("Aligner rescoring",
                                                    kirag.filter_candidate_triples)
        kirag._decode_constructor = timer.wrap("constructor decode", kirag._decode_constructor)
        return kirag

    argv = [*kirag_argv(work, built, cache), "--num_queries", str(n_q), "--save_dir", str(work),
            "--name", f"kirag_{run}", "--save_file", "results.json", *extra]
    retrieve_cli.setup_kirag_model = instrumented
    reset_launch_counts()
    try:
        t0 = time.perf_counter()
        path = retrieve_cli.main(argv, tokenizer=HashTokenizer(),
                                 llm_tokenizer=ByteLevelTokenizer(),
                                 aligner_tokenizer=HashTokenizer(), llm=llm,
                                 draft_llm=draft_llm)
        wall = time.perf_counter() - t0
    finally:
        retrieve_cli.setup_kirag_model = setup
    counts = main_path_counts()
    results = json.loads(Path(path).read_text())
    if len(results) != n_q or not all(
            r["ctxs"] and "paths" in r and all(c["id"] in index_ids for c in r["ctxs"])
            for r in results):
        raise AssertionError(f"run {run}: results lack ctxs or paths, or hold ids "
                             "outside the index")
    idle = [k for k in ("stream_capture", "gather_groups", "flash_attention", "int4_matmul")
            if counts[k] == 0]
    if idle:
        raise AssertionError(f"run {run}: kernels of the path were not launched: {idle}")
    stages = dict(timer.seconds)
    stages["rest (load, examplar ranking, host)"] = wall - sum(stages.values())
    n_triples = sum(len(p) for r in results for p in r["paths"] if p and p[0])
    log(f"  run {run}: {n_q} questions, {len(results[0]['ctxs'])} ctxs for the first, "
        f"every ctxs id in the index; {n_triples} chain steps parsed; launches {counts}")
    log(f"  [{power}] run {run}: {wall:.2f} s, {3600 * n_q / wall:.2f} questions/hour; "
        + ", ".join(f"{k} {v:.2f} s ({100 * v / wall:.1f}%)" for k, v in stages.items()))
    return {"wall": wall, "stages": stages, "launches": counts, "path": path,
            "backend": built_kirag[0].constructor.backend}


def kirag_argv(work: Path, built: dict, cache: Path) -> list:
    """cli/retrieve's arguments over phase 6's TSV, index and E5 npz (the
    retriever and the Aligner) and the smoke's questions."""
    return ["--dataset", "hotpotqa", "--query_file", str(work / "questions.json"),
            "--corpus", "wikipedia", "--corpus_path", str(built["tsv"]), "--index_folder",
            str(built["index_dir"]), "--embedding_size", str(DIM),
            "--retriever_model_name_or_path", str(built["model_dir"]), "--llm",
            "Meta-Llama-3-8B-Instruct", "--llm_quant_bits", "4", "--aligner_model", "e5",
            "--aligner_model_name_or_path", str(built["model_dir"]), "--num_turns",
            str(KIRAG_TURNS), "--topk", "10", "--num_beams", "1", "--concurrent_questions", "1",
            "--cached_kg_triples_file", str(cache)]


def seed_triple(doc: dict) -> dict:
    """One triple from the passage's own words, ``<title; first; last>``,
    in place of what a trained KG LLM would extract (a random one extracts
    none)."""
    words = re.findall(r"\w+", doc.get("text") or " ".join(doc["sentences"]))
    doc["triples"] = [{"text": f"<{doc['title']}; {words[0]}; {words[-1]}>", "sentence": 0}]
    return doc


def kirag_cli(work: Path, built: dict, decoded: dict, power) -> dict:
    """Phase 9, KiRAG through kirag_tpu_torch.cli.retrieve.main: phase 6's
    DPR TSV, index and E5 npz (as retriever and Aligner), the first
    KIRAG_LAYERS layers of phase 8's NF4 Llama handed in, questions of
    tests/fixtures_realtext.py. Run A: the
    reference-shaped sequential loop, the KG cache starting empty. Run B:
    the same CLI over a KG cache of run A's documents seeded with one triple
    each from the passage's own words (the random LLM extracts none), so the
    Aligner rescoring and the constructor run too; the cache lacks the
    first KIRAG_HELD of run A's documents (``kg_held_out.json``), which run
    B's KG step extracts, and so does every later copy of it."""
    import pickle

    fixtures = runpy.run_path(str(Path(__file__).resolve().parent / "tests"
                                  / "fixtures_realtext.py"))
    questions = [{"id": f"q{i}", "question": r["question"], "answers": [r["gold"]]}
                 for i, r in enumerate(fixtures["REALTEXT_QA"][:KIRAG_QUESTIONS])]
    (work / "questions.json").write_text(json.dumps(questions))
    cache = work / "kg_cache.pkl"
    llm = phase9_llm(decoded)
    runs = {}
    for run, n_q in (("A", KIRAG_QUESTIONS), ("B", KIRAG_CACHED)):
        runs[run] = retrieve_run(work, built, llm, run, n_q, cache, power)
        if run == "A":  # seed the cache: one triple per cached passage, its own words
            ctxs = json.loads(Path(runs[run]["path"]).read_text())[0]["ctxs"]
            held = [c["id"] for c in ctxs[:KIRAG_HELD]]
            (work / "kg_held_out.json").write_text(json.dumps(held))
        with open(cache, "rb") as f:
            cached = pickle.load(f)
        for doc_id in held:  # run B extracted them and wrote them back
            cached.pop(doc_id, None)
        if run == "A":
            for doc in cached.values():
                seed_triple(doc)
        with open(cache, "wb") as f:
            pickle.dump(cached, f)
    if not (runs["B"]["stages"].get("Aligner rescoring") and
            runs["B"]["stages"].get("constructor decode")):
        raise AssertionError("run B did not reach the Aligner and the constructor")
    return runs


# ---------------------------------------------------------------- phase 16

KG_CORPUS_DOCS = 8   # (a): documents 0-7 of phase 6's TSV, 2 batches of 4
KV_STEPS = 16        # (b): decode steps held int8 against the bf16 cache
KV_TIMED_STEPS = 64  # (b): decode steps a timed run, two runs with each cache
QA_K = 3             # (c): contexts a question
SELECTOR_BEAMS = 2   # (d)


def kv_cache_bytes(state: dict) -> int:
    return sum(nbytes(*(c.values() if isinstance(c, dict) else (c,)))
               for c in state["k"] + state["v"])


def kg_corpus(work: Path, built: dict, llm, power) -> dict:
    """Phase 16 (a): ``cli/construct_kg_corpus`` over documents 0-7 of phase
    6's TSV with the 4-layer NF4 Llama handed in; the cache read back by the
    port's KGGenerator holds those 8 ids; K6 launched."""
    import types

    from kirag_tpu_torch.cli import construct_kg_corpus
    from kirag_tpu_torch.data import CORPUS_MAP
    from kirag_tpu_torch.kernels import reset_launch_counts
    from kirag_tpu_torch.kg import KGGenerator

    cache = work / "kg_corpus.pkl"
    argv = ["--corpus", "wikipedia", "--corpus_path", str(built["tsv"]), "--dataset",
            "hotpotqa", "--llm", "Meta-Llama-3-8B-Instruct", "--cached_kg_triples_file",
            str(cache), "--batch_size", "4", "--save_every", "1", "--start", "0", "--end",
            str(KG_CORPUS_DOCS)]
    reset_launch_counts()
    t0 = time.perf_counter()
    path = construct_kg_corpus.main(argv, llm_tokenizer=ByteLevelTokenizer(), llm=llm)
    wall = time.perf_counter() - t0
    counts = main_path_counts()
    reader = KGGenerator(types.SimpleNamespace(tokenizer=ByteLevelTokenizer()))
    reader.load_cached_kg_triples(path)
    corpus = CORPUS_MAP["wikipedia"](corpus_path=str(built["tsv"]))
    want = [corpus.data[i]["id"] for i in range(KG_CORPUS_DOCS)]
    if sorted(reader.cached_kg_triples) != sorted(want) or counts["int4_matmul"] == 0:
        raise AssertionError(f"construct_kg_corpus: cached ids {sorted(reader.cached_kg_triples)}"
                             f" (want {sorted(want)}), {counts['int4_matmul']} K6 launches")
    n_triples = sum(len(d.get("triples", [])) for d in reader.cached_kg_triples.values())
    log(f"  (a) construct_kg_corpus, documents 0-{KG_CORPUS_DOCS - 1}, batch 4, saved every "
        f"batch: the cache read back holds those {KG_CORPUS_DOCS} ids ({n_triples} triples "
        f"parsed); {counts['int4_matmul']} K6 launches")
    log(f"  [{power}] (a) {wall:.2f} s, {wall / KG_CORPUS_DOCS:.2f} s a document "
        f"({KIRAG_LAYERS} of 32 layers, 512 new tokens a batch)")
    return {"wall": wall, "launches": counts}


def near_tie_agreement(got_ids, ref_ids, ref_logits, tol: float, what: str,
                       through_tie: bool = True) -> list:
    """Ids equal to the reference run's up to each row's first step whose
    top-2 margin is under ``tol``, that step included (``through_tie=False``:
    excluded, where the two runs' logits may differ by up to ``tol`` from
    the first token on); returns the tokens each row agrees for."""
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    margins = top2[..., 1] - top2[..., 0]
    agree = []
    for row in range(len(ref_ids)):
        close = np.nonzero(margins[row] < tol)[0]
        upto = int(close[0]) + through_tie if len(close) else ref_ids.shape[1]
        if not np.array_equal(got_ids[row, :upto], ref_ids[row, :upto]):
            raise AssertionError(f"{what}, row {row}: ids differ before the first near-tie "
                                 f"(step {upto})")
        same = got_ids[row] == ref_ids[row]
        agree.append(int(np.argmin(same)) if not same.all() else ref_ids.shape[1])
    return agree


def int8_kv(llm, power) -> dict:
    """Phase 16 (b), the int8 KV cache on the 4-layer NF4 model with phase 8's
    prompts: ``_kv_quantize`` on the card bitwise the CPU's on the model's
    keys and values; 16 decode steps with kv_quant_bits=8 held against the
    bf16 cache (the prefill's and the first step's logits within LOGIT_TOL,
    ids equal up to each row's first near-tie); both caches' bytes and
    decode ms a step."""
    from kirag_tpu_torch.kernels import launch_counts, reset_launch_counts
    from kirag_tpu_torch.models import llm as llm_mod

    params, config = llm
    ids, mask = left_padded_prompts(LLM_PROMPTS, config.vocab_size, SEED)
    _, _, state = llm_mod.prefill_decode(params, ids, mask, config, 1, torch.bfloat16, EOS_ID)
    values = 0
    for cache in state["k"] + state["v"]:
        q, scale = llm_mod._kv_quantize(cache)
        q_cpu, scale_cpu = llm_mod._kv_quantize(cache.cpu())
        if not (torch.equal(q.cpu(), q_cpu) and torch.equal(scale.cpu(), scale_cpu)):
            raise AssertionError("_kv_quantize on the card differs from the CPU's")
        values += cache.numel()
    del state
    log(f"  (b) _kv_quantize on the card bitwise the CPU's: codes and scales of {values:,} "
        f"bf16 keys and values ({KIRAG_LAYERS} layers, {LLM_ROWS} rows of {list(LLM_PROMPTS)} "
        "prompt tokens)")
    runs, backends = {}, {}
    for label, bits in (("bf16", None), ("int8", 8)):
        backend = backends[label] = llm_mod.TorchLlamaBackend(
            params, dataclasses.replace(config, kv_quant_bits=bits), eos_token_id=EOS_ID)
        reset_launch_counts()
        got_ids, logits = backend.greedy(ids, mask, KV_STEPS + 1)
        runs[label] = {"ids": got_ids, "logits": logits, "k6": launch_counts()["int4_matmul"],
                       "step_ms": []}
    for label in ("bf16", "int8", "int8", "bf16"):  # decode timed in turns
        _, _, st = backends[label].greedy_start(ids, mask, KV_TIMED_STEPS + 1,
                                                return_logits=False)
        runs[label]["bytes"] = kv_cache_bytes(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backends[label].greedy_resume(st, KV_TIMED_STEPS, return_logits=False)
        torch.cuda.synchronize()
        runs[label]["step_ms"].append((time.perf_counter() - t0) * 1e3 / KV_TIMED_STEPS)
        del st
    ref, got = runs["bf16"], runs["int8"]
    per_step = 7 * KIRAG_LAYERS + 1
    if not (got["k6"] == ref["k6"] == per_step * KV_STEPS and np.isfinite(got["logits"]).all()):
        raise AssertionError(f"int8 cache: K6 launches {got['k6']} / {ref['k6']} (want "
                             f"{per_step * KV_STEPS}), or logits not finite")
    # the prefill stores the cache but attends the prompt's own K/V unquantized;
    # its products' sums run in f32 where the bf16 cache's run in a bf16 GEMM
    tol = LOGIT_TOL * float(np.abs(ref["logits"][:, 1]).max())
    prefill_gap, step1_gap = (float(np.abs(got["logits"][:, i] - ref["logits"][:, i]).max())
                              for i in (0, 1))
    if not (prefill_gap <= tol and step1_gap <= tol):
        raise AssertionError(f"int8 cache: prefill / first decode step's logits {prefill_gap} / "
                             f"{step1_gap} from the bf16 cache's > {tol}")
    agree = near_tie_agreement(got["ids"], ref["ids"], ref["logits"], tol, "int8 cache")
    upto = min(agree)
    gap = float(np.abs(got["logits"][:, 1:upto] - ref["logits"][:, 1:upto]).max()) if upto > 1 \
        else step1_gap
    log(f"  (b) {KV_STEPS} decode steps, int8 cache against bf16: prefill logits within "
        f"{prefill_gap:.4g}, first step's within {step1_gap:.4g} (tolerance {tol:.4g} = "
        f"{LOGIT_TOL} x max |logit|), "
        f"largest gap while every row agrees {gap:.4g}; ids equal for {agree} tokens a row (each "
        f"up to its first near-tie at least); {got['k6']} K6 launches each way")
    slots = KV_TIMED_STEPS + 1 + backends["bf16"]._bucket(max(LLM_PROMPTS))
    log(f"  [{power}] (b) KV cache at {LLM_ROWS} rows x {slots} slots, {KIRAG_LAYERS} layers: "
        f"bf16 {ref['bytes'] / 1e6:.1f} MB, int8 {got['bytes'] / 1e6:.1f} MB "
        f"({got['bytes'] / ref['bytes']:.3f}x); decode ms a step with the bf16 cache "
        f"{' / '.join(f'{t:.3f}' for t in ref['step_ms'])}, with int8 "
        f"{' / '.join(f'{t:.3f}' for t in got['step_ms'])} (host clock over {KV_TIMED_STEPS} "
        "steps a run, run in turns bf16, int8, int8, bf16)")
    return {"step_ms": {k: v["step_ms"] for k, v in runs.items()},
            "bytes": {k: v["bytes"] for k, v in runs.items()}, "step1_gap": step1_gap,
            "agree": agree}


def int8_retrieve(work: Path, built: dict, llm, cache: Path, power) -> dict:
    """Phase 16 (b), run E: cli/retrieve with --llm_kv_quant_bits 8 over a
    copy of run B's KG cache, held to phase 9's checks; the int8 cache
    written (``_kv_quantize`` called)."""
    from kirag_tpu_torch.models import llm as llm_mod

    cache_e = work / "kg_cache_E.pkl"
    shutil.copyfile(cache, cache_e)
    quantize, calls = llm_mod._kv_quantize, []
    llm_mod._kv_quantize = lambda x: calls.append(1) or quantize(x)
    try:
        run = retrieve_run(work, built, llm, "E", KIRAG_CACHED, cache_e, power,
                           extra=("--llm_kv_quant_bits", "8"))
    finally:
        llm_mod._kv_quantize = quantize
    if not calls:
        raise AssertionError("run E: the int8 KV cache was never written")
    log(f"  run E wrote the int8 cache {len(calls)} times (prefills and decode steps x layers "
        "x K/V)")
    return run


def qa_eval_run(run_e: dict, llm, power) -> dict:
    """Phase 16 (c): cli/qa_eval over run E's results at --k 3 with the 4-layer
    NF4 reader; a prediction for every question, EM and F1 printed; the
    reader's ids through K6 equal to those through int4_impl="parity" up to
    each row's first near-tie; K6 launched."""
    import io

    from kirag_tpu_torch.cli import qa_eval
    from kirag_tpu_torch.evaluation import ems, f1_score
    from kirag_tpu_torch.kernels import reset_launch_counts

    argv = ["--save_file", run_e["path"], "--reader", "Meta-Llama-3-8B-Instruct", "--k",
            str(QA_K)]
    reset_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        em, f1 = qa_eval.main(argv, llm_tokenizer=ByteLevelTokenizer(), llm=llm)
    wall = time.perf_counter() - t0
    counts = main_path_counts()
    report = out.getvalue()
    for line in report.splitlines():
        log("  " + line)
    if not (">>>> EM: " in report and ">>>> F1: " in report and counts["int4_matmul"] > 0):
        raise AssertionError(f"qa_eval: no EM/F1 in its report, or {counts['int4_matmul']} K6 "
                             "launches")
    args = qa_eval.setup_parser(argv)
    data = json.loads(Path(run_e["path"]).read_text())
    readers = {impl: qa_eval.build_reader(args, ByteLevelTokenizer(), (
        llm[0], dataclasses.replace(llm[1], int4_impl=impl))) for impl in ("kernel", "parity")}
    questions = [ex["question"] for ex in data]
    contexts = []
    for ex in data:  # as qa_eval.evaluate builds them
        texts = [(c, c.get("text") or " ".join(c.get("sentences", []))) for c in ex["ctxs"][:QA_K]]
        contexts.append(["title: {}, text: {}".format(c["title"], t) if "title" in c else t
                         for c, t in texts])
    gen = {}
    for impl, reader in readers.items():
        gen[impl] = reader.generator_generate(*reader.get_generator_inputs(questions, contexts))
    (k6_ids, _), (plain_ids, plain_logits) = gen["kernel"], gen["parity"]
    tol = LOGIT_TOL * float(np.abs(plain_logits).max())
    agree = near_tie_agreement(k6_ids, plain_ids, plain_logits, tol, "qa_eval reader")
    reader = readers["kernel"]
    preds = reader.parse_generated_answers(
        reader.tokenizer.batch_decode(k6_ids, skip_special_tokens=True))
    golds = [ex["answers"] if isinstance(ex["answers"], list) else [ex["answers"]]
             for ex in data]
    em_again = float(np.mean([float(ems(p, g)) for p, g in zip(preds, golds)]))
    f1_again = float(np.mean([f1_score(p, g[0])[0] for p, g in zip(preds, golds)]))
    if not (len(preds) == len(data) and all(isinstance(p, str) for p in preds)
            and (em_again, f1_again) == (em, f1)):
        raise AssertionError(f"qa_eval: {len(preds)} predictions for {len(data)} questions, or "
                             f"EM/F1 {em_again}/{f1_again} of the held run differ from "
                             f"{em}/{f1}")
    log(f"  (c) qa_eval over run E's {len(data)} questions at k={QA_K}: a prediction each "
        f"({preds!r}), EM {em:.5f} F1 {f1:.5f}; the reader's ids through K6 equal to "
        f"int4_impl='parity''s for {agree} of {k6_ids.shape[1]} tokens a row (each up to its "
        f"first near-tie at least, tolerance {tol:.4g}); {counts['int4_matmul']} K6 launches")
    log(f"  [{power}] (c) {wall:.2f} s")
    return {"wall": wall, "launches": counts, "em": em, "f1": f1}


def selector_run(work: Path, built: dict, llm, cache: Path, power) -> dict:
    """Phase 16 (d): TripleSelector.retrieve for one question, num_beams=2,
    over phase 6's retriever and Aligner and a copy of run B's KG cache, so
    that candidates exist and the option step runs; two of the question's
    first-turn documents are taken out of the loaded cache, so that the KG
    generator runs on them too (its examplar ranking encodes 256-token
    buckets through K3): chains returned; K1, K2, K3 and K6 launched; each
    generated row that holds an option token has option probabilities
    summing to 1 within 1e-6, every other row NaN, and one such row at least.
    Where no row of an option step holds a digit (the random model seldom
    emits one), its first row's first token is set to an option's, so that
    the probabilities over the card's logits and the beam's expansion run."""
    from kirag_tpu_torch.cli import retrieve as retrieve_cli
    from kirag_tpu_torch.kernels import reset_launch_counts
    from kirag_tpu_torch.pipeline import TripleSelector

    cache_d = work / "kg_cache_selector.pkl"
    shutil.copyfile(cache, cache_d)
    args = retrieve_cli.setup_parser([*kirag_argv(work, built, cache_d), "--save_file", "x"])
    retriever, _ = retrieve_cli.setup_retriever_model(args, HashTokenizer())
    kirag = retrieve_cli.setup_kirag_model(args, retriever, ByteLevelTokenizer(),
                                           HashTokenizer(), llm)
    selector = TripleSelector(
        retriever=kirag.retriever, kg_generator=kirag.kg_generator,
        constructor=kirag.constructor, aligner=kirag.aligner, examplar_type=args.dataset,
        num_turns=args.num_turns, topk=args.topk,
        num_candidate_triples=args.num_candidate_triples)
    probes = []
    option_probs = selector.get_option_tokens_probs

    def recorded(token_ids, token_logits, num_options):
        # the random model seldom emits a digit: where no row holds an option
        # token, the first row's first token is set to option "1" (or "0"),
        # so that the probabilities over the card's logits at that position
        # and the beam's expansion run
        option_map = selector.get_option_token_id_to_option_map(num_options)
        token_ids = np.array(token_ids)
        forced = not any(int(t) in option_map for t in token_ids.ravel())
        if forced:
            want = "1" if num_options > 1 else "0"
            token_ids[0, 0] = next(t for t, o in option_map.items() if o == want)
        options, probs = option_probs(token_ids, token_logits, num_options)
        probes.append((token_ids, option_map, probs, forced))
        return options, probs

    selector.get_option_tokens_probs = recorded
    question = json.loads((work / "questions.json").read_text())[0]["question"]
    first_turn = [d["id"] for d in retriever([question], topk=args.topk)[0]]
    for doc_id in first_turn[:2]:  # the cache may lack them already (KIRAG_HELD)
        selector.kg_generator.cached_kg_triples.pop(doc_id, None)
    reset_launch_counts()
    t0 = time.perf_counter()
    chains, doc_scores = selector.retrieve(question, num_beams=SELECTOR_BEAMS)
    wall = time.perf_counter() - t0
    counts = main_path_counts()
    idle = [k for k in ("stream_capture", "gather_groups", "flash_attention", "int4_matmul")
            if counts[k] == 0]
    if not chains or not doc_scores or not probes or idle:
        raise AssertionError(f"TripleSelector: {len(chains)} chains, {len(doc_scores)} "
                             f"documents, {len(probes)} option steps; kernels not launched: "
                             f"{idle}")
    rows = with_option = 0
    for token_ids, option_map, probs, _ in probes:
        for row, p in zip(token_ids, probs):
            rows += 1
            if any(int(t) in option_map for t in row):
                with_option += 1
                if not abs(float(p.astype(np.float64).sum()) - 1.0) <= 1e-6:
                    raise AssertionError(f"TripleSelector: option probabilities sum to {p.sum()}")
            elif not np.isnan(p).all():
                raise AssertionError("TripleSelector: a row without an option token is not NaN")
    if with_option == 0:
        raise AssertionError("TripleSelector: no row held an option token, so no option "
                             "probabilities were checked")
    extended = sum(1 for c in chains if c["triples"])
    log(f"  (d) TripleSelector.retrieve, num_beams={SELECTOR_BEAMS}: {len(chains)} chains "
        f"({extended} extended by a triple), {len(doc_scores)} documents scored; "
        f"{len(probes)} option steps ({sum(p[3] for p in probes)} with option \"1\" set in "
        f"the first row) over {rows} rows, {with_option} holding an option token "
        f"(probabilities summing to 1 within 1e-6), the rest NaN; launches {counts}")
    log(f"  [{power}] (d) {wall:.2f} s")
    return {"wall": wall, "launches": counts}


def eval_pipeline(work: Path, built: dict, decoded: dict, power) -> dict:
    """Phase 16: the evaluation pipeline around the KiRAG loop with the first
    KIRAG_LAYERS layers of phase 8's NF4 Llama: (a) construct_kg_corpus, (b)
    the int8 KV cache and run E, (c) qa_eval over run E, (d) the
    TripleSelector over run B's cache."""
    llm = phase9_llm(decoded)
    cache = work / "kg_cache.pkl"
    out = {"kg": kg_corpus(work, built, llm, power), "kv": int8_kv(llm, power)}
    out["E"] = int8_retrieve(work, built, llm, cache, power)
    out["qa"] = qa_eval_run(out["E"], llm, power)
    out["selector"] = selector_run(work, built, llm, cache, power)
    return out


# ---------------------------------------------------------------- phase 17

SPEC_GAMMA = 4        # the fed window a round: 3 proposals and the correction
SPEC_SEGMENT = 16     # (a): greedy_resume's steps a segment
SPEC_FLIP = 5         # (a): the script flips every 5th proposal to a wrong token
SPEC_ACCEPT_MAX = 0.8
PREFIX_GROUPS = 4     # (b): the pool's groups
PREFIX_TOKENS = 2048  # (b): its slots a group
PREFIX_SHARED = 1000  # (b): the prompt tokens the 4 rows share
PREFIX_TAILS = (400, 300, 200, 100)   # (b): each row's own tokens after them
PREFIX_STEPS = 16     # (b): tokens a call
DRAFT_LAYERS_F = 2    # (c): run F's draft, cut from 16 layers


def draft_llm_config():
    """Llama-3.2-1B's published geometry (meta-llama/Llama-3.2-1B,
    config.json): 16 layers x 2048, 32 heads / 8 KV, MLP 8192, vocab 128256,
    tied embeddings, rope_theta 500000; its rope_scaling ("llama3") is in
    neither package, so the draft runs plain RoPE."""
    from kirag_tpu_torch.models import llm

    return llm.LlamaConfig(vocab_size=128256, hidden_size=2048, num_hidden_layers=16,
                           num_attention_heads=32, num_key_value_heads=8, intermediate_size=8192,
                           rope_theta=500000.0, tie_word_embeddings=True,
                           max_position_embeddings=131072)


def acceptance(hist) -> float:
    """Accepted proposals over the proposals judged: a round judges its
    accepted ones and, unless it accepted all gamma - 1, the one rejected."""
    accepted = sum(a * int(n) for a, n in enumerate(hist))
    return accepted / max(1, accepted + int(sum(hist[:-1])))


def k6_row_invariance(params, config, dev) -> dict:
    """Is K6's output for a row the same bits in a 4-row call (a decode
    step) and in a 16-row call (a verify window of gamma 4)? The plan picks
    the tiles and the cluster, whose split of the sum fixes its order."""
    from kirag_tpu_torch.kernels import int4_matmul
    from kirag_tpu_torch.kernels.qmm import plan

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    layer, wide_rows = params["layers"][0], LLM_ROWS * SPEC_GAMMA
    out = {}
    for name, p in (("q_proj", layer["q_proj"]), ("k_proj", layer["k_proj"]),
                    ("gate_proj", layer["gate_proj"]), ("down_proj", layer["down_proj"]),
                    ("lm_head", params["lm_head"])):
        half, cols = p["kernel_q4"].shape
        cb = p.get("kernel_cb4")
        x = torch.randn(wide_rows, 2 * half, generator=gen, device=dev).to(torch.bfloat16)
        wide = int4_matmul(x, p["kernel_q4"], p["kernel_scale4"], codebook=cb)
        narrow = int4_matmul(x[:LLM_ROWS], p["kernel_q4"], p["kernel_scale4"], codebook=cb)
        diff = (wide[:LLM_ROWS].float() - narrow.float()).abs()
        out[name] = {"bitwise": torch.equal(wide[:LLM_ROWS], narrow), "outputs": narrow.numel(),
                     "differ": int((diff > 0).sum()), "max_diff": float(diff.max()),
                     "plans": (plan(LLM_ROWS, half, cols, cb is not None),
                               plan(wide_rows, half, cols, cb is not None))}
    log(f"  (a) K6 row-count invariance, NF4, bf16 rows: a row's output in a {LLM_ROWS}-row "
        f"call against the same row in a {wide_rows}-row call: " + "; ".join(
            f"{n} {'bitwise' if r['bitwise'] else 'NOT bitwise'} ({r['differ']} of "
            f"{r['outputs']} outputs differ, by up to {r['max_diff']:.3g}; "
            f"cluster {r['plans'][0].cluster} / {r['plans'][1].cluster}, tiles "
            f"{r['plans'][0].tiles} / {r['plans'][1].tiles})" for n, r in out.items()))
    return out


def spec_decode(decoded: dict, draft, power) -> dict:
    """Phase 17 (a): greedy speculative decoding at full width, phase 8's NF4
    Llama-3-8B target with the bf16 Llama-3.2-1B-geometry draft, phase 8's 4
    prompts, 64 tokens, gamma 4, through TorchLlamaBackend: the draft's own
    argmax; then a script of the target's stream with every 5th proposal
    flipped, through greedy_start + greedy_resume in segments of 16, greedy,
    and greedy with logits. Each script is the run before's ids: greedy as
    the verify forward computes it, which leaves phase 8's stream at bf16
    near-ties and shifts with the windows, so each run's script agrees with
    its stream further than the one before. Each
    run: ids equal to phase 8's greedy stream up to each row's first
    near-tie, K6 launched 225 times a verify round (and nowhere else), the
    acceptance histogram, ms per emitted token by the host clock beside
    phase 8's greedy step; the scripted runs' acceptance at most 0.8; with
    logits, the prefill's equal to phase 8's and the first step's within
    LOGIT_TOL. Then a draft with the int8 cache is refused."""
    from kirag_tpu_torch.kernels import reset_launch_counts
    from kirag_tpu_torch.models import llm as llm_mod
    from kirag_tpu_torch.models import speculative

    params, config = decoded["params"], decoded["config"]
    d_params, d_config = draft
    ids, mask = left_padded_prompts(LLM_PROMPTS, config.vocab_size, SEED)
    ref_ids, ref_logits = decoded["ids"], decoded["logits"]
    tol = LOGIT_TOL * float(np.abs(ref_logits[:, 1]).max())
    flip = np.arange(LLM_NEW_TOKENS)[None, :] % SPEC_FLIP == SPEC_FLIP - 1
    backend = llm_mod.TorchLlamaBackend(params, config, eos_token_id=EOS_ID,
                                        draft_params=d_params, draft_config=d_config,
                                        spec_gamma=SPEC_GAMMA)
    per_round = 7 * config.num_hidden_layers + 1
    steps = LLM_NEW_TOKENS - 1
    rounds, spec_round = [0], speculative._spec_round

    def counted(*args, **kwargs):
        rounds[0] += 1
        return spec_round(*args, **kwargs)

    runs, script = {}, None
    speculative._spec_round = counted
    try:
        for run in ("draft argmax", "segmented", "scripted", "logits"):
            backend.draft_script_fn = None if script is None else (lambda i, m: script)
            hist0 = backend.spec_acc_hist.copy()
            rounds[0] = 0
            reset_launch_counts()
            logits, start_s = None, None
            t0 = time.perf_counter()
            if run == "segmented":
                first, _, state = backend.greedy_start(ids, mask, LLM_NEW_TOKENS,
                                                       return_logits=False)
                start_s = time.perf_counter() - t0  # both prefills; the ids reached the host
                parts = [first]
                while sum(p.shape[1] for p in parts) < LLM_NEW_TOKENS:
                    n = min(SPEC_SEGMENT, LLM_NEW_TOKENS - sum(p.shape[1] for p in parts))
                    part, _, state = backend.greedy_resume(state, n, return_logits=False)
                    parts.append(part)
                got = np.concatenate(parts, axis=1)
                del state
            else:
                got, logits = backend.greedy(ids, mask, LLM_NEW_TOKENS,
                                             return_logits=run == "logits")
            wall = time.perf_counter() - t0
            counts = main_path_counts()
            hist = backend.spec_acc_hist - hist0
            k6 = counts["int4_matmul"]
            if k6 != per_round * rounds[0] or rounds[0] == 0:
                raise AssertionError(f"speculative ({run}): {k6} K6 launches in {rounds[0]} "
                                     f"verify rounds, not {per_round} a round")
            agree = near_tie_agreement(got, ref_ids, ref_logits, tol, f"speculative ({run})")
            rate = acceptance(hist)
            if script is not None and not rate <= SPEC_ACCEPT_MAX:
                raise AssertionError(f"speculative ({run}): scripted acceptance {rate} > "
                                     f"{SPEC_ACCEPT_MAX}")
            note = ""
            if logits is not None:
                step1 = float(np.abs(logits[:, 1] - ref_logits[:, 1]).max())
                if not (np.array_equal(logits[:, 0], ref_logits[:, 0]) and step1 <= tol
                        and np.isfinite(logits).all()):
                    raise AssertionError(f"speculative ({run}): the prefill's logits differ "
                                         f"from phase 8's, or the first step's by {step1} > "
                                         f"{tol}, or not finite")
                note = (f"; the prefill's logits equal phase 8's, the first step's within "
                        f"{step1:.4g} (tolerance {tol:.4g})")
            runs[run] = {"wall": wall, "start_s": start_s, "hist": hist.tolist(),
                         "rounds": rounds[0], "k6": k6, "agree": agree, "acceptance": rate,
                         "launches": counts}
            scripted = " (scripted: every 5th proposal flipped)" if script is not None else ""
            log(f"  (a) {run}{scripted}: ids equal to phase 8's greedy for {agree} tokens a "
                f"row (each up to its first near-tie at least){note}; {rounds[0]} rounds, {k6} "
                f"K6 launches = "
                f"{per_round} x the verify rounds ({LLM_ROWS} x {SPEC_GAMMA} = "
                f"{LLM_ROWS * SPEC_GAMMA} rows a verify); spec_acc_hist {hist.tolist()} "
                f"(rounds that accepted 0..{SPEC_GAMMA - 1} drafts), acceptance {rate:.3f}, "
                f"{LLM_ROWS * steps / rounds[0]:.2f} tokens a round")
            # the next run's script: this run's stream, the target's greedy stream as
            # the verify forward computes it at this run's windows
            script = np.where(flip, (got + 1) % config.vocab_size, got)
    finally:
        speculative._spec_round = spec_round
    start_s = runs["segmented"]["start_s"]
    for run, r in runs.items():
        r["ms_token"] = (r["wall"] - start_s) * 1e3 / steps
        log(f"  [{power}] (a) {run}: {r['wall']:.2f} s; {r['ms_token']:.2f} ms per emitted "
            f"position ({LLM_ROWS} tokens), {LLM_ROWS * steps / (r['wall'] - start_s):.1f} "
            f"tokens/s (the call's host clock less the segmented run's {start_s * 1e3:.0f} ms "
            f"greedy_start, both models' prefill, over {steps} positions); phase 8's greedy "
            f"{decoded['step_ms']:.2f} ms a step, {LLM_ROWS * 1e3 / decoded['step_ms']:.1f} "
            "tokens/s")
    try:
        llm_mod.TorchLlamaBackend(params, dataclasses.replace(config, kv_quant_bits=8),
                                  eos_token_id=EOS_ID, draft_params=d_params,
                                  draft_config=d_config)
    except ValueError as e:
        log(f"  (a) a draft with kv_quant_bits=8 refused: {e}")
    else:
        raise AssertionError("a draft with the int8 KV cache was not refused")
    return {"runs": runs, "start_s": start_s}


def prefix_pool(decoded: dict, power) -> dict:
    """Phase 17 (b): the prefix-KV pool at full width, phase 8's NF4 Llama,
    4 groups of 2048 slots, 4 rows of one group (a question's beams) sharing
    1,000 prompt tokens, each with its own tail; the first call seeds the
    pool and the second reuses it, with the bf16 cache and with
    kv_quant_bits=8: ids equal to plain greedy's (same cache) up to each
    row's first near-tie, the first token's logits within LOGIT_TOL; each
    row's match_len; the pool's bytes; the prefill time of each call and of
    the plain call (host clock to synchronize)."""
    from kirag_tpu_torch.kernels import reset_launch_counts
    from kirag_tpu_torch.models import llm as llm_mod

    params, config = decoded["params"], decoded["config"]
    rng = np.random.RandomState(SEED + 17)
    shared = rng.randint(0, 128000, PREFIX_SHARED)
    rows = [np.concatenate([shared, rng.randint(0, 128000, t)]) for t in PREFIX_TAILS]
    width = max(len(r) for r in rows)
    ids = np.zeros((len(rows), width), np.int32)
    mask = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        ids[i, width - len(r):], mask[i, width - len(r):] = r, 1
    seconds, matches = {}, []
    originals = {name: getattr(llm_mod, name) for name in
                 ("write_prefix_pool", "_prefixed_prefill_state", "_prefill_state")}

    def timed(name):
        fn = originals[name]

        def run(*args, **kwargs):
            if name == "_prefixed_prefill_state":
                matches.append(args[3].cpu().numpy())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    out = {"launches": []}
    for name in originals:
        setattr(llm_mod, name, timed(name))
    try:
        for label, bits in (("bf16", None), ("int8", 8)):
            cfg = dataclasses.replace(config, kv_quant_bits=bits)
            seconds.clear()
            ref_ids, ref_logits = llm_mod.TorchLlamaBackend(params, cfg, EOS_ID).greedy(
                ids, mask, PREFIX_STEPS)
            plain_s = seconds["_prefill_state"]
            tol = LOGIT_TOL * float(np.abs(ref_logits[:, 1]).max())
            pooled = llm_mod.TorchLlamaBackend(params, cfg, EOS_ID,
                                               prefix_cache_groups=PREFIX_GROUPS,
                                               prefix_cache_tokens=PREFIX_TOKENS)
            calls = {}
            for call in ("seeding", "reusing"):
                seconds.clear()
                matches.clear()
                reset_launch_counts()
                t0 = time.perf_counter()
                got, logits = pooled.greedy(ids, mask, PREFIX_STEPS, prefix_groups=["q"] * 4)
                wall = time.perf_counter() - t0
                out["launches"].append(main_path_counts())
                first = float(np.abs(logits[:, 0] - ref_logits[:, 0]).max())
                if not (first <= tol and np.isfinite(logits).all()):
                    raise AssertionError(f"prefix pool ({label}, {call}): the first token's "
                                         f"logits {first} from plain greedy's > {tol}")
                # the int8 pool's prefill attends the prefix's quantized keys where
                # the plain int8 prefill attends the prompt's own: the token at a
                # near-tie may flip from the first one on
                agree = near_tie_agreement(got, ref_ids, ref_logits, tol,
                                           f"prefix pool ({label}, {call})",
                                           through_tie=bits is None)
                calls[call] = {"wall": wall, "write_s": seconds.get("write_prefix_pool", 0.0),
                               "prefill_s": seconds["_prefixed_prefill_state"],
                               "match": matches[0].tolist(), "agree": agree, "first": first,
                               "ids": got, "logits": logits}
            pool = pooled._prefix_pool
            pool_bytes = sum(nbytes(*(c.values() if isinstance(c, dict) else (c,)))
                             for c in pool["k"] + pool["v"])
            seed, reuse = calls["seeding"], calls["reusing"]
            if not (seed["write_s"] > 0 and reuse["write_s"] == 0
                    and min(reuse["match"]) >= PREFIX_SHARED
                    and np.array_equal(seed.pop("ids"), reuse.pop("ids"))
                    and np.array_equal(seed.pop("logits"), reuse.pop("logits"))):
                raise AssertionError(f"prefix pool ({label}): seeding wrote "
                                     f"{seed['write_s']} s, reuse {reuse['write_s']} s, "
                                     f"matches {reuse['match']}, or the two calls' ids or "
                                     "logits differ")
            log(f"  (b) {label} cache, {len(rows)} rows of {[len(r) for r in rows]} tokens "
                f"sharing {PREFIX_SHARED}, one group: match_len a row {reuse['match']} (seeding "
                f"call {seed['match']}); the seeding and the reusing call's ids and logits "
                f"bitwise equal; ids equal to plain greedy's for {seed['agree']} tokens a row "
                f"(each up to its first near-tie at least, "
                f"{'that step included' if bits is None else 'that step excluded'}), the first "
                f"token's logits within {seed['first']:.4g} (tolerance {tol:.4g}); pool "
                f"{PREFIX_GROUPS} x "
                f"{PREFIX_TOKENS} slots x {config.num_hidden_layers} layers: "
                f"{pool_bytes / 1e9:.3f} GB")
            log(f"  [{power}] (b) {label}: prefill (host clock to synchronize) plain "
                f"{plain_s * 1e3:.1f} ms; seeding call {seed['write_s'] * 1e3:.1f} ms to write "
                f"the group's {PREFIX_TOKENS} slots + {seed['prefill_s'] * 1e3:.1f} ms of "
                f"suffixes; reusing call {reuse['prefill_s'] * 1e3:.1f} ms; whole calls of "
                f"{PREFIX_STEPS} tokens {seed['wall']:.2f} / {reuse['wall']:.2f} s")
            out[label] = {"plain_prefill_s": plain_s, "pool_bytes": pool_bytes, **calls}
            del pooled, pool
    finally:
        for name, fn in originals.items():
            setattr(llm_mod, name, fn)
    return out


def filled_kg_cache(work: Path, built: dict, run: str) -> Path:
    """A copy of run B's KG cache (``kg_cache.pkl``) with a seeded triple
    for every passage of phase 6's TSV that it lacks (as phase 9 seeds run
    A's documents) but the held-out ones (``kg_held_out.json``): a run over
    it decodes KG triples for those alone, however its stream or search
    differs from run B's."""
    import pickle

    from kirag_tpu_torch.data import CORPUS_MAP

    with open(work / "kg_cache.pkl", "rb") as f:
        cached = pickle.load(f)
    held = set(json.loads((work / "kg_held_out.json").read_text()))
    for row in CORPUS_MAP["wikipedia"](corpus_path=str(built["tsv"])).data:
        if row["id"] not in cached and row["id"] not in held:
            cached[row["id"]] = seed_triple(dict(row))
    path = work / f"kg_cache_{run}.pkl"
    with open(path, "wb") as f:
        pickle.dump(cached, f)
    return path


def spec_pool_cli(work: Path, built: dict, decoded: dict, draft, power) -> dict:
    """Phase 17 (c): run B again at phase 9's depth over copies of its KG
    cache, held to phase 9's checks (K1, K2, K3 and K6 launched): run F with
    ``--draft_llm --spec_gamma 4``, the draft cut to its first 2 layers and
    handed in through ``main(draft_llm=)`` (its acceptance histogram
    non-zero); run G with ``--llm_prefix_cache_groups 4`` and a second turn
    (its prefix reuses printed). The copies are ``filled_kg_cache``'s, so
    that the KG step decodes the held-out documents alone: another stream
    than run B's (speculative or prefixed arithmetic at bf16) retrieves
    other documents."""
    from kirag_tpu_torch.models import llm as llm_mod

    llm = phase9_llm(decoded)
    d_params, d_config = draft
    small = ({**d_params, "layers": d_params["layers"][:DRAFT_LAYERS_F]},
             dataclasses.replace(d_config, num_hidden_layers=DRAFT_LAYERS_F))
    runs = {}
    for run in ("F", "G"):
        cache = filled_kg_cache(work, built, run)
        matches, prefixed = [], llm_mod.greedy_decode_prefixed
        if run == "F":
            extra, kw = ("--draft_llm", "Llama-3.2-1B", "--spec_gamma", str(SPEC_GAMMA)), {
                "draft_llm": small}
        else:  # a second turn, whose constructor call reuses the question's prefix
            extra, kw = ("--llm_prefix_cache_groups", str(PREFIX_GROUPS), "--num_turns",
                         str(KIRAG_TURNS + 1)), {}
            llm_mod.greedy_decode_prefixed = (
                lambda *a, **k: matches.append(np.asarray(a[3])) or prefixed(*a, **k))
        try:
            runs[run] = retrieve_run(work, built, llm, run, KIRAG_CACHED, cache, power,
                                     extra=extra, **kw)
        finally:
            llm_mod.greedy_decode_prefixed = prefixed
        backend = runs[run].pop("backend")
        if run == "F":
            hist = backend.spec_acc_hist.tolist()
            if not sum(hist):
                raise AssertionError("run F: the backend's spec_acc_hist is zero")
            log(f"  run F: the constructor's decodes speculative, a {DRAFT_LAYERS_F}-layer "
                f"draft; spec_acc_hist {hist}, acceptance {acceptance(hist):.3f}")
        else:
            if not any((m > 0).any() for m in matches[1:]):
                raise AssertionError(f"run G: no later call reused a cached prefix "
                                     f"({len(matches)} prefixed calls)")
            log(f"  run G: {len(matches)} prefixed constructor calls, each row's match_len "
                f"by call {[m.tolist() for m in matches]} (a group's first call seeds its "
                f"slot, then reuses it); {len(backend._prefix_meta)} groups in the pool")
    return runs


def spec_and_pool(work: Path, built: dict, decoded: dict, dev, power) -> dict:
    """Phase 17: speculative decoding and the prefix-KV pool, (a)-(c), with
    phase 8's model resident and a seeded bf16 draft beside it."""
    from kirag_tpu_torch.models import llm as llm_mod

    t0 = time.perf_counter()
    d_config = draft_llm_config()
    d_params = llm_mod.init_llama_params(d_config, seed=SEED + 17, device=dev,
                                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  draft: Llama-3.2-1B geometry ({d_config.num_hidden_layers} layers x "
        f"{d_config.hidden_size}, {d_config.num_attention_heads} heads / "
        f"{d_config.num_key_value_heads} KV, MLP {d_config.intermediate_size}, vocab "
        f"{d_config.vocab_size}, tied embeddings, rope_theta {d_config.rope_theta:g}, plain "
        f"RoPE: no rope_scaling in the port), seeded bf16, "
        f"{llm_mod.param_bytes(d_params) / 1e9:.3f} GB, built in {time.perf_counter() - t0:.1f} "
        "s")
    draft = (d_params, d_config)
    invariance = k6_row_invariance(decoded["params"], decoded["config"], dev)
    out = {"k6_rows": invariance, "spec": spec_decode(decoded, draft, power),
           "pool": prefix_pool(decoded, power)}
    out["cli"] = spec_pool_cli(work, built, decoded, draft, power)
    out["launches"] = ([r["launches"] for r in out["spec"]["runs"].values()]
                       + out["pool"]["launches"] + [r["launches"] for r in out["cli"].values()])
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 17: {out['seconds']:.1f} s; K6 {sum(c['int4_matmul'] for c in out['launches'])} "
        "launches in its main-path runs")
    return out


# ---------------------------------------------------------------- phase 10

# (a) K3's backward against its plain version at the aligner's query batch,
# 32 sequences x 16 heads x 256 tokens. dq, dk and dv each within a share of
# the tensor's largest magnitude: bf16 2^-6 (both versions round P and dS to
# bf16 before their products; exponentials and sums run in other orders),
# f32 1e-4 (f32 sums of up to 256 products in other orders); and the f32
# kernels, on the plain forward's residuals, within 1e-5: their products are
# split TF32 (three passes, f32-grade), which one TF32 pass (about 5e-4
# here, tests/test_torch_flash_bwd_tf32.py) would miss
BWD_SHAPE = (32, 16, 256, 64)
BWD_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-4}
BWD_TOL_F32_KERNELS = 1e-5
# (b) one training step through the kernels against the same step through
# the plain K3 forward and backward: f32 gradients within 1e-4 of each
# tensor's norm, bf16 gradients at a cosine of at least 0.99 per tensor; the
# three remat modes' f32 gradients within 1e-6 of the norm (the same
# operations, recomputed). The check runs under
# torch.use_deterministic_algorithms: PyTorch's embedding backward sums the
# rows of a repeated index (all 4,096 packed tokens share token type 0) in
# an order that changes from run to run, 8e-7 of that gradient's norm
# between two identical runs on the H100
GRAD_TOL_F32 = 1e-4
GRAD_COS_BF16 = 0.99
REMAT_TOL = 1e-6
GRAD_QUERIES = 8  # the gradient check's batch: 8 queries and their 32 docs
# (d) the geometry of benchmarks/bench_train.py, the JAX package's training
# benchmark: 32 queries x 256 tokens, 4 docs each (1 positive, 3 negatives)
# x 64 tokens, bf16 compute over f32 master weights, 8 steps on one batch
# (enough for the loss to fall; phase 21 has the time that more would take)
TRAIN_QUERIES, DOCS_PER_QUERY, TRAIN_Q_LEN, TRAIN_D_LEN, TRAIN_STEPS = 32, 4, 256, 64, 8
# (c) the CLI's data: 64 training examples (8 micro batches of 8 at the
# defaults: 4 updates at accumulation 2), 8 dev examples, 14 hard negatives each
CLI_TRAIN, CLI_DEV, CLI_NEG_TITLES = 64, 8, 7
K3_NAMES = ("flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")


# (a)'s sequence lengths and segment layouts: flash_segments' mixed rows, and
# every token real (the aligner's training batches, as bench_train's)
BWD_TS = (128, 256, 512)
BWD_LAYOUTS = ("segments", "all real")


def bwd_segments(layout: str, b: int, t: int, dev) -> torch.Tensor:
    """[b, t] segment ids: flash_segments' rows, every token real (one
    segment), or ("packed docs") TRAIN_D_LEN-token documents packed
    end to end, as the packed training step passes its docs."""
    if layout == "segments":
        return flash_segments(b, t, dev)
    seg = torch.ones(b, t, dtype=torch.int32, device=dev)
    if layout == "packed docs":
        seg += torch.arange(t, device=dev, dtype=torch.int32) // TRAIN_D_LEN
    return seg


def tile_pairs_skipped(seg: torch.Tensor, q_rows: int = 64) -> float:
    """The share of (query block, key tile) pairs, over the batch, that the
    kernels skip: those whose segment-id ranges do not overlap. Key tiles
    are 64 rows; query blocks ``q_rows`` (64 for the bf16 kernels, 128 for
    the f32 forward; the last one may be shorter)."""
    b, t = seg.shape
    tiles = seg.view(b, t // 64, 64)
    lo, hi = tiles.amin(-1), tiles.amax(-1)
    per = q_rows // 64
    q_lo = torch.stack([lo[:, i:i + per].amin(-1) for i in range(0, t // 64, per)], 1)
    q_hi = torch.stack([hi[:, i:i + per].amax(-1) for i in range(0, t // 64, per)], 1)
    meet = (q_lo[:, :, None] <= hi[:, None, :]) & (lo[:, None, :] <= q_hi[:, :, None])
    return 1.0 - float(meet.float().mean())


def bwd_inputs(shape, dtype, seg, gen, dev):
    """q, k, v (views of one fused projection, as the encoder passes them),
    dO, the plain forward's out and lse, and di = rowsum(out * dO)."""
    from kirag_tpu_torch.kernels import flash_attention_plain

    b, h, t, d = shape
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device=dev).to(dtype)
    q, k, v = (x.view(b, t, h, d).transpose(1, 2) for x in qkv.split(h * d, dim=-1))
    do = torch.randn(b, h, t, d, generator=gen, device=dev).to(dtype)
    o, lse = flash_attention_plain(q, k, v, seg, 1.0 / math.sqrt(d), return_lse=True)
    di = torch.sum(o.float() * do.float(), dim=-1)
    return q, k, v, do, o, lse, di


def bwd_kernel_ms(q, k, v, seg, lse, di, do) -> tuple:
    """(dK/dV, dQ) kernel times, CUDA events, median of 10."""
    from kirag_tpu_torch.kernels import flash_attention_bwd_dkv, flash_attention_bwd_dq

    scale = 1.0 / math.sqrt(q.shape[-1])
    return (cuda_ms(lambda: flash_attention_bwd_dkv(q, k, v, seg, lse, di, do, scale)),
            cuda_ms(lambda: flash_attention_bwd_dq(q, k, v, seg, lse, di, do, scale)))


def check_flash_bwd(dev, gen, power) -> dict:
    """(a) K3's two backward kernels against the plain backward, at
    [32, 16, T, 64] for T in BWD_TS, on BWD_LAYOUTS' segment rows, bf16 and
    f32 (q, k, v as views of one fused projection): on the plain forward's
    residuals, and through the autograd Function (the forward kernel's own
    lse); a second launch of each kernel on the same inputs must give the
    same bits. Then each kernel, the plain backward and the backward of
    scaled_dot_product_attention with the same-segment boolean mask (a
    yardstick only), timed with CUDA events, median of 10. Keyed (dtype, T,
    layout); out[dtype] is BWD_SHAPE on flash_segments' rows."""
    from kirag_tpu_torch.kernels import (flash_attention, flash_attention_bwd_dkv,
                                         flash_attention_bwd_dq, flash_attention_bwd_plain)

    b, h, _, d = BWD_SHAPE
    scale = 1.0 / math.sqrt(d)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for t in BWD_TS:
            for layout in BWD_LAYOUTS:
                shape = [b, h, t, d]
                what = f"K3 backward {str(dtype)[6:]} {shape} {layout}"
                seg = bwd_segments(layout, b, t, dev)
                mask = seg[:, None, :, None] == seg[:, None, None, :]
                pairs = int(mask.sum())  # same-segment (query, key) pairs, over the batch
                q, k, v, do, o, lse, di = bwd_inputs(shape, dtype, seg, gen, dev)
                want = flash_attention_bwd_plain(q, k, v, seg, o, lse, do, scale)
                dk, dv = flash_attention_bwd_dkv(q, k, v, seg, lse, di, do, scale)
                dq = flash_attention_bwd_dq(q, k, v, seg, lse, di, do, scale)
                dk2, dv2 = flash_attention_bwd_dkv(q, k, v, seg, lse, di, do, scale)
                dq2 = flash_attention_bwd_dq(q, k, v, seg, lse, di, do, scale)
                qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
                through = torch.autograd.grad(flash_attention(qg, kg, vg, seg, scale),
                                              (qg, kg, vg), do)
                torch.cuda.synchronize()
                errs = {}
                for label, got in (("kernels", (dq, dk, dv)), ("Function", through)):
                    for name, x, y in zip(("dq", "dk", "dv"), got, want):
                        err = float((x.float() - y.float()).abs().max())
                        lim = BWD_TOL[dtype] * float(y.float().abs().max())
                        if not (x.dtype == dtype and torch.isfinite(x).all() and err <= lim):
                            raise AssertionError(f"{what}: {label} {name} differs from plain "
                                                 f"by {err} > {lim}, or is not finite")
                        errs[(label, name)] = err
                if dtype == torch.float32:
                    for name, y in zip(("dq", "dk", "dv"), want):
                        lim = BWD_TOL_F32_KERNELS * float(y.abs().max())
                        if not errs[("kernels", name)] <= lim:
                            raise AssertionError(f"{what}: kernels' {name} differs from plain by "
                                                 f"{errs[('kernels', name)]} > {lim} (split TF32 "
                                                 "must be f32-grade)")
                for name, x, y in zip(("dq", "dk", "dv"), (dq, dk, dv), (dq2, dk2, dv2)):
                    if not torch.equal(x, y):
                        raise AssertionError(f"{what}: two launches on the same inputs give "
                                             f"different {name}")
                # each input read once, each output written once; 2 * 64 operations
                # per product, same-segment pair and head: dK/dV recomputes S = Q K^T
                # and takes dP = dO V^T, dV = P^T dO, dK = dS^T Q (8 * 64); dQ
                # recomputes S and dP and takes dQ = dS K (6 * 64); the backward as a
                # whole needs S, dP, dV, dK and dQ once each (10 * 64); f32 at the
                # split-TF32 rate, and at the CUDA cores' beside it (the earlier bound)
                def bounds(ops_s):
                    return {"bound_dkv": bound(nbytes(q, k, v, do, lse, di, seg, dk, dv),
                                               8 * d * h * pairs, ops_s),
                            "bound_dq": bound(nbytes(q, k, v, do, lse, di, seg, dq),
                                              6 * d * h * pairs, ops_s),
                            "bound": bound(nbytes(q, k, v, o, do, lse, seg, dq, dk, dv),
                                           10 * d * h * pairs, ops_s)}

                r = {"err_dkv": max(errs[("kernels", "dk")], errs[("kernels", "dv")]),
                     "err_dq": errs[("kernels", "dq")], "skipped": tile_pairs_skipped(seg),
                     **bounds(BF16_FLOP_S if dtype == torch.bfloat16 else TF32X3_FLOP_S)}
                if dtype == torch.float32:
                    r["bound_cuda_cores"] = bounds(F32_FLOP_S)
                del dq, dk, dv, dq2, dk2, dv2, through, want, qg, kg, vg
                ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
                lib_out = torch.nn.functional.scaled_dot_product_attention(
                    ql, kl, vl, attn_mask=mask, scale=scale)
                r["dkv_ms"], r["dq_ms"] = bwd_kernel_ms(q, k, v, seg, lse, di, do)
                r.update({
                    "plain_ms": cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, seg, o, lse,
                                                                          do, scale)),
                    "library_ms": cuda_ms(lambda: torch.autograd.grad(
                        lib_out, (ql, kl, vl), do, retain_graph=True))})
                out[(dtype, t, layout)] = r
                log(f"  {what}: dq, dk, dv within {errs[('kernels', 'dq')]:.3g}, "
                    f"{errs[('kernels', 'dk')]:.3g}, {errs[('kernels', 'dv')]:.3g} of plain on "
                    f"the plain forward's residuals; through the Function (the forward "
                    f"kernel's lse) {errs[('Function', 'dq')]:.3g}, "
                    f"{errs[('Function', 'dk')]:.3g}, {errs[('Function', 'dv')]:.3g} "
                    f"(tolerance {BWD_TOL[dtype]:.3g} x each tensor's largest magnitude); a "
                    f"second launch bitwise equal; same-segment pairs "
                    f"{pairs / (b * t * t):.3f} of all; tile pairs skipped "
                    f"{r['skipped']:.3f} of all")
                cc = ""
                if dtype == torch.float32:
                    c = r["bound_cuda_cores"]
                    cc = (f"; bounds at 3xTF32's {TF32X3_FLOP_S / 1e12:.0f} TFLOP/s, at the CUDA "
                          f"cores' {F32_FLOP_S / 1e12:.0f}: dK/dV {c['bound_dkv'][0]:.4f}, dQ "
                          f"{c['bound_dq'][0]:.4f}, the pair {c['bound_dkv'][0] + c['bound_dq'][0]:.4f}, "
                          f"the backward {c['bound'][0]:.4f} ms")
                log(f"  [{power}] {what}: dK/dV {r['dkv_ms']:.4f} ms (bound "
                    f"{r['bound_dkv'][0]:.4f} ms, {r['bound_dkv'][1]}), dQ {r['dq_ms']:.4f} ms "
                    f"(bound {r['bound_dq'][0]:.4f} ms, {r['bound_dq'][1]}); the pair "
                    f"{r['dkv_ms'] + r['dq_ms']:.4f} ms (bound "
                    f"{r['bound_dkv'][0] + r['bound_dq'][0]:.4f} ms) vs plain "
                    f"{r['plain_ms']:.3f} ms vs SDPA's backward with mask {r['library_ms']:.4f} ms, "
                    f"the backward's bound {r['bound'][0]:.4f} ms ({r['bound'][1]}){cc} (CUDA "
                    "events, median of 10)")
                del q, k, v, do, o, lse, di, ql, kl, vl, lib_out, mask
        out[dtype] = out[(dtype, BWD_SHAPE[2], "segments")]
    return out


def train_batch(n_queries: int, rng, padded: bool) -> tuple:
    """A collated aligner batch, the collator's tuple of numpy arrays:
    ``n_queries`` queries of TRAIN_Q_LEN tokens and DOCS_PER_QUERY docs each
    of TRAIN_D_LEN (query i's positive first), ids from the hashing
    tokenizer's range after [CLS]; ``padded``: rows of random lengths,
    right-padded with 0, else every token real (as the benchmark's)."""
    def rows(n, width):
        lengths = rng.randint(width // 4, width + 1, n) if padded else np.full(n, width)
        mask = (np.arange(width)[None] < lengths[:, None]).astype(np.int32)
        ids = rng.randint(1000, HashTokenizer.vocab, (n, width)).astype(np.int32)
        ids[:, 0] = HashTokenizer.cls_id
        return {"input_ids": ids * mask, "attention_mask": mask}

    index = np.arange(n_queries, dtype=np.int32)
    return (rows(n_queries, TRAIN_Q_LEN), rows(n_queries * DOCS_PER_QUERY, TRAIN_D_LEN),
            index * DOCS_PER_QUERY, index)


def grad_gap(got, want, names):
    """The largest ||g - w|| / ||w|| over the tensors, and its tensor's name
    (a tensor whose reference is zero must be zero)."""
    worst = (0.0, "")
    for g, w, name in zip(got, want, names):
        diff, norm = float(torch.linalg.vector_norm(g - w)), float(torch.linalg.vector_norm(w))
        gap = diff / norm if norm > 0 else (0.0 if diff == 0 else math.inf)
        worst = max(worst, (gap, name))
    return worst


def grad_cosine(got, want, names):
    """The smallest cosine between two tensors' gradients, and its name
    (tensors that are zero in both are skipped)."""
    worst = (1.0, "")
    for g, w, name in zip(got, want, names):
        ng, nw = float(torch.linalg.vector_norm(g)), float(torch.linalg.vector_norm(w))
        if ng == nw == 0:
            continue
        cos = float(torch.sum(g.double() * w.double())) / (ng * nw) if ng * nw > 0 else 0.0
        worst = min(worst, (cos, name))
    return worst


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` inside,
    the previous setting restored after."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def check_train_grads(model, dev) -> dict:
    """(b) One training step's loss and every parameter's gradient through
    the K3 kernels against the same step through the plain K3 forward and
    backward (``flash_attention_reference`` in the encoder, on the card):
    f32 and bf16 compute, two-call and packed, on GRAD_QUERIES padded
    queries and their docs; and the f32 gradients of the remat modes none,
    full and dots against each other."""
    from kirag_tpu_torch.kernels import (flash_attention_reference, launch_counts,
                                         reset_launch_counts)
    from kirag_tpu_torch.models import bert
    from kirag_tpu_torch.training import in_batch_contrastive_loss

    q_args, d_args, pos, _ = train_batch(GRAD_QUERIES, np.random.RandomState(SEED + 11), True)
    f32_launches = dict.fromkeys(K3_NAMES, 0)  # the f32 steps through the kernels
    batch = {"query_args": {k: torch.from_numpy(v).long().to(dev) for k, v in q_args.items()},
             "doc_args": {k: torch.from_numpy(v).long().to(dev) for k, v in d_args.items()},
             "positive_doc_indices": torch.from_numpy(pos).long().to(dev)}
    names, params = zip(*model.named_parameters())

    def step(dtype, remat=False, packed=False, plain=False):
        kernel_fn = bert.flash_attention
        if plain:
            bert.flash_attention = flash_attention_reference
        reset_launch_counts()
        try:
            loss, _ = in_batch_contrastive_loss(model, batch, "e5", 0.01, dtype, remat=remat,
                                                packed=packed)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            bert.flash_attention = kernel_fn
        counts = [launch_counts()[k] for k in K3_NAMES]
        if (max(counts) != 0) if plain else (min(counts) == 0):
            raise AssertionError(f"gradient check ({dtype}, remat {remat}, packed {packed}, "
                                 f"plain {plain}): K3 launches {counts}")
        if dtype == torch.float32 and not plain:
            for name, n in zip(K3_NAMES, counts):
                f32_launches[name] += n
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return float(loss.detach()), grads

    out = {}
    with deterministic_algorithms():
        for packed in (False, True):
            label = "packed" if packed else "two-call"
            ref_loss, ref = step(torch.float32, packed=packed, plain=True)
            loss, got = step(torch.float32, packed=packed)
            gap = grad_gap(got, ref, names)
            if not (gap[0] <= GRAD_TOL_F32 and abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)):
                raise AssertionError(f"f32 {label} step: loss {loss} vs plain {ref_loss}; "
                                     f"gradient {gap[1]} off by {gap[0]} > {GRAD_TOL_F32} of "
                                     "its norm")
            out[("f32", label)] = gap[0]
            log(f"  f32 {label} step: loss {loss:.6f} through the K3 kernels, {ref_loss:.6f} "
                f"through the plain K3; worst gradient {gap[1]} within {gap[0]:.3g} of its norm "
                f"(tolerance {GRAD_TOL_F32})")
            del ref
            for remat in (True, "dots"):
                _, again = step(torch.float32, remat=remat, packed=packed)
                gap = grad_gap(again, got, names)
                if not gap[0] <= REMAT_TOL:
                    raise AssertionError(f"f32 {label} step: remat {remat} gradient {gap[1]} off "
                                         f"by {gap[0]} > {REMAT_TOL} of its norm")
                out[("remat", label, remat)] = gap[0]
                log(f"  f32 {label} step, remat {remat} vs none: worst gradient {gap[1]} within "
                    f"{gap[0]:.3g} of its norm (tolerance {REMAT_TOL})")
            del got, again
            ref_loss, ref = step(torch.bfloat16, packed=packed, plain=True)
            loss, got = step(torch.bfloat16, packed=packed)
            cos = grad_cosine(got, ref, names)
            if not cos[0] >= GRAD_COS_BF16:
                raise AssertionError(f"bf16 {label} step: gradient {cos[1]} at cosine {cos[0]} < "
                                     f"{GRAD_COS_BF16} to the plain K3's")
            out[("bf16", label)] = cos[0]
            log(f"  bf16 {label} step: loss {loss:.6f} through the K3 kernels, {ref_loss:.6f} "
                f"through the plain K3; smallest gradient cosine {cos[0]:.6f} ({cos[1]}; "
                f"tolerance {GRAD_COS_BF16})")
            del ref, got
    out["launches_f32"] = f32_launches
    log(f"  f32 training steps through the kernels (two-call and packed, remat none, full "
        f"and dots): K3 launches {[f32_launches[k] for k in K3_NAMES]}")
    return out


def write_aligner_folder(folder: Path, rng) -> None:
    """A hotpotqa-format data folder for the Aligner CLI, made from ``rng``:
    ``train_aligner.json`` and ``dev_aligner.json`` with 2-hop supporting
    triples and 14 hard-negative triples (two under each of 7 titles) per
    question, and ``is_comparison_map.pkl`` marking every fourth question a
    comparison (whose hops may come in any order). Questions of 100-200
    words put every query batch in the 128- or 256-token bucket (through
    K3); triples of 30-45 object words put the docs in the 64-token one."""
    import pickle

    words = np.array(WORDS)

    def phrase(lo, hi):
        return " ".join(words[rng.randint(0, len(words), rng.randint(lo, hi + 1))])

    def triple(title):
        return {"title": title, "text": f"<{title}; {phrase(1, 3)}; {phrase(30, 45)}>"}

    def example(i):
        negatives = {}
        for _ in range(CLI_NEG_TITLES):
            title = phrase(2, 4).title()
            negatives[title] = [triple(title), triple(title)]
        return {"id": f"q{i}", "question": phrase(100, 200) + " ?", "answers": [phrase(1, 3)],
                "supporting_triples": [triple(phrase(2, 4).title()) for _ in range(2)],
                "hard_negative_triples": negatives}

    folder.mkdir(parents=True)
    for name, rows in (("train_aligner.json", range(CLI_TRAIN)),
                       ("dev_aligner.json", range(CLI_TRAIN, CLI_TRAIN + CLI_DEV))):
        (folder / name).write_text(json.dumps([example(i) for i in rows]))
    with open(folder / "is_comparison_map.pkl", "wb") as f:
        pickle.dump({f"q{i}": i % 4 == 0 for i in range(CLI_TRAIN + CLI_DEV)}, f)


def train_cli(work: Path, model_dir: Path, dev, power) -> dict:
    """(c) kirag_tpu_torch.cli.train_aligner.main at its defaults (bf16, remat
    dots, accumulation 2, batch 8 x 2 positives x 10 negatives, 256/64
    tokens) but one epoch, over a seeded hotpotqa folder, phase 6's E5-large
    npz and the hashing tokenizer. Checks the checkpoints, metrics.jsonl,
    the saved encoder read back by load_encoder, finite losses and each K3
    kernel's launches against the count the batches' buckets call for."""
    from kirag_tpu_torch.cli import train_aligner
    from kirag_tpu_torch.kernels import reset_launch_counts
    from kirag_tpu_torch.models import load_encoder
    from kirag_tpu_torch.training import aligner

    folder = work / "aligner_data" / "hotpotqa"
    write_aligner_folder(folder, np.random.RandomState(SEED + 20))
    seen = {"train": [], "docs": [], "eval": [], "losses": [], "step_s": []}
    step_fn, score_fn = aligner.AlignerTrainer.training_step, aligner.AlignerTrainer._score_batch

    def step(self, collated):  # records each micro batch's buckets, loss and host time
        seen["trainer"] = self
        seen["train"].append(collated[0]["input_ids"].shape[1])
        seen["docs"].append(collated[1]["input_ids"].shape[1])
        t0 = time.perf_counter()
        stats = step_fn(self, collated)
        seen["step_s"].append(time.perf_counter() - t0)
        seen["losses"].append(stats["loss"])
        return stats

    def score(self, model, batch):  # records each eval batch's query bucket
        seen["eval"].append(batch["query_args"]["input_ids"].shape[1])
        return score_fn(self, model, batch)

    save_dir = work / "aligner"
    argv = ["--retriever_model_name_or_path", str(model_dir), "--data_folders", str(folder),
            "--num_train_epochs", "1", "--save_dir", str(save_dir), "--name", "run"]
    aligner.AlignerTrainer.training_step, aligner.AlignerTrainer._score_batch = step, score
    reset_launch_counts()
    try:
        t0 = time.perf_counter()
        result = train_aligner.main(argv, tokenizer=HashTokenizer())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        aligner.AlignerTrainer.training_step, aligner.AlignerTrainer._score_batch = (step_fn,
                                                                                     score_fn)
    counts = main_path_counts()

    trainer = seen.pop("trainer")
    layers = trainer.model.config.num_hidden_layers
    n_steps = len(seen["train"])
    # a query batch in a bucket of a multiple of 128 tokens runs K3 in each
    # layer: in training once forward (twice under remat, which recomputes
    # it), once each backward kernel; in evaluation once forward
    k3_train = sum(t % 128 == 0 for t in seen["train"])
    k3_eval = sum(t % 128 == 0 for t in seen["eval"])
    passes = 1 if trainer.remat is False else 2
    want = {"flash_attention": layers * (passes * k3_train + k3_eval),
            "flash_attention_bwd_dkv": layers * k3_train,
            "flash_attention_bwd_dq": layers * k3_train}
    run = save_dir / "run"
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    latest, best = sorted(os.listdir(run / "latest")), sorted(os.listdir(run / "best"))
    if not (n_steps == CLI_TRAIN // 8 and result["steps"] == n_steps
            and k3_train == n_steps and k3_eval == len(seen["eval"]) > 0
            and set(seen["docs"]) == {TRAIN_D_LEN}):
        raise AssertionError(f"train_aligner: {result['steps']} steps, query buckets "
                             f"{seen['train']}, doc buckets {seen['docs']}, eval buckets "
                             f"{seen['eval']}")
    if not all(math.isfinite(x) for x in seen["losses"]):
        raise AssertionError(f"train_aligner: losses {seen['losses']}")
    if not (latest == [str(n_steps)] and best == [str(n_steps)]
            and (run / "latest" / str(n_steps) / "state.pt").exists()
            and any("eval_metric" in r for r in records)
            and trainer.optimizer.count == n_steps // trainer.optimizer.accumulation_steps):
        raise AssertionError(f"train_aligner: checkpoints latest {latest}, best {best}, "
                             f"metrics {records}, {trainer.optimizer.count} updates")
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"train_aligner: K3 launches {counts}, expected {want}")
    loaded = load_encoder(result["encoder_dir"], device=dev).model.state_dict()
    trained = trainer.model.state_dict()
    if loaded.keys() != trained.keys() or not all(torch.equal(loaded[k], trained[k])
                                                  for k in trained):
        raise AssertionError("the saved encoder, read back by load_encoder, differs from "
                             "the trained weights")
    metric = [r["eval_metric"] for r in records if "eval_metric" in r][-1]
    ckpt_gb = sum(f.stat().st_size for f in (run / "latest").rglob("*") if f.is_file()) / 1e9
    log(f"  train_aligner --num_train_epochs 1: {n_steps} micro steps "
        f"({trainer.optimizer.count} updates, remat {trainer.remat}), query buckets "
        f"{seen['train']}, doc buckets {sorted(set(seen['docs']))}; losses "
        + ", ".join(f"{x:.4f}" for x in seen["losses"])
        + f"; dev MRR {metric:.4f} over {len(seen['eval'])} eval batches; latest and best "
        f"checkpoints at step {n_steps} ({ckpt_gb:.2f} GB each), metrics.jsonl, encoder npz "
        f"read back equal; K3 launches {[counts[k] for k in K3_NAMES]} = expected")
    log(f"  [{power}] train_aligner: {wall:.2f} s in all, micro steps "
        f"{statistics.median(seen['step_s']) * 1e3:.1f} ms (median, host clock to the loss "
        f"on the host), first {seen['step_s'][0] * 1e3:.1f} ms")
    del trainer, trained, loaded
    return {"launches": counts, "wall": wall, "losses": seen["losses"], "metric": metric,
            "step_ms": statistics.median(seen["step_s"]) * 1e3}


def step_flops(config) -> float:
    """Model FLOPs of one training step at the timing geometry, as
    benchmarks/bench_train.py counts them: the matmul parameters P = L (4 h^2
    + 2 h i) at 6 P per token (2 P forward, 4 P backward), and attention's
    Q K^T and P V at 4 T h per token and layer forward, 3 times that with the
    backward; recomputation under remat is not counted, and embeddings are
    lookups."""
    h, n_layers, inter = (config.hidden_size, config.num_hidden_layers,
                          config.intermediate_size)
    q_tok = TRAIN_QUERIES * TRAIN_Q_LEN
    d_tok = TRAIN_QUERIES * DOCS_PER_QUERY * TRAIN_D_LEN
    matmul = 6 * n_layers * (4 * h * h + 2 * h * inter) * (q_tok + d_tok)
    attention = 3 * 4 * h * n_layers * (TRAIN_Q_LEN * q_tok + TRAIN_D_LEN * d_tok)
    return float(matmul + attention)


def profile_train_step(trainer, batch, label, step_ms, power) -> dict:
    """Device time of one training step by kernel (torch.profiler): K3's
    forward and backward, the GEMMs, the rest, and the largest kernels; and
    the card's idle share of an unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.training_step(batch)
        torch.cuda.synchronize()
    split, by_name = kernel_times(prof, [
        ("K3 forward", ("flash_bf16_kernel", "flash_f32_kernel")),
        ("K3 backward", ("dkv_bf16_kernel", "dkv_tf32_kernel", "dq_bf16_kernel",
                         "dq_tf32_kernel"))])
    busy = sum(split.values()) / 1e3  # ms
    if busy <= 0:
        log("  profiler: no device time for the training step (not measured)")
        return {"busy_ms": None}
    idle = 1 - busy / step_ms
    log(f"  [{power}] one training step ({label}), device time by kernel (torch.profiler): "
        f"{busy:.2f} ms busy of an unprofiled {step_ms:.2f} ms step: idle {100 * idle:.1f}%; "
        + ", ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / 1e3 / busy:.1f}%)"
                    for k, v in split.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log("    largest: " + "; ".join(f"{n[:60]} {v / 1e3:.2f} ms" for n, v in top))
    return {"busy_ms": busy, "idle": idle, "split_ms": {k: v / 1e3 for k, v in split.items()}}


def train_timing(work: Path, model, power, query_bwd_ms: tuple) -> dict:
    """(d) AlignerTrainer.training_step at benchmarks/bench_train.py's
    geometry and optimizer (lr 2e-5 warming up over 1,000 of 10,000
    updates), bf16 compute over f32 master weights, two-call and packed
    (docs 4 to a 256-token row through K3), each remat mode: TRAIN_STEPS on
    one batch from the same weights, whose loss must fall; ms per step, peak
    memory, model-FLOPs per second against 989 TFLOP/s; K3's backward
    kernels' device time a step, as their launches a step (counted) times
    their CUDA-event times at the step's shape (``query_bwd_ms``: the
    query batch's, from (a); the packed pass's taken here); then one
    profiled step."""
    from kirag_tpu_torch.kernels import launch_counts, reset_launch_counts
    from kirag_tpu_torch.training import AlignerTrainer, TrainerConfig

    batch = train_batch(TRAIN_QUERIES, np.random.RandomState(SEED + 12), padded=False)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    flops = step_flops(model.config)
    n_layers, heads = model.config.num_hidden_layers, model.config.num_attention_heads
    dev = next(model.parameters()).device
    # the packed step's one encoder pass: the query rows, then the docs,
    # DOCS_PER_QUERY of TRAIN_D_LEN tokens to a row
    n_docs = TRAIN_QUERIES * DOCS_PER_QUERY * TRAIN_D_LEN // TRAIN_Q_LEN
    shape = [TRAIN_QUERIES + n_docs, heads, TRAIN_Q_LEN, 64]
    seg = torch.cat([bwd_segments("all real", TRAIN_QUERIES, TRAIN_Q_LEN, dev),
                     bwd_segments("packed docs", n_docs, TRAIN_Q_LEN, dev)])
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    q, k, v, do, _, lse, di = bwd_inputs(shape, torch.bfloat16, seg, gen, dev)
    packed_bwd_ms = bwd_kernel_ms(q, k, v, seg, lse, di, do)
    del q, k, v, do, lse, di
    log(f"  [{power}] K3 backward bf16 {shape}, the packed step's queries and docs (tile "
        f"pairs skipped {tile_pairs_skipped(seg):.3f} of all): dK/dV {packed_bwd_ms[0]:.4f} "
        f"ms, dQ {packed_bwd_ms[1]:.4f} ms (CUDA events, median of 10)")
    out = {}
    for packed in (False, True):
        for remat in (False, True, "dots"):
            label = f"{'packed' if packed else 'two-call'}, remat {remat}"
            model.load_state_dict(init)
            trainer = AlignerTrainer(
                model, TrainerConfig(max_steps=10_000, save_dir=str(work / "timing")), [batch],
                compute_dtype=torch.bfloat16, remat=remat, packed=packed)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            losses, secs = [], []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                losses.append(trainer.training_step(batch)["loss"])  # ends on the host
                secs.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            # each layer's backward launches both kernels once: on the query
            # batch (two-call; its 64-token docs take the XLA-style path) or on
            # the packed queries and docs
            counts = launch_counts()
            for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
                if counts[name] != n_layers * TRAIN_STEPS:
                    raise AssertionError(f"{label}: {counts[name]} {name} launches in "
                                         f"{TRAIN_STEPS} steps, expected {n_layers} a step")
            bwd_ms = n_layers * sum(packed_bwd_ms if packed else query_bwd_ms)
            if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
                raise AssertionError(f"{label}: the loss did not fall: {losses}")
            step_ms = statistics.median(secs[1:]) * 1e3
            r = {"step_ms": step_ms, "peak_gb": peak / 1e9, "losses": losses,
                 "tflops": flops / step_ms / 1e9, "mfu": flops / (step_ms / 1e3) / BF16_FLOP_S,
                 "bwd_kernel_ms": bwd_ms}
            if not packed:
                r["profile"] = profile_train_step(trainer, batch, label, step_ms, power)
            out[(packed, remat)] = r
            log(f"  [{power}] {label}: {step_ms:.1f} ms per step (median of steps 2-"
                f"{TRAIN_STEPS}, host clock to the loss on the host), peak memory "
                f"{r['peak_gb']:.2f} GB; {r['tflops']:.1f} TFLOP/s of model FLOPs "
                f"({flops / 1e12:.2f} TFLOP a step), {100 * r['mfu']:.1f}% of 989 TFLOP/s; "
                f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {TRAIN_STEPS} steps; K3's "
                f"backward kernels {n_layers} launches each a step x their CUDA-event times = "
                f"{bwd_ms:.2f} ms of the step ({100 * bwd_ms / step_ms:.1f}%)")
            del trainer
            torch.cuda.empty_cache()
    model.load_state_dict(init)
    return out


def aligner_training(work: Path, built: dict, dev, gen, power) -> dict:
    """Phase 10, the Aligner's contrastive training at E5-large width: (a)
    K3's backward kernels against their plain version, (b) a training step's
    gradients through the kernels against the plain K3 and across the remat
    modes, (c) the train_aligner CLI end to end, (d) step times."""
    from kirag_tpu_torch.models import load_encoder

    flash_bwd = check_flash_bwd(dev, gen, power)
    model = load_encoder(str(built["model_dir"]), "e5", device=dev).model  # f32 weights
    grads = check_train_grads(model, dev)
    cli = train_cli(work, built["model_dir"], dev, power)
    query = flash_bwd[(torch.bfloat16, TRAIN_Q_LEN, "all real")]
    timing = train_timing(work, model, power, (query["dkv_ms"], query["dq_ms"]))
    del model
    torch.cuda.empty_cache()
    return {"flash_bwd": flash_bwd, "grads": grads, "cli": cli, "timing": timing,
            "launches": cli["launches"], "launches_f32": grads["launches_f32"]}


# ---------------------------------------------------------------- phase 11

# the compressed index at the deployment it exists for: the DPR Wikipedia
# corpus (psgs_w100, 21,015,324 passages) at E5-large's 1024 dims, which is
# 86 GB in float32 and 11.4 GB (int4) or 21.6 GB (int8) compressed
QUANTS = ("int8", "int4")
DPR_ROWS = 21_015_324
GEN_BLOCK = CHECK_ROWS        # rows made (and quantized) at a time
DPR_QUERIES = (8, 32, 256)
DPR_SELF = 32                 # queries that are stored rows (self-hits); the rest lie near one
DPR_REPS = {8: 10, 32: 5, 256: 3}
CAPTURE_OUTPUTS = ("gmax", "capture", "gids", "capmax", "resid")


def quantized_corpus(quant: str, n: int, gen, dev, integer: bool, d: int = 0):
    """``(codes, scales)`` of n rows of depth d (default DIM): integer data
    (random codes, power-of-two scales, so every score is exact in any
    summation order), or seeded unit rows quantized on the card."""
    from kirag_tpu_torch.ops import quantize_rows_int4_torch, quantize_rows_int8_torch

    d = d or DIM
    if not integer:
        quantize = quantize_rows_int8_torch if quant == "int8" else quantize_rows_int4_torch
        return quantize(unit_rows(n, gen, dev, d))
    if quant == "int8":
        codes = torch.randint(-127, 128, (n, d), generator=gen, device=dev).to(torch.int8)
        shape = (n,)
    else:
        codes = torch.randint(0, 256, (n, d // 2), generator=gen, device=dev).to(torch.uint8)
        shape = (n, d // 128)
    scales = torch.exp2(torch.randint(-9, -2, shape, generator=gen, device=dev).float())
    return codes, scales


def check_quantized_kernels(dev, gen, err) -> None:
    """Phase 11 (a): K1 and K2 with K4's int8 and int4 scoring against their
    plain versions at phase 3's geometry, Q = 8, 16, 32. On integer data
    (small-integer queries, exact in bf16) every output of K1, K2 and the
    search is bitwise the plain version's, and K1's captured groups bitwise
    K2's re-scores of them; on random unit rows quantized on the card,
    within ATOL, ids equal but at near-ties (largest errors into ``err``)."""
    from kirag_tpu_torch.kernels import (gather_groups, gather_groups_plain, stream_capture,
                                         stream_capture_plain)
    from kirag_tpu_torch.ops import exact_topk_mips, hier_topk
    from kirag_tpu_torch.ops.exact import _capture_budget

    n, valid = CHECK_ROWS, CHECK_ROWS - 1000
    b = _capture_budget(K, n // CHUNK, CHUNK // 128)
    for quant in QUANTS:
        k1, k2 = kernel_names(quant)
        for data in ("integer", "random"):
            c, s = quantized_corpus(quant, n, gen, dev, data == "integer")
            for n_q in (8, 16, 32):
                what = f"{data} {quant} Q={n_q}"
                if data == "integer":
                    q = torch.randint(-2, 3, (n_q, DIM), generator=gen, device=dev).float()
                else:
                    q = unit_rows(n_q, gen, dev)
                got = stream_capture(q, c, valid, CHUNK, b, s, quant)
                want = stream_capture_plain(q, c, valid, CHUNK, b, s, quant)
                gsel = torch.sort(hier_topk(got[0].reshape(-1, n_q).T, K)[1], dim=-1).values
                cand = gather_groups(q, c, gsel, s, quant)
                cand_plain = gather_groups_plain(q, c, gsel, s, quant)
                res = exact_topk_mips(q, c, K, chunk_size=CHUNK, valid_rows=valid,
                                      on_miss="flag", scales=s, **CAPDOM)
                ref = exact_topk_mips(q, c, K, chunk_size=CHUNK, valid_rows=valid,
                                      on_miss="flag", plain=True, scales=s, **CAPDOM)
                torch.cuda.synchronize()
                if data == "integer":
                    for name, x, y in zip(CAPTURE_OUTPUTS, got, want):
                        if not torch.equal(x, y):
                            raise AssertionError(f"{what}: K1 {name} differs from plain")
                    if not torch.equal(cand, cand_plain):
                        raise AssertionError(f"{what}: K2 differs from plain")
                    captured = got[2].permute(2, 0, 1).reshape(n_q, -1)      # [Q, C * b]
                    rescored = gather_groups(q, c, captured, s, quant)
                    if not torch.equal(rescored.view(n_q, -1, b, 128).transpose(0, 1),
                                       got[1].view(-1, n_q, b, 128)):
                        raise AssertionError(f"{what}: K1's captures differ from K2's "
                                             "re-scores of the same groups")
                    for x, y in zip(res, ref):
                        if not torch.equal(x, y):
                            raise AssertionError(f"{what}: exact search differs from plain")
                    log(f"  {what}: K1 5/5 outputs and K2 bitwise equal to plain, K1's "
                        f"{captured.numel()} captured groups bitwise equal to K2's re-scores; "
                        f"search bitwise equal, ok={bool(res[2])}")
                    continue
                k1_err, swapped = capture_error(got, want, what)
                k2_err = gather_error(cand, cand_plain, what)
                check_topk_close(res[0], res[1], ref[0], ref[1], f"{what} search")
                err[k1] = max(err.get(k1, 0.0), k1_err)
                err[k2] = max(err.get(k2, 0.0), k2_err)
                log(f"  {what}: K1 max abs err {k1_err:.3g} ({swapped} gids differ at "
                    f"near-ties), K2 max abs err {k2_err:.3g}, search ok="
                    f"{bool(res[2])}/{bool(ref[2])}")
            del c, s


MMA_ORDER_CASES = (("int8", 1024), ("int4", 1024), ("int4", 2048))
MMA_ORDER_QUERIES = (8, 32)
QUANT_KERNELS = {  # a call's device kernels, given bf16 queries and int32 group ids
    "stream_capture": ("capture_sweep_kernel", "peel_capture_kernel"),
    "gather_groups": ("gather_mma_kernel",), "group_max": ("group_max_sweep_kernel",),
    "score_gmax": ("score_sweep_kernel",)}


def mma_probe(quant: str, d: int, gen, dev) -> dict:
    """The mma order's position check: one (row, query) pair of seeded unit
    data (the row quantized on the card) at each of the 32 x 8 places of a
    probe tile (two m16 A tiles, one n8 B tile), every other row and query
    random and different in each of the 256 tiles; the pair's score must be
    the same bits at every place, and the tile within ATOL of the plain
    version. Returns the pair's score and the largest error."""
    from kirag_tpu_torch.kernels.exact import score_probe, score_probe_plain
    from kirag_tpu_torch.ops import quantize_rows_int4_torch, quantize_rows_int8_torch

    quantize = quantize_rows_int8_torch if quant == "int8" else quantize_rows_int4_torch
    tiles = 32 * 8
    codes, scales = quantize(unit_rows(tiles * 32, gen, dev, d))
    codes = codes.view(tiles, 32, -1).clone()
    scales = scales.view(tiles, 32, *scales.shape[1:]).clone()
    queries = unit_rows(tiles * 8, gen, dev, d).view(tiles, 8, d)
    t = torch.arange(tiles, device=dev)
    m_of, n_of = t // 8, t % 8
    row, row_scale, query = codes[0, 0].clone(), scales[0, 0].clone(), queries[0, 0].clone()
    codes[t, m_of], scales[t, m_of], queries[t, n_of] = row, row_scale, query
    out = score_probe(codes, scales, queries, quant)
    err = float((out - score_probe_plain(codes, scales, queries, quant)).abs().max())
    pair = out[t, m_of, n_of]
    if not torch.equal(pair, pair[:1].expand(tiles)):
        raise AssertionError(f"{quant} D={d}: the mma order's score of one (row, query) pair "
                             f"depends on its place in the fragments: {pair.unique().tolist()}")
    if not err <= ATOL:
        raise AssertionError(f"{quant} D={d}: the probe differs from plain by {err}")
    return {"pair": float(pair[0]), "err": err}


def check_mma_order(dev, gen, err) -> dict:
    """Phase 11 (a), the int8/int4 mma order across kernels: for int8 at D =
    1024 and int4 at D = 1024 and 2048, the position probe (:func:`mma_probe`),
    then on CHECK_ROWS seeded unit rows quantized on the card (sums round, so
    no tie hides a difference) at Q = 8 and 32: K1's captures bitwise K2's
    re-scores of the captured groups, K7a's maxima bitwise K1's, K5's W = 1
    values bitwise K1's unmasked maxima; then each wrapper's device kernels
    a call, counted in a fresh process (:func:`quant_kernels_in_a_fresh_process`)."""
    from kirag_tpu_torch.kernels import gather_groups, group_max, score_gmax, stream_capture
    from kirag_tpu_torch.ops.exact import _capture_budget

    n, valid = CHECK_ROWS, CHECK_ROWS - 1000
    n_c = n // CHUNK
    b = _capture_budget(K, n_c, CHUNK // 128)
    out = {"probe": {}}
    for quant, d in MMA_ORDER_CASES:
        probe = mma_probe(quant, d, gen, dev)
        c, s = quantized_corpus(quant, n, gen, dev, False, d)
        for n_q in MMA_ORDER_QUERIES:
            what = f"random {quant} D={d} Q={n_q}"
            q = unit_rows(n_q, gen, dev, d)
            gmax, capture, gids = stream_capture(q, c, valid, CHUNK, b, s, quant)[:3]
            gsel = gids.permute(2, 0, 1).reshape(n_q, -1)
            rescored = gather_groups(q, c, gsel, s, quant)
            k7 = score_gmax(q, c, valid, CHUNK, "none", s, quant)[1]
            unmasked = stream_capture(q, c, n, CHUNK, b, s, quant)[0]
            k5 = group_max(q, c, 1, s, quant)[0][:, 0]
            torch.cuda.synchronize()
            if not torch.equal(rescored, capture.view(n_c, n_q, b, 128).transpose(0, 1)
                               .reshape(n_q, -1, 128)):
                raise AssertionError(f"{what}: K1's captures differ from K2's re-scores")
            if not torch.equal(k7, gmax):
                raise AssertionError(f"{what}: K7a's maxima differ from K1's")
            if not torch.equal(k5, unmasked.reshape(-1, n_q).T):
                raise AssertionError(f"{what}: K5's W=1 values differ from K1's maxima")
            log(f"  {what}: K1's {gsel.numel()} captured groups bitwise K2's re-scores, K7a's "
                f"maxima bitwise K1's, K5's W=1 values bitwise K1's unmasked maxima")
        log(f"  {quant} D={d}: one (row, query) pair at all 256 places of the mma fragments "
            f"scores {probe['pair']!r} at each, bitwise; probe within {probe['err']:.3g} of "
            "plain")
        out["probe"][(quant, d)] = probe
        del c, s
    out["kernels"] = quant_kernels_in_a_fresh_process()
    return out


def quant_kernels_a_call(device: str = "cuda") -> None:
    """The device kernels of one int8, int4 and pq4 (m = PQ_M) call of K1,
    K2, K5 (not pq4) and K7a (torch.profiler), run in a process of its own
    (:func:`quant_kernels_in_a_fresh_process`, as phase 15 (a)'s count of
    K7b and K8): 16 chunks of seeded codes, Q = 8, the queries bf16 and the
    group ids int32 (so no wrapper casts them). Prints one JSON line
    {"<wrapper>_<quant>": [kernel names]}; fails unless each call's kernels
    are its QUANT_KERNELS, in order."""
    from kirag_tpu_torch.kernels import gather_groups, group_max, score_gmax, stream_capture
    from kirag_tpu_torch.ops import hier_topk

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n, n_q, b = 16 * CHUNK, 8, 8
    out = {}
    for quant in (*QUANTS, "pq4"):
        if quant == "pq4":
            c, s = pq_corpus(PQ_M, n, gen, dev, True)
        else:
            c, s = quantized_corpus(quant, n, gen, dev, True)
        q = unit_rows(n_q, gen, dev).to(torch.bfloat16)
        gmax = stream_capture(q, c, n, CHUNK, b, s, quant)[0]
        gsel = torch.sort(hier_topk(gmax.reshape(-1, n_q).T, K)[1], dim=-1).values.to(torch.int32)
        calls = {"stream_capture": lambda: stream_capture(q, c, n, CHUNK, b, s, quant),
                 "gather_groups": lambda: gather_groups(q, c, gsel, s, quant),
                 "group_max": lambda: group_max(q, c, 1, s, quant),
                 "score_gmax": lambda: score_gmax(q, c, n, CHUNK, "chunk", s, quant)}
        if quant == "pq4":  # approximate search on PQ serves the exact search (no K5)
            del calls["group_max"]
        for name, fn in calls.items():
            for _ in range(3):  # a window that saw no kernel (its records lost) is profiled again
                kernels = device_kernels(fn)
                if kernels:
                    break
            want = QUANT_KERNELS[name]
            if len(kernels) != len(want) or any(w not in k for w, k in zip(want, kernels)):
                raise AssertionError(f"{name} {quant}: one call started {kernels} "
                                     f"(torch.profiler), not {want}")
            out[f"{name}_{quant}"] = kernels
    print(json.dumps(out), flush=True)


def quant_kernels_in_a_fresh_process() -> dict:
    """:func:`quant_kernels_a_call` in a child Python process (the library
    is built already), waited for: its JSON line, or an AssertionError with
    its error output."""
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.quant_kernels_a_call()"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError("the count of the int8/int4/pq4 kernels' device kernels failed:\n"
                             + proc.stderr[-3000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    log("  device kernels of one call (torch.profiler, a fresh process, Q=8): " + "; ".join(
        f"{name} {kernels}" for name, kernels in out.items()))
    return out


def serve_compressed(dev, encoder, collator, host_rows, texts, text_rows, gen, power, err):
    """Phase 11 (b): the retrieval server over phase 4's 1,000,000 host rows
    as int8 and int4 indexes, quantized on the card by ``to_device``; then K1
    and K2 against their plain versions on each index, and their times."""
    from kirag_tpu_torch.index import TorchIndexer

    served = {}
    for quant in QUANTS:
        label = f"{quant} index"
        index = TorchIndexer(DIM, device=dev, compression=quant, pallas_chunk_size=CHUNK)
        index.index_data(list(range(len(host_rows))), host_rows)
        t0 = time.perf_counter()
        index.to_device()
        torch.cuda.synchronize()
        log(f"  {label}: {len(host_rows)} rows quantized on the card by to_device in "
            f"{time.perf_counter() - t0:.2f} s (host clock, copies included): "
            f"{nbytes(index._device_corpus, index._device_scales) / 1e9:.3f} GB on the card")
        served[label] = serve(label, encoder, collator, index, texts, text_rows, power)
        served[label]["timed"] = index_kernels(label, index, gen, power, err,
                                               query_counts=(8, 16, 32, 256))
        del index
        torch.cuda.empty_cache()
    return served


def quantized_cli(work: Path, built: dict, dev) -> dict:
    """Phase 11 (c): ``build_index --compression int4`` (and int8) over phase
    6's shards. ``TorchIndexer.deserialize_from`` reads the compression back
    from the config and quantizes the shards on the card, bitwise as the
    numpy quantizer does; 64 stored rows are searched, the result held
    against the plain search over the same codes, and the self-hits counted
    (the seeded encoder's passages lie within cosine 0.999 of each other,
    closer than int4's score noise, so a row need not win over its
    neighbours)."""
    from kirag_tpu_torch.cli import build_index
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.kernels import reset_launch_counts
    from kirag_tpu_torch.ops import exact_topk_mips, quantize_rows_int4, quantize_rows_int8

    stored, ids = built["stored"], built["ids"]
    row_of = {pid: i for i, pid in enumerate(ids)}
    rows = np.sort(np.random.RandomState(SEED + 11).choice(len(ids), 64, replace=False))
    out = {}
    for quant in ("int4", "int8"):
        reset_launch_counts()
        t0 = time.perf_counter()
        index_dir = build_index.main(["--embeddings_dir", built["shard_dir"], "--embedding_size",
                                      str(DIM), "--compression", quant, "--save_dir",
                                      str(work / f"index_{quant}")], device=dev)
        cfg = json.loads((Path(index_dir) / "index_config.json").read_text())
        index = TorchIndexer(DIM, device=dev)
        index.deserialize_from(index_dir)
        found = index.search_knn(stored[rows], top_docs=10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = main_path_counts()
        codes, scales, n = index._device_corpus, index._device_scales, len(stored)
        want = (quantize_rows_int8 if quant == "int8" else quantize_rows_int4)(stored)
        if not (cfg["compression"] == index.compression == quant
                and np.array_equal(codes[:n].cpu().numpy(), want[0])
                and np.array_equal(scales[:n].cpu().numpy(), want[1])
                and counts[kernel_names(quant)[0]] > 0):
            raise AssertionError(f"{quant}: config {cfg['compression']}, index "
                                 f"{index.compression}, codes or scales unlike numpy's, or "
                                 f"launches {counts}")
        ref_vals, ref_idx = exact_topk_mips(
            torch.from_numpy(stored[rows]).to(dev), codes, 10, chunk_size=index.pallas_chunk_size,
            valid_rows=n, plain=True, scales=scales, **CAPDOM)
        check_topk_close(torch.tensor(np.stack([s for _, s in found])),
                         torch.tensor([[row_of[i] for i in db_ids] for db_ids, _ in found]),
                         ref_vals, ref_idx, f"{quant} built index")
        top1 = sum(db_ids[0] == ids[r] for r, (db_ids, _) in zip(rows, found))
        top10 = sum(ids[r] in db_ids for r, (db_ids, _) in zip(rows, found))
        log(f"  build_index --compression {quant} -> config compression {cfg['compression']!r}; "
            f"reloaded as {tuple(codes.shape)} {codes.dtype} + scales {tuple(scales.shape)}, "
            f"bitwise the numpy quantizer's; 64 stored rows searched: the plain search's "
            f"result; {top1}/64 found themselves at top-1, {top10}/64 in the top 10; "
            f"{wall:.2f} s; launches { {k: v for k, v in counts.items() if v} }")
        out[quant] = {"launches": counts, "top1": top1, "top10": top10}
        del index, codes, scales
    return out


def dpr_block(i: int, n: int, dev) -> torch.Tensor:
    """Block i of the seeded DPR-scale corpus: n unit rows from a generator
    seeded by the block's number, so that any block can be made again."""
    return unit_rows(n, torch.Generator(device=dev).manual_seed(SEED + 1000 + i), dev)


def dpr_corpus(quant: str, dev, sample: torch.Tensor, on_block=None):
    """The DPR-scale corpus made and quantized block by block on the card
    (its first block held bitwise against the numpy quantizer), padded to
    the chunk grid with zero codes and zero scales as the indexer pads.
    Returns ``(codes, scales, rows at sample)``; ``on_block(start, rows)``
    sees each float32 block."""
    from kirag_tpu_torch.ops import (quantize_rows_int4, quantize_rows_int4_torch,
                                     quantize_rows_int8, quantize_rows_int8_torch)

    n_pad = -(-DPR_ROWS // CHUNK) * CHUNK
    if quant == "int8":
        quantize, quantize_np = quantize_rows_int8_torch, quantize_rows_int8
        codes = torch.zeros((n_pad, DIM), dtype=torch.int8, device=dev)
        scales = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
    else:
        quantize, quantize_np = quantize_rows_int4_torch, quantize_rows_int4
        codes = torch.zeros((n_pad, DIM // 2), dtype=torch.uint8, device=dev)
        scales = torch.zeros((n_pad, DIM // 128), dtype=torch.float32, device=dev)
    picked = torch.empty((len(sample), DIM), device=dev)
    for i, start in enumerate(range(0, DPR_ROWS, GEN_BLOCK)):
        rows = dpr_block(i, min(GEN_BLOCK, DPR_ROWS - start), dev)
        block = slice(start, start + len(rows))
        codes[block], scales[block] = quantize(rows)
        if i == 0:
            want = quantize_np(rows.cpu().numpy())
            if not (np.array_equal(codes[block].cpu().numpy(), want[0])
                    and np.array_equal(scales[block].cpu().numpy(), want[1])):
                raise AssertionError(f"{quant}: the card's quantizer differs from numpy's on "
                                     "the first block")
        inside = (sample >= start) & (sample < start + len(rows))
        picked[inside] = rows[sample[inside] - start]
        if on_block is not None:
            on_block(start, rows)
    return codes, scales, picked


def dpr_search(quant: str, codes, scales, queries, sample, power, err) -> dict:
    """Phase 11 (d) for one corpus: the search the indexer runs (flag mode,
    re-dispatched on a False flag) at Q = 8, 32, 256, the self-hits of the
    stored rows, the results of a query the same at every Q; K1 and K2
    timed at each Q, their plain versions at Q = 8, where the search is also
    held against the plain search."""
    from kirag_tpu_torch.kernels import (gather_groups, gather_groups_plain,
                                         reset_launch_counts, stream_capture,
                                         stream_capture_plain)
    from kirag_tpu_torch.ops import exact_topk_mips, hier_topk
    from kirag_tpu_torch.ops.exact import _capture_budget

    k1, k2 = kernel_names(quant)
    b = _capture_budget(K, len(codes) // CHUNK, CHUNK // 128)
    search = dict(chunk_size=CHUNK, valid_rows=DPR_ROWS, scales=scales, quant=quant, **CAPDOM)
    reset_launch_counts()
    t0 = time.perf_counter()
    results, redispatched = {}, 0
    for n_q in DPR_QUERIES:
        vals, idx, ok = exact_topk_mips(queries[:n_q], codes, K, on_miss="flag", **search)
        if not bool(ok):
            redispatched += 1
            vals, idx = exact_topk_mips(queries[:n_q], codes, K, **search)
        results[n_q] = (vals, idx)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = main_path_counts()
    vals, idx = results[DPR_QUERIES[-1]]
    if not torch.equal(idx[:DPR_SELF, 0], sample[:DPR_SELF]):
        raise AssertionError(f"{quant}: a stored row did not find itself at top-1")
    for n_q in DPR_QUERIES[:-1]:
        if not (torch.equal(results[n_q][0], vals[:n_q])
                and torch.equal(results[n_q][1], idx[:n_q])):
            raise AssertionError(f"{quant}: Q={n_q} answers differ from the same queries' "
                                 f"answers at Q={DPR_QUERIES[-1]}")
    if not (torch.isfinite(vals).all() and launches[k1] > 0):
        raise AssertionError(f"{quant}: non-finite scores or K1 not launched: {launches}")
    log(f"  {quant} search (flag mode, as the indexer runs it), Q = {DPR_QUERIES}: "
        f"{search_s:.2f} s in all (host clock), {redispatched} re-dispatched; "
        f"{DPR_SELF} stored rows found themselves at top-1 (self-score within "
        f"{float((vals[:DPR_SELF, 0] - 1).abs().max()):.4f} of 1); each query's answer the "
        f"same at every Q; launches {k1} {launches[k1]}, {k2} {launches[k2]}")
    times = {}
    for n_q in DPR_QUERIES:
        q, reps, what = queries[:n_q], DPR_REPS[n_q], f"{quant} {DPR_ROWS} x {DIM} Q={n_q}"
        got = stream_capture(q, codes, DPR_ROWS, CHUNK, b, scales, quant)
        gsel = torch.sort(hier_topk(got[0].reshape(-1, n_q).T, K)[1], dim=-1).values
        cand = gather_groups(q, codes, gsel, scales, quant)
        t = {"k1_ms": cuda_ms(lambda: stream_capture(q, codes, DPR_ROWS, CHUNK, b, scales,
                                                       quant), reps=reps),
             "k2_ms": cuda_ms(lambda: gather_groups(q, codes, gsel, scales, quant), reps=reps),
             "k1_bound": search_bound(q, codes, scales, quant, got),
             "k2_bound": gather_bound(q, codes, scales, quant, gsel, cand)}
        if n_q == DPR_QUERIES[0]:
            k1_err, swapped = capture_error(
                got, stream_capture_plain(q, codes, DPR_ROWS, CHUNK, b, scales, quant), what)
            k2_err = gather_error(cand, gather_groups_plain(q, codes, gsel, scales, quant), what)
            ref = exact_topk_mips(q, codes, K, plain=True, **search)
            check_topk_close(results[n_q][0], results[n_q][1], ref[0], ref[1], f"{what} search")
            err[k1], err[k2] = max(err.get(k1, 0.0), k1_err), max(err.get(k2, 0.0), k2_err)
            t["k1_plain_ms"] = cuda_ms(lambda: stream_capture_plain(
                q, codes, DPR_ROWS, CHUNK, b, scales, quant), reps=3)
            t["k2_plain_ms"] = cuda_ms(
                lambda: gather_groups_plain(q, codes, gsel, scales, quant), reps=3)
            log(f"  {what}: K1 max abs err {k1_err:.3g} against plain ({swapped} gids differ "
                f"at near-ties), K2 {k2_err:.3g}; the search matches the plain search")
        del got, cand
        times[n_q] = t
        plain = (f" vs plain {t['k1_plain_ms']:.3f} ms" if "k1_plain_ms" in t else "")
        plain2 = (f" vs plain {t['k2_plain_ms']:.3f} ms" if "k2_plain_ms" in t else "")
        log(f"  [{power}] {what}, capture {b} of {CHUNK // 128} groups per chunk: K1 "
            f"{t['k1_ms']:.3f} ms{plain} (bound {t['k1_bound'][0]:.3f} ms, "
            f"{t['k1_bound'][1]}); K2 {t['k2_ms']:.3f} ms{plain2} (bound "
            f"{t['k2_bound'][0]:.3f} ms, {t['k2_bound'][1]}) (CUDA events, median of {reps})")
    return {"idx": idx.cpu().numpy(), "idx_t": idx.cpu(), "vals": vals, "times": times,
            "launches": launches, "search_s": search_s, "redispatched": redispatched}


def dpr_scale(dev, power, err) -> tuple:
    """Phase 11 (d): the DPR corpus's 21,015,324 x 1024 seeded unit rows,
    quantized on the card block by block, int4 then int8 (each freed before
    the next): the indexer's search at Q = 8, 32, 256, and recall@10/@100
    against the exact float32 top-100, whose rows are made again from the
    seed block by block on the card while the int8 corpus is built. Queries:
    DPR_SELF stored rows, then stored rows with noise of their own norm
    added (cosine about 0.7 to the row). Returns the results by format and
    ``{"queries", "sample", "exact"}`` (the float32 top-100 ids) for phase
    14 (d)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    n_queries = DPR_QUERIES[-1]
    sample = torch.randperm(DPR_ROWS, generator=gen, device=dev)[:n_queries]
    out = {}
    t0 = time.perf_counter()
    codes, scales, picked = dpr_corpus("int4", dev, sample)
    torch.cuda.synchronize()
    noise = torch.nn.functional.normalize(
        torch.randn(n_queries, DIM, generator=gen, device=dev), dim=-1)
    queries = torch.nn.functional.normalize(picked + noise, dim=-1)
    queries[:DPR_SELF] = picked[:DPR_SELF]
    log(f"  int4: {DPR_ROWS} rows made and quantized on the card in "
        f"{time.perf_counter() - t0:.2f} s, first block bitwise equal to numpy's quantizer; "
        f"{nbytes(codes, scales) / 1e9:.3f} GB (codes {nbytes(codes) / 1e9:.3f} + scales "
        f"{nbytes(scales) / 1e9:.3f}), peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    out["int4"] = dpr_search("int4", codes, scales, queries, sample, power, err)
    out["int4"]["gb"] = nbytes(codes, scales) / 1e9
    log("  phase 12 (d): the approximate search over the resident int4 codes")
    out["int4"]["approx"] = dpr_approx("int4", codes, scales, queries, sample,
                                       out["int4"]["idx"], power, err)
    log("  phase 15 (d): the exact-search variants over the resident int4 codes")
    t0 = time.perf_counter()
    out["int4"]["variants"] = dpr_variants(codes, scales, queries, out["int4"], power)
    out["int4"]["variants"]["seconds"] = time.perf_counter() - t0
    del codes, scales
    torch.cuda.empty_cache()

    top_vals = torch.full((n_queries, K), float("-inf"), device=dev)
    top_idx = torch.zeros((n_queries, K), dtype=torch.int64, device=dev)

    def exact_top(start, rows):  # the float32 top-K over the blocks seen so far
        nonlocal top_vals, top_idx
        vals, idx = torch.topk(queries @ rows.T, K, dim=-1)
        both_vals = torch.cat([top_vals, vals], dim=-1)
        both_idx = torch.cat([top_idx, idx + start], dim=-1)
        top_vals, pos = torch.topk(both_vals, K, dim=-1)
        top_idx = torch.gather(both_idx, 1, pos)

    t0 = time.perf_counter()
    codes, scales, again = dpr_corpus("int8", dev, sample, exact_top)
    torch.cuda.synchronize()
    if not torch.equal(again, picked):
        raise AssertionError("the DPR-scale rows made again from the seed differ")
    log(f"  int8: {DPR_ROWS} rows made again and quantized on the card, with the float32 "
        f"top-{K} of the {n_queries} queries, in {time.perf_counter() - t0:.2f} s; "
        f"{nbytes(codes, scales) / 1e9:.3f} GB (codes {nbytes(codes) / 1e9:.3f} + scales "
        f"{nbytes(scales) / 1e9:.3f})")
    out["int8"] = dpr_search("int8", codes, scales, queries, sample, power, err)
    out["int8"]["gb"] = nbytes(codes, scales) / 1e9
    log("  phase 12 (d): the approximate search over the resident int8 codes")
    out["int8"]["approx"] = dpr_approx("int8", codes, scales, queries, sample,
                                       out["int8"]["idx"], power, err)
    del codes, scales
    torch.cuda.empty_cache()
    exact = top_idx.cpu().numpy()
    if not np.array_equal(exact[:DPR_SELF, 0], sample[:DPR_SELF].cpu().numpy()):
        raise AssertionError("float32: a stored row is not its own top-1")
    for quant in ("int4", "int8"):
        r = {k: recall(out[quant]["idx"], exact, k) for k in (10, K)}
        out[quant]["recall"] = r
        log(f"  {quant}: recall@10 {r[10]:.4f}, recall@{K} {r[K]:.4f} against the exact "
            f"float32 top-{K} ({n_queries} queries; {DPR_SELF} stored rows, the rest near one)")
        approx = out[quant]["approx"]
        approx["recall_f32"] = {w: {k: recall(idx, exact, k) for k in (10, K)}
                                for w, idx in approx["idx"].items()}
        log(f"  {quant} approx: recall against the exact float32 top-{K}: " + "; ".join(
            f"W={w} @10 {r[10]:.4f}, @{K} {r[K]:.4f}" for w, r in approx["recall_f32"].items()))
    return out, {"queries": queries, "sample": sample, "exact": exact}


# ---------------------------------------------------------------- phase 12

# the approximate search (K5) at the main path's shapes: the query counts the
# served batches are padded to, the winners a group that the tests use (128
# is exact search), and the int4 depths that an l2 index (D + 256) and wider
# encoders need, which the card took only up to 1024 before
APPROX_QUERIES = (8, 16, 32)
APPROX_WINNERS = (1, 2, 8, 128)
INT4_DEPTHS = (1280, 2048)
APPROX_REQUESTS = 200  # phase 12 (b)'s traffic per index and W, from 4 threads
FORMATS = ("float32", "bfloat16", "int8", "int4")


def k5_corpus(fmt: str, n: int, gen, dev, integer: bool):
    """``(corpus, scales, quant)`` of n x DIM in one of K5's formats: integer
    data (small integers, or codes with power-of-two scales) or seeded unit
    rows (quantized on the card)."""
    if fmt in QUANTS:
        return (*quantized_corpus(fmt, n, gen, dev, integer), fmt)
    dtype = torch.float32 if fmt == "float32" else torch.bfloat16
    if integer:
        return torch.randint(-3, 4, (n, DIM), generator=gen, device=dev).to(dtype), None, "none"
    return unit_rows(n, gen, dev).to(dtype), None, "none"


def k5_error(got, want, what: str):
    """K5 against its plain version (``want`` peeled one winner further,
    where W < 128): values within ATOL everywhere; lanes equal wherever the
    peeled value stands more than ATOL from the winners before and after it
    (a near-tie that two summation orders may swap). Returns the largest
    difference and the count of swapped lanes."""
    w = got[0].shape[1]
    err = float((got[0] - want[0][:, :w]).abs().max())
    if not err <= ATOL:
        raise AssertionError(f"{what}: K5 differs from plain by {err} > {ATOL}")
    nxt = want[0][:, 1:w + 1]
    if nxt.shape[1] < w:
        nxt = torch.cat([nxt, torch.full_like(want[0][:, :1], float("-inf"))], dim=1)
    gap = want[0][:, :w] - nxt
    clear = gap > ATOL
    clear[:, 1:] &= gap[:, :-1] > ATOL
    differ = got[1] != want[1][:, :w]
    if bool((differ & clear).any()):
        raise AssertionError(f"{what}: K5 peeled another lane than plain away from near-ties")
    return err, int(differ.sum())


def k5_bound(q, corpus, scales, quant: str, outs):
    """K5's bound: the corpus (and its scales) and the queries read once,
    gmax and gidx written once; 2 * Q * N * D operations at the rates of
    :func:`search_bound` (f32 CUDA cores for a float corpus, bf16 for a
    quantized one, as K1's row)."""
    n_q, d = q.shape
    ops_s = F32_FLOP_S if quant == "none" else BF16_FLOP_S
    extra = () if scales is None else (scales,)
    return bound(nbytes(q, corpus, *extra, *outs), 2 * n_q * len(corpus) * d, ops_s)


def check_approx_kernels(dev, gen, err) -> dict:
    """Phase 12 (a): K5 against its plain version at phase 3's CHECK_ROWS x
    DIM, float32, bfloat16, int8 and int4, Q = 8, 16, 32, W = 1, 2, 8, 128.
    Integer data: values and lanes bitwise, and at W = 1 the values bitwise
    K1's group maxima over the same corpus and queries; random data: values
    within ATOL, lanes equal but at near-ties (largest errors into ``err``).
    Then the int4 depths 1280 and 2048: K1, K2, the exact search and K5
    against their plain versions (bitwise on integer data), and K1 timed.
    Returns those times."""
    from kirag_tpu_torch.kernels import (gather_groups, gather_groups_plain, group_max,
                                         group_max_plain, stream_capture, stream_capture_plain)
    from kirag_tpu_torch.ops import exact_topk_mips, hier_topk
    from kirag_tpu_torch.ops.exact import _capture_budget

    n = CHECK_ROWS
    for fmt in FORMATS:
        for data in ("integer", "random"):
            integer = data == "integer"
            c, s, quant = k5_corpus(fmt, n, gen, dev, integer)
            name = k5_name(quant)
            for n_q in APPROX_QUERIES:
                what = f"{data} {fmt} Q={n_q}"
                if integer:
                    q = torch.randint(-2, 3, (n_q, DIM), generator=gen, device=dev).float()
                else:
                    q = unit_rows(n_q, gen, dev)
                if quant == "none":
                    q = q.to(c.dtype)
                k1_gmax = stream_capture(q, c, n, CHUNK, 1, s, quant)[0].reshape(-1, n_q).T
                worst, swapped = 0.0, 0
                for w in APPROX_WINNERS:
                    got = group_max(q, c, w, s, quant)
                    want = group_max_plain(q, c, min(w + 1, 128), s, quant)
                    torch.cuda.synchronize()
                    if integer:
                        if not (torch.equal(got[0], want[0][:, :w])
                                and torch.equal(got[1], want[1][:, :w])):
                            raise AssertionError(f"{what} W={w}: K5 differs from plain")
                    else:
                        e, n_sw = k5_error(got, want, f"{what} W={w}")
                        worst, swapped = max(worst, e), swapped + n_sw
                    # one scoring routine: bitwise K1's maxima, whatever the data
                    if w == 1 and not torch.equal(got[0][:, 0], k1_gmax):
                        raise AssertionError(f"{what}: K5's W=1 values differ from K1's maxima")
                    del got, want
                if integer:
                    log(f"  {what}: K5 values and lanes bitwise equal to plain at W = "
                        f"{APPROX_WINNERS}; W=1 values bitwise K1's group maxima")
                else:
                    err[name] = max(err.get(name, 0.0), worst)
                    log(f"  {what}: K5 max abs err {worst:.3g} against plain at W = "
                        f"{APPROX_WINNERS} ({swapped} lanes differ at near-ties); W=1 values "
                        "bitwise K1's group maxima")
            del c, s

    times = {}
    b = _capture_budget(K, n // CHUNK, CHUNK // 128)
    for d in INT4_DEPTHS:
        for data in ("integer", "random"):
            integer = data == "integer"
            c, s = quantized_corpus("int4", n, gen, dev, integer, d)
            for n_q in (8, 32):
                what = f"{data} int4 D={d} Q={n_q}"
                if integer:
                    q = torch.randint(-2, 3, (n_q, d), generator=gen, device=dev).float()
                else:
                    q = unit_rows(n_q, gen, dev, d)
                got = stream_capture(q, c, n - 1000, CHUNK, b, s, "int4")
                want = stream_capture_plain(q, c, n - 1000, CHUNK, b, s, "int4")
                gsel = torch.sort(hier_topk(got[0].reshape(-1, n_q).T, K)[1], dim=-1).values
                cand = gather_groups(q, c, gsel, s, "int4")
                cand_plain = gather_groups_plain(q, c, gsel, s, "int4")
                res = exact_topk_mips(q, c, K, chunk_size=CHUNK, valid_rows=n - 1000, scales=s,
                                      **CAPDOM)
                ref = exact_topk_mips(q, c, K, chunk_size=CHUNK, valid_rows=n - 1000, scales=s,
                                      plain=True, **CAPDOM)
                k5 = group_max(q, c, 2, s, "int4")
                k5_plain = group_max_plain(q, c, 3, s, "int4")
                torch.cuda.synchronize()
                if integer:
                    same = all(torch.equal(x, y) for x, y in zip(got, want)) and \
                        torch.equal(cand, cand_plain) and \
                        all(torch.equal(x, y) for x, y in zip(res, ref)) and \
                        torch.equal(k5[0], k5_plain[0][:, :2]) and \
                        torch.equal(k5[1], k5_plain[1][:, :2])
                    if not same:
                        raise AssertionError(f"{what}: K1, K2, the search or K5 differ from "
                                             "plain")
                    log(f"  {what}: K1 5/5 outputs, K2, the exact search and K5 (W=2) bitwise "
                        "equal to plain")
                else:
                    k1_err, swapped = capture_error(got, want, what)
                    k2_err = gather_error(cand, cand_plain, what)
                    check_topk_close(res[0], res[1], ref[0], ref[1], f"{what} search")
                    k5_err, _ = k5_error(k5, k5_plain, what)
                    for key, e in (("stream_capture_int4", k1_err),
                                   ("gather_groups_int4", k2_err), ("group_max_int4", k5_err)):
                        err[key] = max(err.get(key, 0.0), e)
                    times[(d, n_q)] = {
                        "k1_ms": cuda_ms(lambda: stream_capture(q, c, n - 1000, CHUNK, b, s,
                                                                "int4")),
                        "k1_plain_ms": cuda_ms(lambda: stream_capture_plain(
                            q, c, n - 1000, CHUNK, b, s, "int4"), reps=3),
                        "k1_bound": search_bound(q, c, s, "int4", got)}
                    t = times[(d, n_q)]
                    log(f"  {what}: K1 max abs err {k1_err:.3g} ({swapped} gids differ at "
                        f"near-ties), K2 {k2_err:.3g}, K5 {k5_err:.3g}; the search matches "
                        f"the plain search; K1 {t['k1_ms']:.3f} ms vs plain "
                        f"{t['k1_plain_ms']:.3f} ms (bound {t['k1_bound'][0]:.3f} ms, "
                        f"{t['k1_bound'][1]}) (CUDA events, median of 10)")
                del got, want, cand, cand_plain, k5, k5_plain
            del c, s
    return times


FLOAT_K5_KERNELS = ("group_max_sweep_kernel",)  # every format's K5


def k5_times(label, corpus, scales, quant: str, queries, gen, power, err,
             query_counts=APPROX_QUERIES, winners=(1, 2), reps=10) -> dict:
    """K5 against its plain version on a served index's group view (its
    rows, its format; ``queries(n_q)`` gives the searched queries), then
    timed with CUDA events, median of ``reps`` (the plain version's of 3),
    each beside its bound. On a float corpus also beside one PyTorch call
    for the same function (:func:`library_group_max`), and the kernels of 10
    calls by torch.profiler at W = 1 and the largest W: one
    ``group_max_sweep_kernel`` a call (a bf16 call adds the queries' cast)."""
    from kirag_tpu_torch.kernels import group_max, group_max_plain

    name = k5_name(quant)
    times = {}
    for n_q in query_counts:
        q = queries(n_q)
        for w in winners:
            what = f"{label} Q={n_q} W={w}"
            got = group_max(q, corpus, w, scales, quant)
            want = group_max_plain(q, corpus, min(w + 1, 128), scales, quant)
            e, swapped = k5_error(got, want, what)
            err[name] = max(err.get(name, 0.0), e)
            t = {"ms": cuda_ms(lambda: group_max(q, corpus, w, scales, quant), reps=reps),
                 "plain_ms": cuda_ms(lambda: group_max_plain(q, corpus, w, scales, quant),
                                     reps=3),
                 "bound": k5_bound(q, corpus, scales, quant, got), "library_ms": None}
            del got, want
            extra = ""
            if quant == "none":
                t["library_ms"] = cuda_ms(lambda: library_group_max(q, corpus, w), reps=reps)
                extra = (f", library ({'max' if w == 1 else 'topk'} over matmul's groups"
                         f"{', bf16 scores' if corpus.dtype == torch.bfloat16 else ''}) "
                         f"{t['library_ms']:.3f} ms")
                if w in (winners[0], winners[-1]):  # 10 calls: at most 10 sweep kernels
                    split = kernels_per_call(lambda: group_max(q, corpus, w), FLOAT_K5_KERNELS)
                    n = split.get(FLOAT_K5_KERNELS[0], [0])[0] if split else 0
                    casts = 10 if q.dtype != torch.float32 else 0  # the queries' cast to f32
                    if split is not None and (not 1 <= n <= 10
                                              or split.get("other", [0])[0] > casts):
                        raise AssertionError(f"{what}: a float K5 call is not one "
                                             f"{FLOAT_K5_KERNELS[0]}: {split}")
                    t["kernels"] = split
                    extra += "; " + kernels_text(split)
            times[(n_q, w)] = t
            log(f"  [{power}] {what}, {len(corpus)} x {q.shape[1]}: K5 {t['ms']:.3f} ms vs "
                f"plain {t['plain_ms']:.3f} ms (bound {t['bound'][0]:.3f} ms, {t['bound'][1]}"
                f"{extra}); max abs err {e:.3g} ({swapped} lanes differ at near-ties) (CUDA "
                f"events, median of {reps})")
    return times


def recall(idx: np.ndarray, exact: np.ndarray, k: int) -> float:
    """Mean over queries of the share of the exact top-k among the top-k."""
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k for a, b in zip(idx, exact)]))


def hits_rows(results) -> np.ndarray:
    """The ids of ``search_knn`` results as an int array [Q, k]."""
    return np.array([[int(i) for i in ids] for ids, _ in results])


def serve_approx(dev, encoder, collator, host_rows, texts, text_rows, text_emb, gen, power,
                 err, exact_served) -> tuple:
    """Phase 12 (b): the server with the retriever's ``search_mode="approx"``
    over phase 4's 1,000,000 rows, as float32 and int4 indexes built with
    ``shuffle_rows=True``, at W = 1 and 2 (APPROX_REQUESTS requests from 4
    threads, then lone requests of 1, 8 and 32 texts); every served batch
    held against the plain search; recall@10/@100 of the texts' searches
    against the exact search over the same index; K5 timed on each index
    (float32 at W = 1, 2, 8, 128 beside ``torch.matmul`` + ``max``/``topk``,
    then a bfloat16 copy of its rows likewise; int4 at W = 1, 2)."""
    from kirag_tpu_torch.index import TorchIndexer

    served, timed, recalls = {}, {}, {}
    perm = np.random.default_rng(SEED).permutation(len(host_rows))
    for quant in ("none", "int4"):
        fmt = "float32" if quant == "none" else "int4"
        index = TorchIndexer(DIM, device=dev, compression=quant, pallas_chunk_size=CHUNK,
                             shuffle_rows=True, shuffle_seed=SEED)
        index.index_data(list(range(len(host_rows))), host_rows)
        t0 = time.perf_counter()
        index.to_device()
        torch.cuda.synchronize()
        if not np.array_equal(index.index_id_to_db_id.astype(np.int64), perm):
            raise AssertionError(f"{fmt}: the shuffled layout is not default_rng's permutation")
        log(f"  {fmt} index: {len(host_rows)} rows shuffled on the host "
            f"(default_rng({SEED}).permutation, checked) and placed in "
            f"{time.perf_counter() - t0:.2f} s (host clock)")
        exact = hits_rows(index.search_knn(text_emb, K))
        for w in (1, 2):
            index.approx_winners = w
            label = f"{fmt} shuffled index, approx W={w}"
            stats = serve(label, encoder, collator, index, texts, text_rows, power,
                          n_requests=APPROX_REQUESTS, mode="approx")
            approx = hits_rows(index.search_knn(text_emb, K, mode="approx"))
            r = {k: recall(approx, exact, k) for k in (10, K)}
            base = exact_served[f"{fmt} index"]
            log(f"  [{power}] {label}: recall@10 {r[10]:.4f}, recall@{K} {r[K]:.4f} against "
                f"the exact search over the same index ({len(texts)} texts); "
                f"{stats['rps']:.2f} requests/s, p50 {stats['p50_ms']:.2f} ms, p95 "
                f"{stats['p95_ms']:.2f} ms, beside the exact {fmt} server's {base['rps']:.2f} "
                f"requests/s, p50 {base['p50_ms']:.2f} ms, p95 {base['p95_ms']:.2f} ms")
            stats["recall"] = r
            served[label] = stats
            recalls[(fmt, w)] = r
        corpus, scales = index._group_view()  # what the search reads

        def queries(n_q, dtype=index.device_dtype):
            return index._search_queries(unit_rows(n_q, gen, dev).to(dtype))

        float_w = APPROX_WINNERS if quant == "none" else (1, 2)
        timed[fmt] = k5_times(f"{fmt} shuffled 1M", corpus, scales, quant, queries, gen, power,
                              err, winners=float_w)
        if quant == "none":  # the same rows as bfloat16 (2 GB), searched with bf16 queries
            c16 = corpus.to(torch.bfloat16)
            timed["bfloat16"] = k5_times(
                "bfloat16 copy of the shuffled 1M", c16, None, quant,
                lambda n_q: queries(n_q, torch.bfloat16), gen, power, err, winners=float_w)
            del c16
        del index, corpus, scales
        torch.cuda.empty_cache()
    return served, timed, recalls


def approx_cli(work: Path, built: dict, decoded: dict, run_a: dict, dev, power) -> dict:
    """Phase 12 (c), run beside phase 9 while its LLM is on the card:
    ``build_index --shuffle_rows --shuffle_seed 3`` over phase 6's shards,
    its layout checked against ``default_rng(3).permutation`` and reloaded;
    ``cli/retrieve --search_mode approx --approx_winners 2`` for one
    question over it with phase 9's LLM (run C, over ``filled_kg_cache``'s
    copy, so that its KG step decodes the held-out documents alone);
    ``cli/retrieval_eval`` over run C's results: answer presence, and
    P/R/F1@10 against run A's exact-search documents as qrels (what the
    approximate search lost)."""
    import pickle

    from kirag_tpu_torch.cli import build_index, retrieval_eval
    from kirag_tpu_torch.cli import retrieve as retrieve_cli
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.kernels import reset_launch_counts

    index_dir = build_index.main(["--embeddings_dir", built["shard_dir"], "--embedding_size",
                                  str(DIM), "--shuffle_rows", "--shuffle_seed", "3",
                                  "--save_dir", str(work / "index_shuffled")], device=dev)
    cfg = json.loads((Path(index_dir) / "index_config.json").read_text())
    perm = np.random.default_rng(3).permutation(len(built["ids"]))
    with open(Path(index_dir) / "index_meta.pkl", "rb") as f:
        meta = pickle.load(f)
    rows = np.concatenate([np.load(Path(index_dir) / name) for name in cfg["files"]])
    if not (meta == [built["ids"][i] for i in perm]
            and np.array_equal(rows, built["stored"][perm])):
        raise AssertionError("build_index --shuffle_rows: the layout is not "
                             "default_rng(3).permutation of the shards")
    index = TorchIndexer(DIM, device=dev, approx_winners=2)
    index.deserialize_from(index_dir)
    picked = np.arange(0, len(meta), len(meta) // 64)[:64]
    found = index.search_knn(rows[picked], top_docs=10, mode="approx")
    top10 = sum(meta[r] in ids for r, (ids, _) in zip(picked, found))
    log(f"  build_index --shuffle_rows --shuffle_seed 3: {len(meta)} rows and ids in "
        f"default_rng(3).permutation's order, {len(cfg['files'])} shard(s); reloaded, 64 stored "
        f"rows searched approximately (W=2): {top10}/64 in their own top 10")
    del index
    questions = json.loads((work / "questions.json").read_text())
    llm = ({**decoded["params"], "layers": decoded["params"]["layers"][:KIRAG_LAYERS]},
           dataclasses.replace(decoded["config"], num_hidden_layers=KIRAG_LAYERS))
    argv = ["--dataset", "hotpotqa", "--query_file", str(work / "questions.json"),
            "--num_queries", "1", "--corpus", "wikipedia", "--corpus_path", str(built["tsv"]),
            "--index_folder", index_dir, "--embedding_size", str(DIM),
            "--search_mode", "approx", "--approx_winners", "2",
            "--retriever_model_name_or_path", str(built["model_dir"]), "--llm",
            "Meta-Llama-3-8B-Instruct", "--llm_quant_bits", "4", "--aligner_model", "e5",
            "--aligner_model_name_or_path", str(built["model_dir"]), "--num_turns",
            str(KIRAG_TURNS), "--topk", "10", "--num_beams", "1", "--save_dir", str(work),
            "--name", "kirag_C", "--save_file", "results.json", "--cached_kg_triples_file",
            str(filled_kg_cache(work, built, "C"))]
    reset_launch_counts()  # run C's launches only, not the reload check's
    t0 = time.perf_counter()
    path = retrieve_cli.main(argv, tokenizer=HashTokenizer(), llm_tokenizer=ByteLevelTokenizer(),
                             aligner_tokenizer=HashTokenizer(), llm=llm)
    wall = time.perf_counter() - t0
    counts = main_path_counts()
    results = json.loads(Path(path).read_text())
    if not (len(results) == 1 and results[0]["ctxs"] and "paths" in results[0]
            and all(c["id"] in set(meta) for c in results[0]["ctxs"])
            and counts["group_max"] > 0 and counts["int4_matmul"] > 0
            and counts["flash_attention"] > 0):
        raise AssertionError(f"run C: results lack ctxs or paths, hold ids outside the index, "
                             f"or a kernel of the path was not launched: {counts}")
    qrels = work / "qrels_run_a.tsv"
    run_a_docs = json.loads(Path(run_a["path"]).read_text())
    qrels.write_text("".join(f"{ex['id']}\t{c['id']}\t1\n" for ex in run_a_docs[:1]
                             for c in ex["ctxs"][:10]))
    vs_exact = retrieval_eval.main(["--dataset", "hotpotqa", "--save_file", path, "--qrels",
                                    str(qrels), "--k", "10"])
    presence = retrieval_eval.main(["--dataset", "nq", "--save_file", path, "--k", "10"])
    log(f"  run C (approx, W=2, over the shuffled index): {wall:.2f} s, "
        f"{len(results[0]['ctxs'])} ctxs, every id in the index; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    log(f"  cli/retrieval_eval of run C: against run A's exact documents as qrels {vs_exact}; "
        f"answer presence {presence}")
    return {"launches": counts, "wall": wall, "vs_exact": vs_exact, "presence": presence}


def dpr_approx(quant: str, codes, scales, queries, sample, same_codes_idx, power, err) -> dict:
    """Phase 12 (d) for one corpus, while its codes are resident: the
    approximate search at Q = 8, 32, 256 and W = 1, 2 (the same answer for a
    query at every Q), the stored rows' self-hits, recall@10/@100 against
    the exact search over the same codes; K5 timed at each Q and W beside its
    bound, its plain version at Q = 8, W = 1."""
    from kirag_tpu_torch.kernels import group_max, group_max_plain
    from kirag_tpu_torch.kernels import reset_launch_counts
    from kirag_tpu_torch.ops import approx_topk_mips

    name = k5_name(quant)
    groups = -(-DPR_ROWS // 128) * 128  # the groups that hold rows, as the indexer's view
    codes, scales = codes[:groups], scales[:groups]
    reset_launch_counts()
    idx_by_w, recalls = {}, {}
    t0 = time.perf_counter()
    for w in (1, 2):
        results = {n_q: approx_topk_mips(queries[:n_q], codes, K, valid_rows=DPR_ROWS,
                                         scales=scales, winners_per_group=w)
                   for n_q in DPR_QUERIES}
        vals, idx = results[DPR_QUERIES[-1]]
        for n_q in DPR_QUERIES[:-1]:
            if not (torch.equal(results[n_q][0], vals[:n_q])
                    and torch.equal(results[n_q][1], idx[:n_q])):
                raise AssertionError(f"{quant} approx W={w}: Q={n_q} answers differ from Q="
                                     f"{DPR_QUERIES[-1]}'s")
        if not torch.equal(idx[:DPR_SELF, 0], sample[:DPR_SELF]):
            raise AssertionError(f"{quant} approx W={w}: a stored row did not find itself")
        idx_by_w[w] = idx.cpu().numpy()
        recalls[w] = {k: recall(idx_by_w[w], same_codes_idx, k) for k in (10, K)}
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches = main_path_counts()
    if launches[name] == 0:
        raise AssertionError(f"{quant}: K5 was not launched: {launches}")
    log(f"  {quant} approx search, W = 1, 2 at Q = {DPR_QUERIES}: {search_s:.2f} s in all "
        f"(host clock); {DPR_SELF} stored rows found themselves; each query's answer the same "
        f"at every Q; recall against the exact search over the same codes: "
        + "; ".join(f"W={w} @10 {r[10]:.4f}, @{K} {r[K]:.4f}" for w, r in recalls.items()))
    times = {}
    for n_q in DPR_QUERIES:
        q, reps = queries[:n_q], DPR_REPS[n_q]
        for w in (1, 2):
            what = f"{quant} {DPR_ROWS} x {DIM} Q={n_q} W={w}"
            got = group_max(q, codes, w, scales, quant)
            t = {"ms": cuda_ms(lambda: group_max(q, codes, w, scales, quant), reps=reps),
                 "bound": k5_bound(q, codes, scales, quant, got)}
            if n_q == DPR_QUERIES[0] and w == 1:
                e, swapped = k5_error(got, group_max_plain(q, codes, 2, scales, quant), what)
                err[name] = max(err.get(name, 0.0), e)
                t["plain_ms"] = cuda_ms(lambda: group_max_plain(q, codes, 1, scales, quant),
                                        reps=3)
                log(f"  {what}: K5 max abs err {e:.3g} against plain ({swapped} lanes differ "
                    "at near-ties)")
            del got
            times[(n_q, w)] = t
            plain = f" vs plain {t['plain_ms']:.3f} ms" if "plain_ms" in t else ""
            log(f"  [{power}] {what}: K5 {t['ms']:.3f} ms{plain} (bound {t['bound'][0]:.3f} ms, "
                f"{t['bound'][1]}) (CUDA events, median of {reps})")
    return {"idx": idx_by_w, "recall_same_codes": recalls, "times": times,
            "launches": launches}


# ---------------------------------------------------------------- phase 13

# the squared distance between a text and its own stored row, at most: f32
# sums in two orders (float32); the int8 codes' score noise (about 3e-4 for
# unit rows), twice, with room; int4's (about 4e-3), twice, with room
L2_SELF_TOL = {"none": 1e-4, "int8": 1e-2, "int4": 1e-1}
L2_REQUESTS = 200  # phase 13's traffic per index and mode, from 4 threads


def serve_l2(dev, encoder, collator, host_rows, texts, text_rows, power) -> dict:
    """Phase 13: phase 4's 1,000,000 rows as l2 indexes in float32, int8
    (alpha fitted) and int4 (depth D + 256 = 1280), each served exactly and
    approximately (W = 2): every text at top-1 at a distance about 0, every
    served batch against the plain search over the same layout."""
    from kirag_tpu_torch.index import TorchIndexer

    served = {}
    for quant in ("none", "int8", "int4"):
        fmt = "float32" if quant == "none" else quant
        index = TorchIndexer(DIM, metric="l2", device=dev, compression=quant,
                             pallas_chunk_size=CHUNK, approx_winners=2)
        index.index_data(list(range(len(host_rows))), host_rows)
        t0 = time.perf_counter()
        index.to_device()
        torch.cuda.synchronize()
        log(f"  l2 {fmt} index: {len(host_rows)} rows augmented on the host and placed in "
            f"{time.perf_counter() - t0:.2f} s (host clock): device depth "
            f"{index._device_width()} (augmented {index._l2_aug_width()}), alpha "
            f"{index._l2_alpha}, {nbytes(index._device_corpus) / 1e9:.3f} GB")
        for mode in ("exact", "approx"):
            label = f"l2 {fmt} index, {mode}"
            served[label] = serve(label, encoder, collator, index, texts, text_rows, power,
                                  n_requests=L2_REQUESTS, mode=mode, self_tol=L2_SELF_TOL[quant])
        del index
        torch.cuda.empty_cache()
    return served


# ---------------------------------------------------------------- phase 14

# product quantization: the subquantizer counts that K1/K2 take at D = 1024
# (D / m = 8, 4, 2; m = 256 is the default D / 4 and FAISS's PQ(128, 8),
# m = 512 FAISS's PQ(256, 8)), the served index's m, and phase 14 (c)'s
# traffic from 4 threads
PQ_MS = (128, 256, 512)
PQ_M = 256
PQ_REQUESTS = 200
PQ_REL = 1e-6   # random data: K1/K2 against plain, a share of the largest score


def pq_corpus(m: int, n: int, gen, dev, integer: bool):
    """Random 4-bit PQ codes [n, m/2] and a [16, DIM] level table: small
    integers (exact in bf16: every score exact in any order), or normal
    levels of a unit row's scale, rounded to bf16 as ``train_pq`` leaves
    them."""
    codes = torch.randint(0, 256, (n, m // 2), generator=gen, device=dev).to(torch.uint8)
    if integer:
        table = torch.randint(-3, 4, (16, DIM), generator=gen, device=dev).float()
    else:
        table = (torch.randn(16, DIM, generator=gen, device=dev) / math.sqrt(DIM)
                 ).to(torch.bfloat16).float()
    return codes, table


def pq_probe(m: int, gen, dev) -> dict:
    """pq4's mma order at one place and another (:func:`mma_probe`'s check):
    one (row, query) pair of random codes, seeded levels and a unit query at
    each of the 32 x 8 places of a probe tile, every other row and query
    random and different in each of the 256 tiles; the pair's score must be
    the same bits at every place, and the tiles within PQ_REL of the largest
    plain score. Returns the pair's score and the largest error."""
    from kirag_tpu_torch.kernels.exact import score_probe, score_probe_plain

    tiles = 32 * 8
    codes, table = pq_corpus(m, tiles * 32, gen, dev, False)
    codes = codes.view(tiles, 32, -1).clone()
    queries = unit_rows(tiles * 8, gen, dev).view(tiles, 8, DIM)
    t = torch.arange(tiles, device=dev)
    m_of, n_of = t // 8, t % 8
    row, query = codes[0, 0].clone(), queries[0, 0].clone()
    codes[t, m_of], queries[t, n_of] = row, query
    out = score_probe(codes, table, queries, "pq4")
    plain = score_probe_plain(codes, table, queries, "pq4")
    err = float((out - plain).abs().max())
    pair = out[t, m_of, n_of]
    if not torch.equal(pair, pair[:1].expand(tiles)):
        raise AssertionError(f"pq4 m={m}: the mma order's score of one (row, query) pair "
                             f"depends on its place in the fragments: {pair.unique().tolist()}")
    if not err <= PQ_REL * float(plain.abs().max()):
        raise AssertionError(f"pq4 m={m}: the probe differs from plain by {err}")
    return {"pair": float(pair[0]), "err": err}


def check_pq_kernels(dev, gen, err) -> dict:
    """Phase 14 (a): K1, K2 and K7a with K4's pq4 scoring (the mma order)
    against their plain versions at phase 3's geometry, m = 128, 256, 512,
    Q = 8, 16, 32, after the position probe (:func:`pq_probe`). On integer
    data every output of K1, K2 and the search is bitwise the plain
    version's; on random levels within PQ_REL of the largest score (the
    search within ATOL, ids equal but at near-ties). On both, K1's captures
    are bitwise K2's re-scores of the captured groups, K7a's maxima bitwise
    K1's and its scores of those groups bitwise K2's. Returns the probes."""
    from kirag_tpu_torch.kernels import (gather_groups, gather_groups_plain, score_gather,
                                         score_gmax, score_gmax_plain, stream_capture,
                                         stream_capture_plain)
    from kirag_tpu_torch.ops import exact_topk_mips, hier_topk
    from kirag_tpu_torch.ops.exact import _capture_budget

    n, valid = CHECK_ROWS, CHECK_ROWS - 1000
    n_c = n // CHUNK
    b = _capture_budget(K, n_c, CHUNK // 128)
    k1, k2 = kernel_names("pq")
    search = dict(chunk_size=CHUNK, valid_rows=valid, on_miss="flag", quant="pq4", **CAPDOM)
    probes = {}
    for m in PQ_MS:
        probes[m] = pq_probe(m, gen, dev)
        log(f"  pq4 m={m}: one (row, query) pair at all 256 places of the mma fragments "
            f"scores {probes[m]['pair']!r} at each, bitwise; probe within "
            f"{probes[m]['err']:.3g} of plain")
        for data in ("integer", "random"):
            c, table = pq_corpus(m, n, gen, dev, data == "integer")
            for n_q in (8, 16, 32):
                what = f"{data} pq4 m={m} Q={n_q}"
                if data == "integer":
                    q = torch.randint(-2, 3, (n_q, DIM), generator=gen, device=dev).float()
                else:
                    q = unit_rows(n_q, gen, dev)
                got = stream_capture(q, c, valid, CHUNK, b, table, "pq4")
                want = stream_capture_plain(q, c, valid, CHUNK, b, table, "pq4")
                gsel = torch.sort(hier_topk(got[0].reshape(-1, n_q).T, K)[1], dim=-1).values
                cand = gather_groups(q, c, gsel, table, "pq4")
                cand_plain = gather_groups_plain(q, c, gsel, table, "pq4")
                res = exact_topk_mips(q, c, K, scales=table, **search)
                ref = exact_topk_mips(q, c, K, scales=table, plain=True, **search)
                captured = got[2].permute(2, 0, 1).reshape(n_q, -1)
                rescored = gather_groups(q, c, captured, table, "pq4")
                scores7, gmax7 = score_gmax(q, c, valid, CHUNK, "chunk", table, "pq4")
                torch.cuda.synchronize()
                if not torch.equal(rescored, got[1].view(n_c, n_q, b, 128).transpose(0, 1)
                                   .reshape(n_q, -1, 128)):
                    raise AssertionError(f"{what}: K1's captures differ from K2's re-scores "
                                         "of the same groups")
                if not (torch.equal(gmax7, got[0])
                        and torch.equal(score_gather(scores7, captured), rescored)):
                    raise AssertionError(f"{what}: K7a's maxima or scores differ from K1's "
                                         "and K2's")
                if data == "integer":
                    for name, x, y in zip(CAPTURE_OUTPUTS, got, want):
                        if not torch.equal(x, y):
                            raise AssertionError(f"{what}: K1 {name} differs from plain")
                    if not torch.equal(cand, cand_plain):
                        raise AssertionError(f"{what}: K2 differs from plain")
                    if not torch.equal(scores7, score_gmax_plain(q, c, valid, CHUNK, "chunk",
                                                                 table, "pq4")[0]):
                        raise AssertionError(f"{what}: K7a differs from plain")
                    for x, y in zip(res, ref):
                        if not torch.equal(x, y):
                            raise AssertionError(f"{what}: exact search differs from plain")
                    log(f"  {what}: K1 5/5 outputs, K2 and K7a bitwise equal to plain, K1's "
                        f"{captured.numel()} captured groups bitwise equal to K2's re-scores "
                        f"and K7a's scores, K7a's maxima K1's; search bitwise equal, "
                        f"ok={bool(res[2])}")
                    continue
                scores7_plain = score_gmax_plain(q, c, valid, CHUNK, "chunk", table, "pq4")[0]
                scale = max(float(want[1].abs().max()), float(cand_plain.abs().max()))
                same = (got[2] == want[2]).permute(0, 2, 1).repeat_interleave(128, dim=2)
                k1_err = max(float((got[i] - want[i]).abs().max()) for i in (0, 3, 4))
                k1_err = max(k1_err, float((got[1] - want[1]).abs()[same].max()))
                k2_err = float((cand - cand_plain).abs().max())
                k7_err = float((scores7 - scores7_plain).abs().max())
                if not max(k1_err, k2_err, k7_err) <= PQ_REL * scale:
                    raise AssertionError(f"{what}: K1 {k1_err}, K2 {k2_err}, K7a {k7_err} from "
                                         f"plain, over {PQ_REL} of the largest score {scale}")
                check_topk_close(res[0], res[1], ref[0], ref[1], f"{what} search")
                err[k1], err[k2] = max(err.get(k1, 0.0), k1_err), max(err.get(k2, 0.0), k2_err)
                err["score_gmax_pq4"] = max(err.get("score_gmax_pq4", 0.0), k7_err)
                log(f"  {what}: K1 max abs err {k1_err:.3g}, K2 {k2_err:.3g}, K7a {k7_err:.3g} "
                    f"(largest score {scale:.3g}; {int((~same).sum()) // 128} captured groups "
                    f"differ at near-ties); K1's {captured.numel()} captured groups bitwise "
                    f"K2's re-scores and K7a's scores, K7a's maxima K1's; search "
                    f"ok={bool(res[2])}/{bool(ref[2])}")
            del c, table
    return {"probe": probes}


def check_pq_training(dev, gen, power) -> None:
    """Phase 14 (b): the card's k-means and encoder. PQ_M subspaces trained
    on seeded unit rows (the indexer's sample size and iterations): every
    chosen code's centroid score ``x.c - 0.5 ||c||^2`` within 1e-5 of the
    row's best, scored again by products and sums (no matmul); codebooks
    finite and bf16-representable. On integer rows and integer codebooks the
    card's codes are the nearest centroids that numpy finds in integer
    arithmetic (ties to the lower centroid), and ``decode_pq`` gives them."""
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.ops.pq import decode_pq, encode_pq, subspace_view, train_pq

    n = TorchIndexer(DIM, device=dev, compression="pq").pq_train_rows
    rows = unit_rows(n, gen, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codebooks = train_pq(rows, PQ_M, iters=25, seed=SEED)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes = encode_pq(rows, codebooks)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    if not (torch.isfinite(codebooks).all()
            and torch.equal(codebooks, codebooks.to(torch.bfloat16).float())):
        raise AssertionError("k-means: codebooks not finite or not bf16-representable")
    code = torch.cat([codes & 15, codes >> 4], dim=1).long().T              # [m, n]
    gap, sub = 0.0, subspace_view(rows, PQ_M)
    for s0 in range(0, PQ_M, 16):
        cb = codebooks[s0:s0 + 16]
        scores = (sub[s0:s0 + 16, :, None, :] * cb[:, None]).sum(-1) \
            - 0.5 * (cb * cb).sum(-1)[:, None, :]                            # [16, n, K]
        chosen = torch.gather(scores, 2, code[s0:s0 + 16, :, None])[..., 0]
        gap = max(gap, float((scores.amax(-1) - chosen).max()))
    if not gap <= 1e-5:
        raise AssertionError(f"k-means: a chosen centroid scores {gap} below the row's best")
    ints = torch.randint(-3, 4, (16384, DIM), generator=gen, device=dev).float()
    int_cb = torch.randint(-3, 4, (PQ_M, 16, DIM // PQ_M), generator=gen, device=dev).float()
    got = encode_pq(ints, int_cb).cpu().numpy()
    x = ints.cpu().numpy().astype(np.int64).reshape(len(ints), -1, PQ_M).transpose(2, 0, 1)
    c = int_cb.cpu().numpy().astype(np.int64)
    score = 2 * np.einsum("mnd,mkd->mnk", x, c) - (c * c).sum(-1)[:, None, :]
    nearest = score.argmax(-1).astype(np.uint8)                                # [m, n]
    want = (nearest[:PQ_M // 2] | (nearest[PQ_M // 2:] << 4)).T
    recon = np.take_along_axis(c, nearest.astype(np.int64)[..., None], axis=1)  # [m, n, ds]
    if not (np.array_equal(got, want) and np.array_equal(
            decode_pq(got, c.astype(np.float32)),
            recon.transpose(1, 2, 0).reshape(len(ints), DIM).astype(np.float32))):
        raise AssertionError("encode_pq: the card's codes are not the nearest centroids")
    log(f"  k-means on the card: {n} seeded unit rows x {DIM}, m={PQ_M} (ds={DIM // PQ_M}), 25 "
        f"iterations in {train_s:.2f} s, encoded in {encode_s:.3f} s (host clock); every "
        f"chosen centroid within {gap:.3g} of the row's best (products and sums, no matmul); "
        f"codebooks finite and bf16-representable; {len(ints)} integer rows: the codes are the "
        "nearest centroids in integer arithmetic, decode_pq gives them back")
    log(f"  [{power}] k-means {train_s:.2f} s, encoding {n / encode_s:.0f} rows/s")


def serve_pq(work: Path, dev, encoder, collator, host_rows, texts, text_rows, text_emb, gen,
             power, err) -> dict:
    """Phase 14 (c): the retrieval server over phase 4's 1,000,000 host rows
    as a PQ index (``TorchIndexer(compression="pq", n_subquantizers=PQ_M)``:
    codebooks trained on the card from the strided sample, the rows encoded
    on the card block by block), PQ_REQUESTS requests from 4 threads and
    lone ones, each served batch against the plain search over the same
    codes; ``mode="approx"`` gives the exact results; K1 and K2 against
    plain and timed; then ``serialize`` -> ``deserialize_from`` gives the
    same codes and results without training again."""
    import kirag_tpu_torch.index.indexer as indexer_module
    from kirag_tpu_torch.index import TorchIndexer

    label = "pq index"
    index = TorchIndexer(DIM, device=dev, compression="pq", n_subquantizers=PQ_M,
                         pallas_chunk_size=CHUNK)
    index.index_data(list(range(len(host_rows))), host_rows)
    t0 = time.perf_counter()
    index.to_device()
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    codes, table = index._device_corpus, index._device_scales
    log(f"  {label}: {len(host_rows)} rows, codebooks trained on the card from "
        f"{min(len(host_rows), index.pq_train_rows)} strided rows and the rows encoded block "
        f"by block by "
        f"to_device in {place_s:.2f} s (host clock, copies included): codes "
        f"{tuple(codes.shape)} {nbytes(codes) / 1e9:.3f} GB + level table {tuple(table.shape)}")
    stats = serve(label, encoder, collator, index, texts, text_rows, power,
                  n_requests=PQ_REQUESTS)
    exact = index.search_knn(text_emb, K)
    approx = index.search_knn(text_emb, K, mode="approx")
    if not all(a[0] == e[0] and np.array_equal(a[1], e[1]) for a, e in zip(approx, exact)):
        raise AssertionError(f"{label}: mode='approx' differs from the exact search")
    timed = index_kernels(label, index, gen, power, err)

    trained = []
    train = indexer_module.train_pq
    indexer_module.train_pq = lambda *a, **kw: trained.append(1) or train(*a, **kw)
    try:
        t0 = time.perf_counter()
        index.serialize(str(work / "index_pq_1m"))
        loaded = TorchIndexer(DIM, device=dev, pallas_chunk_size=CHUNK)
        loaded.deserialize_from(str(work / "index_pq_1m"))
        again = loaded.search_knn(text_emb, K)
        round_s = time.perf_counter() - t0
    finally:
        indexer_module.train_pq = train
    if not (loaded.compression == "pq" and loaded.pq_m == PQ_M and not trained
            and np.array_equal(loaded._pq_codebooks, index._pq_codebooks)
            and torch.equal(loaded._device_corpus, codes)
            and all(a[0] == e[0] and np.array_equal(a[1], e[1]) for a, e in zip(again, exact))):
        raise AssertionError(f"{label}: the reloaded index differs (compression "
                             f"{loaded.compression}, m {loaded.pq_m}, trained {len(trained)})")
    shutil.rmtree(work / "index_pq_1m", ignore_errors=True)
    log(f"  {label}: mode='approx' serves the exact results; serialize -> deserialize_from in "
        f"{round_s:.2f} s: the same codebooks (no training), codes and results for the "
        f"{len(text_emb)} texts")
    return {"served": stats, "timed": timed}


def pq_cli(work: Path, built: dict, decoded: dict, dev, power) -> dict:
    """Phase 14 (c), run D beside phase 9 while its LLM is on the card:
    phase 6's embeddings as a PQ index (``TorchIndexer(compression="pq")``
    -> ``serialize``; the CLI's ``build_index`` has no PQ choice, as in the
    reference), then ``cli/retrieve --index_folder`` over it for one
    question with phase 9's LLM, over ``filled_kg_cache``'s copy of run B's
    cache (the LLM decodes KG triples for the held-out documents only)."""
    from kirag_tpu_torch.cli import retrieve as retrieve_cli
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.kernels import reset_launch_counts

    index = TorchIndexer(DIM, device=dev, compression="pq", n_subquantizers=PQ_M)
    index.index_data(built["ids"], built["stored"])
    index_dir = work / "index_pq"
    index.serialize(str(index_dir))
    cfg = json.loads((index_dir / "index_config.json").read_text())
    if not (cfg["compression"] == "pq" and cfg["pq_m"] == PQ_M
            and (index_dir / "pq_codebooks.npy").exists()):
        raise AssertionError(f"PQ index: config {cfg}")
    del index
    llm = ({**decoded["params"], "layers": decoded["params"]["layers"][:KIRAG_LAYERS]},
           dataclasses.replace(decoded["config"], num_hidden_layers=KIRAG_LAYERS))
    argv = ["--dataset", "hotpotqa", "--query_file", str(work / "questions.json"),
            "--num_queries", "1", "--corpus", "wikipedia", "--corpus_path", str(built["tsv"]),
            "--index_folder", str(index_dir), "--embedding_size", str(DIM),
            "--retriever_model_name_or_path", str(built["model_dir"]), "--llm",
            "Meta-Llama-3-8B-Instruct", "--llm_quant_bits", "4", "--aligner_model", "e5",
            "--aligner_model_name_or_path", str(built["model_dir"]), "--num_turns",
            str(KIRAG_TURNS), "--topk", "10", "--num_beams", "1", "--save_dir", str(work),
            "--name", "kirag_D", "--save_file", "results.json", "--cached_kg_triples_file",
            str(filled_kg_cache(work, built, "D"))]
    reset_launch_counts()
    t0 = time.perf_counter()
    path = retrieve_cli.main(argv, tokenizer=HashTokenizer(), llm_tokenizer=ByteLevelTokenizer(),
                             aligner_tokenizer=HashTokenizer(), llm=llm)
    wall = time.perf_counter() - t0
    counts = main_path_counts()
    results = json.loads(Path(path).read_text())
    ids = set(built["ids"])
    if not (len(results) == 1 and results[0]["ctxs"] and "paths" in results[0]
            and all(c["id"] in ids for c in results[0]["ctxs"])
            and counts["stream_capture_pq4"] > 0 and counts["int4_matmul"] > 0
            and counts["flash_attention"] > 0):
        raise AssertionError(f"run D: results lack ctxs or paths, hold ids outside the index, "
                             f"or a kernel of the path was not launched: {counts}")
    log(f"  run D (cli/retrieve --index_folder over phase 6's embeddings as a PQ index, m="
        f"{PQ_M}, {len(built['ids'])} rows): {wall:.2f} s, {len(results[0]['ctxs'])} ctxs, "
        f"every id in the index; launches { {k: v for k, v in counts.items() if v} }")
    log(f"  [{power}] run D: {wall:.2f} s")
    return {"launches": counts, "wall": wall}


def dpr_pq(dev, power, err, dpr: dict) -> dict:
    """Phase 14 (d): the DPR corpus's 21,015,324 seeded unit rows (phase 11
    (d)'s blocks) as a PQ index, m = PQ_M, built as the indexer builds it:
    pass 1 makes every block and keeps the evenly strided training sample,
    k-means on the card, pass 2 makes the blocks again and encodes them
    into the codes; then phase 11 (d)'s search at Q = 8, 32, 256 with K1/K2
    timed (plain at Q = 8) and recall@10/@100 against phase 11 (d)'s exact
    float32 top-100 (no limit: seeded unit rows are PQ's hardest case)."""
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.ops.pq import encode_pq, pq_level_table, train_pq

    n_train = TorchIndexer(DIM, device=dev, compression="pq").pq_train_rows
    step = max(1, DPR_ROWS // n_train)
    picks = torch.arange(0, DPR_ROWS, step, device=dev)[:n_train]
    sample = torch.empty((n_train, DIM), device=dev)
    t0 = time.perf_counter()
    for i, start in enumerate(range(0, DPR_ROWS, GEN_BLOCK)):
        rows = dpr_block(i, min(GEN_BLOCK, DPR_ROWS - start), dev)
        inside = (picks >= start) & (picks < start + len(rows))
        sample[inside] = rows[picks[inside] - start]
    torch.cuda.synchronize()
    pass1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    codebooks = train_pq(sample, PQ_M, iters=25, seed=SEED)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    del sample
    n_pad = -(-DPR_ROWS // CHUNK) * CHUNK
    codes = torch.zeros((n_pad, PQ_M // 2), dtype=torch.uint8, device=dev)
    t0 = time.perf_counter()
    for i, start in enumerate(range(0, DPR_ROWS, GEN_BLOCK)):
        rows = dpr_block(i, min(GEN_BLOCK, DPR_ROWS - start), dev)
        codes[start:start + len(rows)] = encode_pq(rows, codebooks, batch=GEN_BLOCK)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    table = torch.from_numpy(pq_level_table(codebooks.cpu().numpy())).to(dev)
    log(f"  pq4: pass 1 made {DPR_ROWS} rows and kept {n_train} strided ones in {pass1_s:.2f} s; "
        f"k-means (m={PQ_M}, 25 iterations) {train_s:.2f} s; pass 2 made and encoded them in "
        f"{encode_s:.2f} s (host clock); codes {nbytes(codes) / 1e9:.3f} GB + level table")
    out = dpr_search("pq4", codes, table, dpr["queries"], dpr["sample"], power, err)
    out["gb"] = nbytes(codes) / 1e9
    del codes
    torch.cuda.empty_cache()
    out["recall"] = r = {k: recall(out["idx"], dpr["exact"], k) for k in (10, K)}
    log(f"  pq4: recall@10 {r[10]:.4f}, recall@{K} {r[K]:.4f} against the exact float32 top-{K} "
        f"({len(dpr['exact'])} queries; {DPR_SELF} stored rows, the rest near one)")
    return out


# ---------------------------------------------------------------- phase 15

# the exact-search variants: every (impl, select) of the reference, capdom in
# both assemblies (K8 under "pallas"); each must equal stream/capdom bitwise
VARIANTS = (("stream", "flat", None), ("stream", "hier", None), ("stream", "capdom", "einsum"),
            ("stream", "capdom", "pallas"), ("stream", "merge", None), ("single", "hier", None),
            ("single_strided", "hier", None), ("twopass", "flat", None),
            ("twopass", "hier", None))
VARIANT_FORMATS = ("float32", "bfloat16", "int8", "int4", "pq4")
VARIANT_QUERIES = (8, 32, 256)
VARIANT_REQUESTS = 200  # phase 15 (c)'s traffic per selection, from 4 threads
# phase 15 (d) at the DPR scale: impl="single" writes 4 * Q * 21M score bytes
# (2.7 GB at Q = 32), so it and twopass run at Q = 8 and 32, merge at all three
DPR_VARIANTS = (("single", "hier", (8, 32)), ("twopass", "hier", (8, 32)),
                ("stream", "merge", DPR_QUERIES))
K7_SOURCES = {  # name: (source, the TPU kernel it replaces)
    "score_gmax": ("kirag_tpu_torch/csrc/score_gmax.cu", "kirag_tpu/ops/pallas_exact.py:359"),
    "score_gather": ("kirag_tpu_torch/csrc/copy_groups.cu", "kirag_tpu/ops/pallas_exact.py:751"),
    "cap_assemble": ("kirag_tpu_torch/csrc/copy_groups.cu", "kirag_tpu/ops/pallas_exact.py:701"),
    "window_merge": ("kirag_tpu_torch/csrc/window_merge.cu", "kirag_tpu/ops/pallas_exact.py:532"),
}


@contextlib.contextmanager
def capdom_assembly(mode):
    """``KIRAG_CAPDOM_ASSEMBLY`` for the searches inside the block."""
    from kirag_tpu_torch.ops import exact as ops_exact

    old = ops_exact.CAPDOM_ASSEMBLY
    ops_exact.CAPDOM_ASSEMBLY = mode or old
    try:
        yield
    finally:
        ops_exact.CAPDOM_ASSEMBLY = old


def variant_name(impl: str, select: str, assembly) -> str:
    return f"{impl}/{select}" + (f" ({assembly})" if assembly else "")


def variant_corpus(fmt: str, n: int, gen, dev, integer: bool):
    """``(corpus, scales, quant)`` of n rows in one of the five formats:
    integer data (exact in any summation order) or seeded unit rows (a
    quantized corpus: random codes and levels of a unit row's scale)."""
    if fmt in ("float32", "bfloat16"):
        dtype = getattr(torch, fmt)
        if integer:
            return torch.randint(-2, 3, (n, DIM), generator=gen, device=dev).to(dtype), None, "none"
        return unit_rows(n, gen, dev).to(dtype), None, "none"
    if fmt == "pq4":
        return (*pq_corpus(PQ_M, n, gen, dev, integer), "pq4")
    return (*quantized_corpus(fmt, n, gen, dev, integer), fmt)


def copy_bound(idx, out):
    """K7b's and K8's bound: the selected groups read once and written once,
    and the indices read."""
    return bound(2 * nbytes(out) + nbytes(idx), 0, 1.0)


def merge_bound(k1_outs, merged):
    """K9's bound: K1's keys, gids and residuals read, the window's payload
    read from the capture and written, its keys, gids and lost written."""
    _, _, gids, capmax, resid = k1_outs
    win, wkey, wgid, lost = merged
    return bound(nbytes(gids, capmax, resid, wkey, wgid, lost) + 2 * nbytes(win), 0, 1.0)


def capdom_positions(k1_outs, k: int):
    """capdom's selected capture positions [Q, k] (K8's input)."""
    from kirag_tpu_torch.ops import stable_topk

    capmax = k1_outs[3]
    n_c, b, n_q = capmax.shape
    return stable_topk(capmax.permute(2, 0, 1).reshape(n_q, n_c * b), k)[1]


def device_kernels(fn) -> list:
    """The names of the device kernels one call of ``fn`` starts
    (torch.profiler), after a call that warms it up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profile_lead_in()
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and SPIN_KERNEL not in e.name]


def one_copy_kernel(fn, name: str, what: str) -> list:
    """The device kernels of one call of ``fn`` (K7b or K8); fails unless
    they are one copy_groups_kernel. A window that saw no kernel (its record
    lost) is profiled again, up to three."""
    for _ in range(3):
        kernels = device_kernels(fn)
        if kernels:
            break
    if len(kernels) != 1 or "copy_groups_kernel" not in kernels[0]:
        raise AssertionError(f"{what}: one {name} call started {kernels} (torch.profiler), "
                             "not one copy_groups_kernel")
    return kernels


def copy_kernels_a_call(device: str = "cuda") -> None:
    """Phase 15 (a)'s count of the device kernels of one K7b and one K8 call,
    run in a process of its own (:func:`copy_kernels_in_a_fresh_process`):
    small random sources at Q = 8 and int64 indices laid out as
    ``impl="single"`` and capdom hand them over (a sorted row slice of a top
    k, and column-major positions); prints one JSON line {name: [kernel
    names], "strides": ...}. Late in a long run this process's profiler can
    see no device kernel at all (phase 12 (b)'s "not measured"), so the
    count is taken where the profiler starts fresh."""
    from kirag_tpu_torch.kernels import cap_assemble, score_gather
    from kirag_tpu_torch.ops import hier_topk

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_c, g_per, b, n_q = 16, CHUNK // 128, 8, 8
    scores = torch.randn(n_c, n_q, CHUNK, generator=gen, device=dev)
    gmax = torch.randn(n_c * g_per, n_q, generator=gen, device=dev)
    gsel = torch.sort(hier_topk(gmax.T, K)[1], dim=-1).values
    capture = torch.randn(n_c, n_q, b * 128, generator=gen, device=dev)
    capmax = torch.randn(n_c, b, n_q, generator=gen, device=dev)
    cpos = capdom_positions((None, None, None, capmax), K)
    what = f"Q={n_q}, k={K}"
    print(json.dumps({
        "score_gather": one_copy_kernel(lambda: score_gather(scores, gsel), "score_gather",
                                        what),
        "cap_assemble": one_copy_kernel(lambda: cap_assemble(cpos, capture, b),
                                        "cap_assemble", what),
        "strides": [list(gsel.stride()), list(cpos.stride()), str(gsel.dtype)]}), flush=True)


def copy_kernels_in_a_fresh_process() -> dict:
    """:func:`copy_kernels_a_call` in a child Python process (the library is
    built already), waited for: its JSON line, or an AssertionError with
    its error output."""
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.copy_kernels_a_call()"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError("the count of K7b's and K8's device kernels failed:\n"
                             + proc.stderr[-3000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    strides = out.pop("strides")
    log(f"  one score_gather and one cap_assemble call ({strides[2]} indices as the search "
        f"gives them, strides {tuple(strides[0])} and {tuple(strides[1])}) each start one "
        f"device kernel (torch.profiler, a fresh process): {out['score_gather'][0]}")
    return out


def check_copy_kernels(scores, gsel, capture, cpos, b: int, what: str) -> None:
    """K7b and K8 bitwise their plain versions on the search's int64
    indices and on int32 copies of them (the same layout), each with an
    index before the source and one past it in its first two slots."""
    from kirag_tpu_torch.kernels import (cap_assemble, cap_assemble_plain, score_gather,
                                         score_gather_plain)

    cases = (("K7b", gsel, scores.shape[0] * scores.shape[2] // 128,
              lambda i: score_gather(scores, i), lambda i: score_gather_plain(scores, i)),
             ("K8", cpos, capture.shape[0] * b, lambda i: cap_assemble(i, capture, b),
              lambda i: cap_assemble_plain(i, capture, b)))
    for name, idx, n_src, kernel, plain in cases:
        for dtype in (torch.int64, torch.int32):
            i = idx.clone().to(dtype)
            i[:, 0], i[:, 1] = -1, n_src
            got = kernel(i)
            if not (torch.equal(got, plain(i)) and not got[:, :2].any()):
                raise AssertionError(f"{what}: {name} on {dtype} indices with out-of-range "
                                     "ones differs from plain")


def check_variant_kernels(dev, gen, err) -> dict:
    """Phase 15 (a): K7a (three stores), K7b, K8 and K9 against their plain
    versions at phase 3's geometry, five formats, Q = 8, 16, 32. K7a's
    maxima are bitwise K1's on any data, its scores bitwise the plain
    version's on integer data (within ATOL on unit rows) and, where K7b
    copies the selected groups, bitwise K2's re-scores; K7b, K8 and K9 are
    bitwise their plain versions (copies and selections), K7b and K8 also
    on int32 indices and out-of-range ones. Returns the device kernels of
    one K7b and one K8 call on the search's int64 indices (torch.profiler,
    :func:`copy_kernels_a_call`), and fails unless each is one
    ``copy_groups_kernel``."""
    from kirag_tpu_torch.kernels import (cap_assemble, cap_assemble_plain, gather_groups,
                                         score_gather, score_gather_plain, score_gmax,
                                         score_gmax_plain, stream_capture, window_merge,
                                         window_merge_plain)
    from kirag_tpu_torch.ops import hier_topk
    from kirag_tpu_torch.ops.exact import _capture_budget, _merge_geometry

    n, valid = CHECK_ROWS, CHECK_ROWS - 1000
    num_chunks, g_per = n // CHUNK, CHUNK // 128
    b = _capture_budget(K, num_chunks, g_per)
    _, br, _ = _merge_geometry(K, num_chunks, g_per, 8)
    one_call = copy_kernels_in_a_fresh_process()
    for fmt in VARIANT_FORMATS:
        for data in ("integer", "random"):
            c, s, quant = variant_corpus(fmt, n, gen, dev, data == "integer")
            name = "score_gmax" if quant == "none" else f"score_gmax_{quant}"
            data_err, through_reference = 0.0, 0
            for n_q in (8, 16, 32):
                what = f"{data} {fmt} Q={n_q}"
                if data == "integer":
                    q = torch.randint(-2, 3, (n_q, DIM), generator=gen, device=dev).float()
                else:
                    q = unit_rows(n_q, gen, dev)
                if fmt == "bfloat16":
                    q = q.to(torch.bfloat16)
                k1 = stream_capture(q, c, valid, CHUNK, b, s, quant)
                k7a_err = 0.0
                for store in ("chunk", "row", "none"):
                    got = score_gmax(q, c, valid, CHUNK, store, s, quant)
                    want = score_gmax_plain(q, c, valid, CHUNK, store, s, quant)
                    torch.cuda.synchronize()
                    if not torch.equal(got[1], k1[0]):
                        raise AssertionError(f"{what}: K7a ({store}) maxima differ from K1's")
                    for x, y in zip(got, want):
                        if x is None:
                            continue
                        e = float((x - y).abs().max())
                        if (data == "integer" and e != 0.0) or not e <= ATOL:
                            raise AssertionError(f"{what}: K7a ({store}) differs from plain by {e}")
                        k7a_err = max(k7a_err, e)
                    if store == "chunk":
                        scores = got[0]
                data_err = max(data_err, k7a_err)
                err[name] = max(err.get(name, 0.0), k7a_err)
                gsel = torch.sort(hier_topk(k1[0].reshape(-1, n_q).T, K)[1], dim=-1).values
                cand = score_gather(scores, gsel)
                if not (torch.equal(cand, score_gather_plain(scores, gsel))
                        and torch.equal(cand, gather_groups(q, c, gsel, s, quant))):
                    raise AssertionError(f"{what}: K7b differs from plain or from K2's re-scores")
                cpos = capdom_positions(k1, K)
                if not torch.equal(cap_assemble(cpos, k1[1], b),
                                   cap_assemble_plain(cpos, k1[1], b)):
                    raise AssertionError(f"{what}: K8 differs from plain")
                check_copy_kernels(scores, gsel, k1[1], cpos, b, what)
                total = n // 128
                paths = torch.empty(n_q, dtype=torch.int32, device=dev)
                merged = window_merge(*k1[2:], k1[1], br, total, paths=paths)
                for part, x, y in zip(("win", "wkey", "wgid", "lost"), merged,
                                      window_merge_plain(*k1[2:], k1[1], br, total)):
                    if not torch.equal(x, y):
                        raise AssertionError(f"{what}: K9 {part} differs from plain")
                through_reference += int(paths.sum())
                del scores, k1, cand, merged
            log(f"  {data} {fmt}, Q = 8/16/32: K7a (chunk-major, row-major, no store) maxima "
                f"bitwise K1's, scores {'bitwise' if data == 'integer' else 'within ATOL of'} "
                f"plain (largest error {data_err:.3g}); K7b bitwise plain and K2's re-scores; "
                f"K7b and K8 bitwise plain on int64 and int32 indices, out-of-range ones "
                f"included; K9 (win, wkey, wgid, lost; br={br}, bc={b}) bitwise plain, "
                f"{through_reference} of the 56 queries through the reference's steps")
            del c, s
    for name in ("score_gather", "cap_assemble", "window_merge"):
        err[name] = 0.0
    return one_call


def variants_search(q, corpus, search: dict, what: str, variants=VARIANTS,
                    query_counts=VARIANT_QUERIES) -> dict:
    """Every variant at each Q against stream/capdom, bitwise, under
    ``on_miss="fallback"``; returns the capdom results by Q."""
    from kirag_tpu_torch.ops import exact_topk_mips

    want = {}
    for n_q in query_counts:
        want[n_q] = exact_topk_mips(q[:n_q], corpus, K, **search, **CAPDOM)
        for impl, select, assembly in variants:
            with capdom_assembly(assembly):
                got = exact_topk_mips(q[:n_q], corpus, K, impl=impl, select=select, **search)
            if not (torch.equal(got[0], want[n_q][0]) and torch.equal(got[1], want[n_q][1])):
                raise AssertionError(f"{what} Q={n_q}: {variant_name(impl, select, assembly)} "
                                     "differs from stream/capdom")
    return want


def k7_times(q, corpus, scales, quant, valid, reps=10, plain_reps=10, library=False,
             names=tuple(K7_SOURCES)) -> dict:
    """The kernels ``names`` of K7a (chunk-major store), K7b, K8 and K9 timed
    at one Q on one corpus, beside their bounds and (``plain_reps``) their
    plain versions' times; K7b and K8 held bitwise against their plain
    versions on the timed inputs and timed beside the one PyTorch call that
    makes the same copy, K7a (``library``, float corpora) beside
    ``torch.matmul`` and ``amax``."""
    from kirag_tpu_torch.kernels import (cap_assemble, cap_assemble_plain, score_gather,
                                         score_gather_plain, score_gmax, score_gmax_plain,
                                         stream_capture, window_merge, window_merge_plain)
    from kirag_tpu_torch.ops import hier_topk
    from kirag_tpu_torch.ops.exact import _capture_budget, _merge_geometry

    n_q = len(q)
    num_chunks, g_per = len(corpus) // CHUNK, CHUNK // 128
    b = _capture_budget(K, num_chunks, g_per)
    _, br, _ = _merge_geometry(K, num_chunks, g_per, n_q)
    total = len(corpus) // 128
    qrow = torch.arange(n_q, device=q.device)[:, None]
    timed = {}  # name: (kernel call, plain call, library call or None, bound)
    # the library's K7b and K8: one index_select of the groups' flat rows,
    # worked out beforehand (capdom's positions are column-major: their
    # flat rows are made contiguous outside the timed call)
    if "score_gmax" in names or "score_gather" in names:
        outs = score_gmax(q, corpus, valid, CHUNK, "chunk", scales, quant)
        gsel = torch.sort(hier_topk(outs[1].reshape(-1, n_q).T, K)[1], dim=-1).values
        cand = score_gather(outs[0], gsel)
        src = outs[0].view(-1, 128)
        rows7 = (((gsel // g_per) * n_q + qrow) * g_per + gsel % g_per).reshape(-1)
        if "score_gmax" in names:
            timed["score_gmax"] = (
                lambda: score_gmax(q, corpus, valid, CHUNK, "chunk", scales, quant),
                lambda: score_gmax_plain(q, corpus, valid, CHUNK, "chunk", scales, quant),
                (lambda: library_gmax(q, corpus)) if library else None,
                search_bound(q, corpus, scales, quant, outs))
        timed["score_gather"] = (
            lambda: score_gather(outs[0], gsel), lambda: score_gather_plain(outs[0], gsel),
            lambda: src.index_select(0, rows7), copy_bound(gsel, cand))
    if "cap_assemble" in names or "window_merge" in names:
        k1 = stream_capture(q, corpus, valid, CHUNK, b, scales, quant)
        cpos = capdom_positions(k1, K)
        cap = k1[1].view(-1, 128)
        rows8 = (((cpos // b) * n_q + qrow) * b + cpos % b).reshape(-1)
        timed["cap_assemble"] = (
            lambda: cap_assemble(cpos, k1[1], b), lambda: cap_assemble_plain(cpos, k1[1], b),
            lambda: cap.index_select(0, rows8), copy_bound(cpos, cap_assemble(cpos, k1[1], b)))
        timed["window_merge"] = (
            lambda: window_merge(*k1[2:], k1[1], br, total),
            lambda: window_merge_plain(*k1[2:], k1[1], br, total), None,
            merge_bound(k1, window_merge(*k1[2:], k1[1], br, total)))
    t = {"br": br, "bc": b}
    if "window_merge" in names:  # the queries that took the reference's steps
        paths = torch.empty(n_q, dtype=torch.int32, device=q.device)
        window_merge(*k1[2:], k1[1], br, total, paths=paths)
        t["window_merge_reference_queries"] = int(paths.sum())
    if "score_gmax" in names:
        t["plan"] = plan_text(n_q, corpus, 0, scales, quant)
    for name in names:
        kernel, plain, library_call, t[name + "_bound"] = timed[name]
        if name in ("score_gather", "cap_assemble") and not torch.equal(kernel(), plain()):
            raise AssertionError(f"{name} at Q={n_q} differs from plain on the timed inputs")
        t[name] = cuda_ms(kernel, reps=reps)
        if plain_reps:
            t[name + "_plain"] = cuda_ms(plain, reps=plain_reps)
        if library_call is not None:
            t[name + "_library"] = cuda_ms(library_call, reps=reps)
    return t


def log_k7_times(power, what: str, t: dict, reps: int) -> None:
    def one(name):
        plain = f" vs plain {t[name + '_plain']:.3f} ms" if name + "_plain" in t else ""
        lib = f", library {t[name + '_library']:.3f} ms" if name + "_library" in t else ""
        same = ", bitwise plain" if name in ("score_gather", "cap_assemble") else ""
        if name == "window_merge":
            same = (f", {t['window_merge_reference_queries']} of the queries through the "
                    "reference's steps")
        return (f"{name} {t[name]:.3f} ms{plain}{lib} (bound {t[name + '_bound'][0]:.4f} ms, "
                f"{t[name + '_bound'][1]}{same})")
    plan = f"; K7a's {t['plan']}" if "plan" in t else ""
    log(f"  [{power}] {what}, k={K}, window br={t['br']} over bc={t['bc']}: "
        + "; ".join(one(n) for n in K7_SOURCES if n in t)
        + f" (CUDA events, median of {reps}){plan}")


def check_variants(dev, host_rows, gen, power) -> dict:
    """Phase 15 (b): phase 4's 1,000,000 rows as float32, bfloat16, int8,
    int4 and PQ (m = PQ_M) indexes; at Q = 8, 32, 256 every (impl, select)
    through ``exact_topk_mips`` over the index's device rows equals
    stream/capdom bitwise; then K7a/K7b/K8/K9 timed at Q = 32, and on the
    float32 index K7b and K8 at every VARIANT_QUERIES count. Returns the
    launches of the variant runs, the times by format and the float32
    copies' times by Q."""
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.kernels import reset_launch_counts

    launches, times, copies = {}, {}, {}
    q_all = unit_rows(VARIANT_QUERIES[-1], gen, dev)
    for fmt in VARIANT_FORMATS:
        kw = ({"device_dtype": getattr(torch, fmt)} if fmt in ("float32", "bfloat16") else
              {"compression": "pq", "n_subquantizers": PQ_M} if fmt == "pq4" else
              {"compression": fmt})
        index = TorchIndexer(DIM, device=dev, pallas_chunk_size=CHUNK, **kw)
        index.index_data(list(range(len(host_rows))), host_rows)
        index.to_device()
        corpus, scales, valid = index._device_corpus, index._device_scales, index._device_rows
        quant = kernel_quant(index.compression)
        q = q_all.to(index.device_dtype) if quant == "none" else q_all
        search = dict(chunk_size=CHUNK, valid_rows=valid, scales=scales,
                      quant=None if quant == "none" else quant)
        reset_launch_counts()
        t0 = time.perf_counter()
        variants_search(q, corpus, search, f"{fmt} 1M")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = main_path_counts()
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
        log(f"  {fmt} index ({len(corpus)} x {DIM} on the grid), Q = {VARIANT_QUERIES}: all "
            f"{len(VARIANTS)} variants bitwise equal to stream/capdom in values and ids "
            f"({wall:.2f} s, host clock); launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if fmt != "bfloat16":
            n_q = 32
            times[fmt] = k7_times(q[:n_q], corpus, scales, quant, valid,
                                  library=quant == "none")
            log_k7_times(power, f"{fmt} 1M Q={n_q}", times[fmt], 10)
        if fmt == "float32":  # K7b and K8 at every Q, beside index_select
            for n_q in VARIANT_QUERIES:
                copies[n_q] = times[fmt] if n_q == 32 else k7_times(
                    q[:n_q], corpus, scales, quant, valid, names=("score_gather", "cap_assemble"))
                if n_q != 32:
                    log_k7_times(power, f"{fmt} 1M Q={n_q}", copies[n_q], 10)
        del index, corpus, scales
        torch.cuda.empty_cache()
    return {"launches": launches, "times": times, "copies": copies}


def serve_variants(dev, encoder, collator, host_rows, texts, text_rows, power) -> dict:
    """Phase 15 (c): phase 4's server over the 1M float32 index with
    ``pallas_select="merge"`` and with ``"hier"``: VARIANT_REQUESTS requests
    from 4 threads each, self-hits, every served batch against the plain
    search with the same selection."""
    from kirag_tpu_torch.index import TorchIndexer

    served = {}
    for select in ("merge", "hier"):
        label = f"float32 index, pallas_select={select}"
        index = TorchIndexer(DIM, device=dev, pallas_chunk_size=CHUNK, pallas_select=select)
        index.index_data(list(range(len(host_rows))), host_rows)
        index.to_device()
        served[select] = serve(label, encoder, collator, index, texts, text_rows, power,
                               n_requests=VARIANT_REQUESTS)
        del index
        torch.cuda.empty_cache()
    return served


def dpr_variants(codes, scales, queries, capdom: dict, power) -> dict:
    """Phase 15 (d) over phase 11 (d)'s resident int4 codes: impl="single"
    and "twopass" at Q = 8, 32 and select="merge" at Q = 8, 32, 256, each
    equal to the indexer's capdom search of the same queries (phase 11 d);
    then K7a, K7b, K8 and K9 timed at each Q (K7a's plain version at Q = 8)."""
    from kirag_tpu_torch.kernels import reset_launch_counts
    from kirag_tpu_torch.ops import exact_topk_mips

    search = dict(chunk_size=CHUNK, valid_rows=DPR_ROWS, scales=scales, quant="int4")
    reset_launch_counts()
    t0 = time.perf_counter()
    for impl, select, query_counts in DPR_VARIANTS:
        for n_q in query_counts:
            vals, idx = exact_topk_mips(queries[:n_q], codes, K, impl=impl, select=select,
                                        **search)
            if not (torch.equal(vals, capdom["vals"][:n_q])
                    and torch.equal(idx.cpu(), capdom["idx_t"][:n_q])):
                raise AssertionError(f"int4 DPR Q={n_q}: {impl}/{select} differs from capdom")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = main_path_counts()
    log(f"  int4 {DPR_ROWS} x {DIM}: " + ", ".join(
        f"{impl}/{select} at Q = {qs}" for impl, select, qs in DPR_VARIANTS)
        + f" bitwise equal to the capdom search ({wall:.2f} s, host clock); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    times = {}
    for n_q in DPR_QUERIES:
        reps = DPR_REPS[n_q]
        # no score matrix at Q = 256 (21.5 GB): K8 and K9 alone there
        names = tuple(K7_SOURCES) if n_q < DPR_QUERIES[-1] else ("cap_assemble", "window_merge")
        times[n_q] = k7_times(queries[:n_q], codes, scales, "int4", DPR_ROWS, reps=reps,
                              plain_reps=3 if n_q == DPR_QUERIES[0] else 0, names=names)
        log_k7_times(power, f"int4 DPR {DPR_ROWS} x {DIM} Q={n_q}", times[n_q], reps)
    return {"launches": launches, "times": times}


# ---------------------------------------------------------------- phase 18

STREAM_ROWS = 2_097_152    # seeded unit rows: 8.6 GB of float32, four blocks
STREAM_BLOCK = 524_288     # max_device_rows
STREAM_QUERIES = 32
STREAM_REPS = 5
STREAM_REQUESTS = 32       # (d): requests of 1-5 texts from 4 threads
HOST_LINES = 100_000       # (e): passages of the seeded TSV
HOST_ROWS = 100_000        # (e): CPUFlatIndex's rows, (a)'s first
HOST_QUERIES = 8


def meminfo() -> dict:
    """MemTotal and MemAvailable of /proc/meminfo, in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(value.split()[0]) * 1024
    return out


def stream_rows(n: int, text_emb: np.ndarray, gen, dev):
    """(a): n seeded unit rows made on the card a block at a time and copied
    to host memory, the texts' embeddings planted at known rows."""
    host = np.empty((n, DIM), dtype=np.float32)
    for start in range(0, n, STREAM_BLOCK):
        part = unit_rows(min(STREAM_BLOCK, n - start), gen, dev)
        host[start:start + len(part)] = part.cpu().numpy()
    text_rows = [i * (n // len(text_emb)) + 11 for i in range(len(text_emb))]
    host[text_rows] = text_emb
    return host, text_rows


def stream_times(index, queries: np.ndarray, mode: str = "exact") -> dict:
    """STREAM_REPS streamed searches, each timed by the host clock (search_knn
    returns host arrays, so it ends synchronised) and by the events the
    index records around each block's copy and search: medians of the wall
    ms, the copies' and the searches' ms, the event span from the first
    copy's start to the last search's end, and the copy the searches hide
    (copy + search - span)."""
    index.stream_timing = True
    runs = []
    try:
        for _ in range(STREAM_REPS):
            t0 = time.perf_counter()
            index.search_knn(queries, K, mode=mode)
            wall = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            ev = index.stream_events
            copy = [c0.elapsed_time(c1) for c0, c1, _, _ in ev]
            search = [s0.elapsed_time(s1) for _, _, s0, s1 in ev]
            span = ev[0][0].elapsed_time(ev[-1][3])
            runs.append({"wall_ms": wall, "copy_ms": sum(copy), "search_ms": sum(search),
                         "span_ms": span, "hidden_ms": sum(copy) + sum(search) - span,
                         "later_copies_ms": sum(copy[1:]),
                         "search_ms_per_block": sum(search) / len(search)})
    finally:
        index.stream_timing = False
    out = {key: statistics.median(r[key] for r in runs) for key in runs[0]}
    out["h2d_bytes"] = sum(nbytes(*(t for t in (b["corpus"], b["scales"]) if t is not None))
                           for b in index._stream_blocks)
    out["h2d_gb_s"] = out["h2d_bytes"] / out["copy_ms"] / 1e6
    return out


def host_ms(fn, reps: int = STREAM_REPS) -> float:
    """Median host-clock ms of a call that ends synchronised."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def plain_index_searches():
    """The indexer's searches through the kernels' plain versions."""
    import kirag_tpu_torch.index.indexer as indexer
    from kirag_tpu_torch.ops import approx_topk_mips, exact_topk_mips

    saved = indexer.approx_topk_mips, indexer.exact_topk_mips
    indexer.approx_topk_mips = functools.partial(approx_topk_mips, plain=True)
    indexer.exact_topk_mips = functools.partial(exact_topk_mips, plain=True)
    try:
        yield
    finally:
        indexer.approx_topk_mips, indexer.exact_topk_mips = saved


def result_arrays(results):
    """search_knn's per-query (ids, scores) as (vals [Q, k], row ids [Q, k])."""
    vals = torch.tensor(np.stack([s for _, s in results]))
    idx = torch.tensor([[int(i) for i in ids] for ids, _ in results])
    return vals, idx


def check_streamed(label, streamed, resident, queries) -> dict:
    """(b): the streamed exact search bitwise the resident one; the streamed
    approximate search (W = 1) against the same streamed search through the
    plain versions. Returns the streamed runs' launches."""
    from kirag_tpu_torch.kernels import reset_launch_counts

    reset_launch_counts()
    exact = streamed.search_knn(queries, K)
    approx = streamed.search_knn(queries, K, mode="approx")
    launches = main_path_counts()
    want = resident.search_knn(queries, K)
    for row, ((g_ids, g_vals), (w_ids, w_vals)) in enumerate(zip(exact, want)):
        if g_ids != w_ids or not np.array_equal(g_vals, w_vals):
            raise AssertionError(f"{label}: query {row}'s streamed exact search differs from "
                                 "the resident one")
    with plain_index_searches():
        plain = streamed.search_knn(queries, K, mode="approx")
    check_topk_close(*result_arrays(approx), *result_arrays(plain), f"{label} approx")
    quant = kernel_quant(streamed.compression)
    names = (kernel_names(streamed.compression)[0], k5_name(quant))
    if not all(launches[k] > 0 for k in names):
        raise AssertionError(f"{label}: a kernel of the streamed path was not launched: "
                             f"{launches}")
    log(f"  {label}: streamed exact search (Q={len(queries)}, k={K}) bitwise the resident "
        f"one; streamed approximate search (W=1) equal to its plain version; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def log_stream_times(label, t: dict, resident_ms: float, power) -> None:
    log(f"  [{power}] {label}: {t['wall_ms']:.1f} ms a search (host clock; resident "
        f"{resident_ms:.2f} ms), H2D {t['h2d_bytes'] / 1e9:.3f} GB at "
        f"{t['h2d_gb_s']:.2f} GB/s on the copy stream ({t['copy_ms']:.1f} ms), a block's "
        f"search {t['search_ms_per_block']:.2f} ms (events around the call), the copy hidden "
        f"{t['hidden_ms']:.2f} of {t['copy_ms']:.1f} ms ({t['later_copies_ms']:.1f} ms after "
        f"the first block's); event span {t['span_ms']:.1f} ms (CUDA events, medians of "
        f"{STREAM_REPS})")


def stream_server(encoder, collator, streamed, resident, texts, text_rows) -> dict:
    """(d): RetrievalEngine over a DenseRetriever whose index streams;
    STREAM_REQUESTS requests from 4 threads, every text's own row at top-1
    and every engine batch's ids and scores equal to the resident index's."""
    from kirag_tpu_torch.kernels import reset_launch_counts
    from kirag_tpu_torch.retrieval import DenseRetriever
    from kirag_tpu_torch.serving import RetrievalEngine

    recorder = RecordingIndex(streamed)
    engine = RetrievalEngine(DenseRetriever(encoder, collator, indexer=recorder, batch_size=32),
                             max_batch=32, max_wait_ms=5.0, topk_buckets=(10, K))
    recorder.calls.clear()
    requests = make_requests(STREAM_REQUESTS, len(texts))
    results, errors = {}, []

    def worker(mine):
        for r in mine:
            try:
                results[r] = engine.search([texts[i] for i in requests[r]], topk=K)
            except Exception as e:  # reported below
                errors.append(e)

    reset_launch_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(range(i, len(requests), 4),))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = main_path_counts()
    engine.close()
    if errors or any(t.is_alive() for t in threads) or len(results) != len(requests):
        raise RuntimeError(f"streamed server failed: {errors}")
    for r, request in enumerate(requests):
        for j, row in zip(request, results[r]):
            if row[0]["id"] != str(text_rows[j]):
                raise AssertionError(f"streamed server: text {j}'s top-1 is {row[0]['id']}, "
                                     f"not its own row {text_rows[j]}")
    for q, top_docs, out, _ in recorder.calls:
        for (g_ids, g_vals), (w_ids, w_vals) in zip(out, resident.search_knn(q, top_docs)):
            if g_ids != w_ids or not np.array_equal(g_vals, w_vals):
                raise AssertionError("streamed server: a batch's result differs from the "
                                     "resident index's")
    log(f"  (d) RetrievalEngine over the streamed float32 index: {len(requests)} requests from "
        f"4 threads in {len(recorder.calls)} searches, {wall:.2f} s (host clock); every text's "
        f"own row at top-1, every batch's ids and scores equal to the resident index's; "
        f"launches { {k: v for k, v in launches.items() if v} }")
    return launches


def write_host_tsv(path: Path, n: int) -> None:
    """A seeded DPR-format TSV of n passages, with quotes, doubled quotes,
    punctuation at the ends and short lines among them."""
    rng = np.random.RandomState(SEED)
    marks = ('"', "'", ".", "(", "", "", "", "")
    lines = ["id\ttext\ttitle"]
    for i in range(n):
        words = [WORDS[w] for w in rng.randint(0, len(WORDS), rng.randint(4, 40))]
        if i % 7 == 0:
            words.insert(1, '""quoted""')
        text = marks[i % 8] + " ".join(words) + marks[(i // 8) % 8]
        lines.append(f"{i}\t{text}\t{marks[i % 5]}{WORDS[i % len(WORDS)].title()}")
        if i % 1000 == 0:
            lines.append(f"short{i}\tonly two fields")
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


def host_pieces(work: Path, host: np.ndarray, dev, power) -> None:
    """(e): the port's host libraries built from csrc/host; load_psg_data's
    C++ parser against the Python loop on a seeded HOST_LINES-passage TSV;
    CPUFlatIndex over (a)'s first HOST_ROWS rows against the card's resident
    exact search of the same rows."""
    from kirag_tpu_torch.data.corpus import load_psg_data
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.index.native import CPUFlatIndex
    from kirag_tpu_torch.kernels.build import HOST_FLAGS, build_host

    built = {name: build_host(name) for name in ("tsv_corpus", "flat_index")}
    compilers = {name: info.log.splitlines()[0] if info.log else "cached"
                 for name, info in built.items()}
    log("  (e) " + " ".join(HOST_FLAGS) + ": " + ", ".join(
        f"{info.path.name} {info.seconds:.1f} s ({compilers[name]})"
        for name, info in built.items()))
    path = work / "host_passages.tsv"
    write_host_tsv(path, HOST_LINES)
    t0 = time.perf_counter()
    native = load_psg_data(str(path), native=True)
    t1 = time.perf_counter()
    python = load_psg_data(str(path), native=False)
    t2 = time.perf_counter()
    if len(native) != HOST_LINES or list(native) != python:
        raise AssertionError("load_psg_data: the C++ parser's rows differ from the Python loop's")
    rows = host[:HOST_ROWS]
    queries = rows[:: HOST_ROWS // HOST_QUERIES][:HOST_QUERIES]
    flat = CPUFlatIndex(DIM)
    flat.index_data(range(HOST_ROWS), rows)
    t3 = time.perf_counter()
    got = flat.search_knn(queries, K)
    t4 = time.perf_counter()
    card = TorchIndexer(DIM, device=dev, pallas_chunk_size=CHUNK)
    card.index_data(range(HOST_ROWS), rows)
    want = card.search_knn(queries, K)
    check_topk_close(*result_arrays(got), *result_arrays(want), "CPUFlatIndex vs the card")
    if [ids[0] for ids, _ in got] != [str(i * (HOST_ROWS // HOST_QUERIES))
                                       for i in range(HOST_QUERIES)]:
        raise AssertionError("CPUFlatIndex: a query's own row is not its top-1")
    same = sum(g == w for (g, _), (w, _) in zip(got, want))
    log(f"  (e) load_psg_data over {HOST_LINES} passages: the C++ parser's rows equal the "
        f"Python loop's ({(t1 - t0) * 1e3:.0f} against {(t2 - t1) * 1e3:.0f} ms, host clock); "
        f"CPUFlatIndex over {HOST_ROWS} x {DIM}: {same} of {HOST_QUERIES} queries' top-{K} ids "
        f"equal to the card's resident exact search, the rest at near-ties, values within "
        f"{ATOL} (add {(t3 - t2) * 1e3:.0f} ms, search {(t4 - t3) * 1e3:.0f} ms, host clock) "
        f"[{power}]")


def streaming(work: Path, encoder, collator, text_emb, texts, dev, gen, power) -> dict:
    """Phase 18: a corpus several times ``max_device_rows`` streamed through
    K1, K2 and K5 block by block from pinned host memory. (a) sizing, (b)
    streamed against resident (bitwise) and approximate against plain, (c)
    times, (d) the server over the streamed index, (e) the host C++.
    Returns the streamed runs' launches."""
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.kernels import reset_launch_counts

    t_phase = time.perf_counter()
    mem = meminfo()
    rows = STREAM_ROWS
    while mem["MemAvailable"] < 3 * rows * DIM * 4 and rows > 2 * STREAM_BLOCK:
        rows //= 2
        log(f"  (a) MemAvailable {mem['MemAvailable'] / 2**30:.1f} GiB is below 3x the "
            f"index's bytes: rows cut to {rows}")
    memlock = resource.getrlimit(resource.RLIMIT_MEMLOCK)
    log(f"  (a) host: MemTotal {mem['MemTotal'] / 2**30:.1f} GiB, MemAvailable "
        f"{mem['MemAvailable'] / 2**30:.1f} GiB; RLIMIT_MEMLOCK (soft, hard) {memlock}; "
        f"{rows} x {DIM} float32 rows ({rows * DIM * 4 / 1e9:.2f} GB), max_device_rows "
        f"{STREAM_BLOCK} ({-(-rows // STREAM_BLOCK)} blocks)")
    host, text_rows = stream_rows(rows, text_emb, gen, dev)
    queries = host[text_rows[:STREAM_QUERIES]]
    ids = range(rows)
    launches = []
    for compression in ("none", "int8"):
        label = f"{'float32' if compression == 'none' else compression} streamed index"
        kw = dict(device=dev, compression=compression, pallas_chunk_size=CHUNK)
        streamed = TorchIndexer(DIM, max_device_rows=STREAM_BLOCK, **kw)
        streamed.index_data(ids, host)
        t0 = time.perf_counter()
        streamed._prepare_stream_blocks()
        prep = time.perf_counter() - t0
        pinned = sum(nbytes(*(t for t in (b["corpus"], b["scales"]) if t is not None))
                     for b in streamed._stream_blocks)
        if not all(b["corpus"].is_pinned() for b in streamed._stream_blocks):
            raise AssertionError(f"{label}: a block is not in pinned memory")
        resident = TorchIndexer(DIM, **kw)
        resident.index_data(ids, host)
        resident.to_device()
        log(f"  (b) {label}: {len(streamed._stream_blocks)} blocks of {STREAM_BLOCK} rows "
            f"prepared in {prep:.1f} s (host clock), {pinned / 1e9:.3f} GB pinned")
        launches.append(check_streamed(label, streamed, resident, queries))
        reset_launch_counts()
        exact_t = stream_times(streamed, queries)
        approx_t = stream_times(streamed, queries, mode="approx")
        launches.append(main_path_counts())
        log(f"  (c) {label}: {STREAM_REPS} exact and {STREAM_REPS} approximate searches, "
            f"launches { {k: v for k, v in launches[-1].items() if v} }")
        resident_ms = host_ms(lambda: resident.search_knn(queries, K))
        log_stream_times(f"(c) {label}, exact", exact_t, resident_ms, power)
        log_stream_times(f"(c) {label}, approximate (W=1)", approx_t,
                         host_ms(lambda: resident.search_knn(queries, K, mode="approx")), power)
        if compression == "none":
            launches.append(stream_server(encoder, collator, streamed, resident, texts,
                                          text_rows))
        del streamed, resident
        torch.cuda.empty_cache()
    host_pieces(work, host, dev, power)
    seconds = time.perf_counter() - t_phase
    log(f"  phase 18: {seconds:.1f} s")
    return {"launches": launches, "seconds": seconds}


# ----------------------------------------------------------------- phase 19

# google/flan-t5-xl config.json, the standard public T5 reader: seeded
# weights at its full width and depth (about 2.85 B parameters, 5.7 GB bf16)
FLAN_T5_XL = {"vocab_size": 32128, "d_model": 2048, "d_kv": 64, "d_ff": 5120,
              "num_layers": 24, "num_decoder_layers": 24, "num_heads": 32,
              "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
              "feed_forward_proj": "gated-gelu", "tie_word_embeddings": False,
              "decoder_start_token_id": 0, "eos_token_id": 1, "pad_token_id": 0,
              "layer_norm_epsilon": 1e-6}
T5_EOS = 1
T5_PROMPTS = (512, 447, 371, 300)  # (a): tokens a row, right-padded to the 512 bucket
T5_NEW_TOKENS = 32                 # (a) and (c): AnswerGenerator's max_new_tokens
T5_SMALL_LAYERS = 2                # (b): the card against the CPU at 2 + 2 layers
T5_SMALL_PROMPTS = (128, 128)      # (b)
T5_SMALL_STEPS = 8                 # (b)
T5_EARLY_STEP = 4                  # (a): the step at which a row is made to finish
T5_TIMED_POSITIONS = (1, 16, 32)   # (a): decoder steps timed over this many positions
T5_QUEUE_CYCLES = 200_000_000      # (a): a spin of about 100 ms before each timed call
T5_TOP_OPS = 8                     # (d): the trace's device operations listed
TRACE_KERNEL_CAT = "kernel"        # (d): the Chrome trace's category of CUDA kernels


def t5_state_dict(cfg: dict, gen: torch.Generator, dev, dtype=torch.bfloat16) -> dict:
    """Seeded weights under HF T5's names on ``dev``, at HF's init scales
    (`T5PreTrainedModel._init_weights`, factor 1: unit embeddings, q at
    (d_model d_kv)^-1/2, k/v/wi and the relative-position biases at
    d_model^-1/2, o at (heads d_kv)^-1/2, wo at d_ff^-1/2) but the untied
    lm_head at d_model^-1/2 (unit-scale logits); norms 1 + 0.1 N(0, 1) in
    float32, every other tensor in ``dtype``."""
    d, inner, ff = cfg["d_model"], cfg["d_kv"] * cfg["num_heads"], cfg["d_ff"]

    def normal(*shape, std):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    def norm():
        return 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)

    sd = {"shared.weight": normal(cfg["vocab_size"], d, std=1.0)}
    if not cfg["tie_word_embeddings"]:
        sd["lm_head.weight"] = normal(cfg["vocab_size"], d, std=d ** -0.5)
    gated = cfg["feed_forward_proj"].startswith("gated")
    for stack, n_layers in (("encoder", cfg["num_layers"]),
                            ("decoder", cfg["num_decoder_layers"])):
        for i in range(n_layers):
            p = f"{stack}.block.{i}.layer"
            attns = ["0.SelfAttention"] + (["1.EncDecAttention"] if stack == "decoder" else [])
            for attn in attns:
                sd[f"{p}.{attn}.q.weight"] = normal(inner, d, std=(d * cfg["d_kv"]) ** -0.5)
                for name in "kv":
                    sd[f"{p}.{attn}.{name}.weight"] = normal(inner, d, std=d ** -0.5)
                sd[f"{p}.{attn}.o.weight"] = normal(d, inner, std=inner ** -0.5)
                sd[f"{p}.{attn.split('.')[0]}.layer_norm.weight"] = norm()
            ffp = f"{p}.{len(attns)}"
            for name in (("wi_0", "wi_1") if gated else ("wi",)):
                sd[f"{ffp}.DenseReluDense.{name}.weight"] = normal(ff, d, std=d ** -0.5)
            sd[f"{ffp}.DenseReluDense.wo.weight"] = normal(d, ff, std=ff ** -0.5)
            sd[f"{ffp}.layer_norm.weight"] = norm()
        sd[f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = normal(
            cfg["relative_attention_num_buckets"], cfg["num_heads"], std=d ** -0.5)
        sd[f"{stack}.final_layer_norm.weight"] = norm()
    return sd


class T5StandInTokenizer(ByteLevelTokenizer):
    """Stand-in for T5's sentencepiece vocabulary (not in the repository):
    pad 0, eos 1, unk 2, ids 3-258 the UTF-8 bytes, every other id below
    32,128 one fixed word of WORDS. ``add_special_tokens`` appends eos, as
    T5's tokenizer does. Callable as the Generator calls a HuggingFace
    tokenizer."""

    SPECIAL = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    OFFSET = 3
    eos_token_id = T5_EOS
    pad_token_id = 0

    def encode(self, text: str, add_special_tokens: bool = True):
        ids = [b + self.OFFSET for b in text.encode()]
        return ids + [self.eos_token_id] if add_special_tokens else ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out, run = [], bytearray()
        for i in (int(i) for i in ids):
            if self.OFFSET <= i < self.OFFSET + 256:
                run.append(i - self.OFFSET)
                continue
            out.append(run.decode(errors="replace"))
            run = bytearray()
            if i in self.names:
                out.append("" if skip_special_tokens else self.names[i])
            else:
                out.append(" " + WORDS[i % len(WORDS)])
        out.append(run.decode(errors="replace"))
        return "".join(out)


def right_padded_prompts(lengths, vocab: int, seed: int):
    rng = np.random.RandomState(seed)
    ids = np.zeros((len(lengths), max(lengths)), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.randint(T5StandInTokenizer.OFFSET, vocab, n)
        mask[i, :n] = 1
    return ids, mask


def t5_step_ms(fn, reps: int = 5) -> float:
    """Median device ms of ``fn`` by CUDA events, a spin of T5_QUEUE_CYCLES
    before each call keeping the card busy while the host enqueues it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(T5_QUEUE_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_argmax_and_eos(ids: np.ndarray, logits: np.ndarray, eos: int, what: str) -> None:
    """Every id is its step's argmax until the row's first eos, and eos
    after it."""
    for row in range(len(ids)):
        hit = np.nonzero(ids[row] == eos)[0]
        upto = int(hit[0]) + 1 if len(hit) else ids.shape[1]
        if not (np.array_equal(ids[row, :upto], np.argmax(logits[row, :upto], axis=-1))
                and (ids[row, upto:] == eos).all()):
            raise AssertionError(f"{what}, row {row}: an id is not its step's argmax, or a "
                                 "finished row did not emit eos")


def t5_generation(params, config, dev, power) -> dict:
    """Phase 19 (a): TorchT5Backend at Flan-T5-XL width, bf16, 4 right-padded
    prompts of 300-512 tokens, 32 new tokens: ids the argmax of their
    logits; a row made to finish early emits eos; against the same weights
    at float32 compute up to each row's first near-tie; encoder ms, a
    decoder step's ms and the call's wall time."""
    from kirag_tpu_torch.models import t5

    backend = t5.TorchT5Backend(params, config, eos_token_id=T5_EOS, device=dev)
    ids, mask = right_padded_prompts(T5_PROMPTS, config.vocab_size, SEED)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_ids, got_logits = backend.greedy(ids, mask, T5_NEW_TOKENS)
        walls.append(time.perf_counter() - t0)
    if not (got_ids.shape == (len(T5_PROMPTS), T5_NEW_TOKENS)
            and got_logits.shape == (*got_ids.shape, config.vocab_size)
            and np.isfinite(got_logits).all()):
        raise AssertionError(f"T5 bf16: ids {got_ids.shape}, logits {got_logits.shape} or "
                             "not finite")
    check_argmax_and_eos(got_ids, got_logits, T5_EOS, "T5 bf16")
    # a row made to finish early: eos := the token row 0 emits at T5_EARLY_STEP
    early = int(got_ids[0, T5_EARLY_STEP])
    first = int(np.argmax(got_ids[0] == early))
    e_ids, e_logits = t5.t5_greedy_decode(params, ids, mask, config, T5_NEW_TOKENS,
                                          torch.bfloat16, eos_token_id=early)
    e_ids, e_logits = e_ids.cpu().numpy(), e_logits.cpu().numpy()
    check_argmax_and_eos(e_ids, e_logits, early, "T5 bf16, early eos")
    for row in range(len(e_ids)):
        hit = np.nonzero(got_ids[row] == early)[0]
        upto = int(hit[0]) + 1 if len(hit) else T5_NEW_TOKENS
        if not np.array_equal(e_ids[row, :upto], got_ids[row, :upto]):
            raise AssertionError(f"T5 early eos, row {row}: ids differ from the first run "
                                 "before the row finished")
    if not (e_ids[0, first:] == early).all():
        raise AssertionError("T5 early eos: row 0 did not finish")
    # the same weights at float32 compute (each kernel cast to f32 per product)
    f32_ids, f32_logits = t5.t5_greedy_decode(params, ids, mask, config, T5_NEW_TOKENS,
                                              torch.float32, eos_token_id=T5_EOS)
    f32_ids, f32_logits = f32_ids.cpu().numpy(), f32_logits.cpu().numpy()
    tol = LOGIT_TOL * float(np.abs(f32_logits[:, 0]).max())
    step0_gap = float(np.abs(got_logits[:, 0] - f32_logits[:, 0]).max())
    if not step0_gap <= tol:
        raise AssertionError(f"T5 bf16 against f32: the first step's logits differ by "
                             f"{step0_gap} > {tol}")
    agree = near_tie_agreement(got_ids, f32_ids, f32_logits, tol, "T5 bf16 against f32",
                               through_tie=False)
    margins = np.diff(np.sort(f32_logits, axis=-1)[..., -2:], axis=-1)[..., 0]
    log(f"  (a) Flan-T5-XL geometry ({config.num_layers} + {config.num_decoder_layers} layers "
        f"x {config.d_model}, {config.num_heads} heads x {config.d_kv}, d_ff {config.d_ff} "
        f"{config.feed_forward_proj}, vocab {config.vocab_size}, untied lm_head), bf16: "
        f"{len(T5_PROMPTS)} prompts of {list(T5_PROMPTS)} tokens (bucket "
        f"{next(b for b in backend.prompt_buckets if b >= ids.shape[1])}), {T5_NEW_TOKENS} "
        "new tokens; every id its step's "
        f"argmax; eos := row 0's token at step {T5_EARLY_STEP} ({early}) finished row 0 at "
        f"step {first} and it emitted eos after; against f32 compute: first step's logits "
        f"within {step0_gap:.4g} (tolerance {tol:.4g} = {LOGIT_TOL} x max |logit|), ids equal "
        f"for {agree} tokens a row (each up to its first near-tie, {int((margins < tol).sum())} "
        f"of {margins.size} steps near-ties)")

    ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)
    mask_t = torch.as_tensor(mask, dtype=torch.long, device=dev)
    enc_ms = t5_step_ms(lambda: t5.t5_encode(params, ids_t, mask_t, config, torch.bfloat16))
    with torch.inference_mode():
        enc = t5.t5_encode(params, ids_t, mask_t, config, torch.bfloat16)
        enc_valid = mask_t.to(torch.bool)[:, None, None, :]
        self_bias, causal = t5._decoder_masks(params, T5_NEW_TOKENS, config)
        dec = torch.as_tensor(np.concatenate([np.zeros((len(ids), 1), np.int64), got_ids], 1),
                              device=dev)

        def step(n):
            x = t5._decoder_hidden(params, dec[:, :n], enc, enc_valid, config, torch.bfloat16,
                                   self_bias[:, :, :n, :n], causal[:, :, :n, :n])
            return t5._logits(params, x[:, n - 1], config)

        step_ms = {n: t5_step_ms(functools.partial(step, n)) for n in T5_TIMED_POSITIONS}
    log(f"  [{power}] (a) encoder {enc_ms:.3f} ms ({len(ids)} x {ids.shape[1]} tokens); a "
        "decoder step over " + ", ".join(f"{n} positions {ms:.3f} ms" for n, ms in
                                          step_ms.items())
        + " (CUDA events around one call after a 100 ms spin, median of 5); the call "
        f"({T5_NEW_TOKENS} steps, host clock to the host read): "
        + " / ".join(f"{w * 1e3:.1f}" for w in walls)
        + f" ms, {walls[-1] * 1e3 / T5_NEW_TOKENS:.2f} ms a step")
    return {"ids": got_ids, "logits": got_logits, "wall_s": walls, "encoder_ms": enc_ms,
            "step_ms": step_ms, "agree": agree, "backend": backend, "inputs": (ids, mask)}


def t5_card_vs_cpu(dev, power) -> None:
    """Phase 19 (b): at Flan-T5-XL width but 2 + 2 layers, the port at
    float32 on the card and on the CPU, the same seeded weights, 2 prompts
    of 128 tokens, 8 steps: ids equal, logits within 1e-4 of the largest."""
    from kirag_tpu_torch.models import t5

    cfg = {**FLAN_T5_XL, "num_layers": T5_SMALL_LAYERS, "num_decoder_layers": T5_SMALL_LAYERS}
    config = t5.config_from_hf(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    card = t5.convert_hf_t5_state_dict(t5_state_dict(cfg, gen, dev, torch.float32), config)
    host = t5._map_tree(lambda x: x.cpu(), card)
    ids, mask = right_padded_prompts(T5_SMALL_PROMPTS, config.vocab_size, SEED + 1)
    out = {}
    for where, params, device in (("card", card, dev), ("cpu", host, "cpu")):
        backend = t5.TorchT5Backend(params, config, eos_token_id=T5_EOS,
                                    compute_dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        out[where] = (*backend.greedy(ids, mask, T5_SMALL_STEPS), time.perf_counter() - t0)
    (c_ids, c_logits, c_s), (h_ids, h_logits, h_s) = out["card"], out["cpu"]
    gap = float(np.abs(c_logits - h_logits).max())
    tol = ATOL * float(np.abs(h_logits).max())
    if not (np.array_equal(c_ids, h_ids) and gap <= tol):
        raise AssertionError(f"T5 f32, card against CPU: ids equal {np.array_equal(c_ids, h_ids)}"
                             f", logits {gap} > {tol}")
    log(f"  [{power}] (b) {T5_SMALL_LAYERS} + {T5_SMALL_LAYERS} layers at Flan-T5-XL width, "
        f"f32, {len(ids)} prompts of {T5_SMALL_PROMPTS[0]} tokens, {T5_SMALL_STEPS} steps: ids "
        f"equal on the card and the CPU, logits within {gap:.3g} (tolerance {tol:.3g} = {ATOL} "
        f"x max |logit|); card {c_s:.2f} s, CPU {h_s:.2f} s (host clock)")


def t5_reader(run_e_path: str, backend, power) -> dict:
    """Phase 19 (c): qa_eval.evaluate over run E's results at k = QA_K with
    an AnswerGenerator(is_chat=False) over (a)'s TorchT5Backend: a prediction
    for every question, EM and F1."""
    from kirag_tpu_torch.cli.qa_eval import evaluate
    from kirag_tpu_torch.generation import AnswerGenerator

    data = json.loads(Path(run_e_path).read_text())
    reader = AnswerGenerator(T5StandInTokenizer(), backend, model_name="flan-t5-xl",
                             is_chat=False, max_new_tokens=T5_NEW_TOKENS, batch_size=4)
    t0 = time.perf_counter()
    em, f1, preds = evaluate(data, reader, QA_K, batch_size=4)
    wall = time.perf_counter() - t0
    if not (len(preds) == len(data) and all(isinstance(p, str) for p in preds)
            and np.isfinite([em, f1]).all()):
        raise AssertionError(f"T5 reader: {len(preds)} predictions for {len(data)} questions, "
                             f"or EM/F1 {em}/{f1}")
    log(f"  [{power}] (c) qa_eval.evaluate over run E's {len(data)} questions at k={QA_K}, "
        f"AnswerGenerator(is_chat=False) over TorchT5Backend (Flan-T5-XL geometry, bf16): a "
        f"prediction each ({[p[:40] for p in preds]!r}), EM {em:.5f} F1 {f1:.5f}; {wall:.2f} s")
    return {"em": em, "f1": f1, "wall": wall}


def kernels_by_range(events, kernels, names) -> dict:
    """Each kernel of a Chrome trace attributed to the ``names`` span (a
    ``record_function`` range on the host) in which it was launched (its
    launch found by correlation id; a CPU op by its own start): {name:
    [kernels, device us]}."""
    import bisect

    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") in names)
    starts = [r[0] for r in ranges]
    out = {name: [0, 0.0] for name in names}
    for k in kernels:
        ts = launched.get(k.get("args", {}).get("correlation"), k["ts"])
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= ranges[i][1]:
            out[ranges[i][2]][0] += 1
            out[ranges[i][2]][1] += k.get("dur", 0.0)
    return out


def t5_traced(work: Path, generated: dict, power) -> dict:
    """Phase 19 (d): (a)'s bf16 call inside the port's trace() and
    annotate("t5.greedy"), the encoder and each decoder step inside an
    annotate span and a StepTimer step: the Chrome trace holds the span and
    CUDA kernels; the top device operations by time, each span's kernels
    and device time, and the timer's summary."""
    from kirag_tpu_torch.models import t5
    from kirag_tpu_torch.utils.tracing import StepTimer, annotate, trace

    timer = StepTimer(log_file=str(work / "t5_steps.jsonl"))
    encode, hidden = t5.t5_encode, t5._decoder_hidden

    def timed(name, fn):
        def run(*args, **kwargs):
            out = []
            with annotate(name), timer.step(name, block=out):
                out.append(fn(*args, **kwargs))
            return out[0]
        return run

    t5.t5_encode = timed("t5.encode", encode)
    t5._decoder_hidden = timed("t5.decoder_step", hidden)
    ids, mask = generated["inputs"]
    try:
        t0 = time.perf_counter()
        with trace(str(work / "t5_trace")) as log_dir:
            profile_lead_in()
            with annotate("t5.greedy"):
                got_ids, _ = generated["backend"].greedy(ids, mask, T5_NEW_TOKENS)
        traced_s = time.perf_counter() - t0
    finally:
        t5.t5_encode, t5._decoder_hidden = encode, hidden
        timer.close()
    if not np.array_equal(got_ids, generated["ids"]):
        raise AssertionError("T5 traced call: ids differ from (a)'s")
    paths = sorted(Path(log_dir).glob("*.pt.trace.json"))
    if len(paths) != 1:
        raise AssertionError(f"trace(): {len(paths)} Chrome traces under {log_dir}")
    size = paths[0].stat().st_size
    events = json.loads(paths[0].read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "t5.greedy"
             and e.get("cat") == "user_annotation"]
    kernels = [e for e in events
               if e.get("cat") == TRACE_KERNEL_CAT and SPIN_KERNEL not in e["name"]]
    if not (spans and kernels):
        raise AssertionError(f"the Chrome trace holds {len(spans)} t5.greedy spans and "
                             f"{len(kernels)} CUDA kernels")
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0.0)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:T5_TOP_OPS]
    parts = kernels_by_range(events, kernels, ("t5.encode", "t5.decoder_step"))
    summary = timer.summary()
    steps = summary["t5.decoder_step"]
    lines = (work / "t5_steps.jsonl").read_text().splitlines()
    if not (summary["t5.encode"]["count"] == 1 and steps["count"] == T5_NEW_TOKENS
            and len(lines) == 1 + T5_NEW_TOKENS and parts["t5.decoder_step"][0] > 0):
        raise AssertionError(f"StepTimer: {summary}, {len(lines)} JSONL lines; kernels by "
                             f"span {parts}")
    span_ms = spans[0]["dur"] / 1e3
    (enc_n, enc_us), (dec_n, dec_us) = parts["t5.encode"], parts["t5.decoder_step"]
    log(f"  [{power}] (d) trace(): {paths[0].name}, {size / 1e6:.1f} MB, {len(events)} events, "
        f"the t5.greedy span {span_ms:.1f} ms, {len(kernels)} CUDA kernels busy "
        f"{busy / 1e3:.1f} ms, idle {100 * (1 - busy / 1e3 / span_ms):.1f}% of the span (the "
        f"StepTimer waits on every step); the encoder {enc_n} kernels {enc_us / 1e3:.2f} ms, a "
        f"decoder step {dec_n / T5_NEW_TOKENS:.0f} kernels {dec_us / 1e3 / T5_NEW_TOKENS:.3f} "
        f"ms of device time (mean of {T5_NEW_TOKENS}); the traced call {traced_s:.2f} s with "
        "the trace's export; top device operations: " + "; ".join(
            f"{name[:60]} {us / 1e3:.2f} ms ({100 * us / busy:.1f}%)" for name, us in top))
    log(f"  [{power}] (d) StepTimer: encoder {summary['t5.encode']['mean_s'] * 1e3:.2f} ms; "
        f"{steps['count']} decoder steps mean {steps['mean_s'] * 1e3:.2f} ms, p50 "
        f"{steps['p50_s'] * 1e3:.2f}, p95 {steps['p95_s'] * 1e3:.2f}, total "
        f"{steps['total_s'] * 1e3:.1f} ms (host clock, each step waited on, profiled)")
    return {"busy_ms": busy / 1e3, "span_ms": span_ms, "top": top, "summary": summary,
            "encoder_kernels": enc_n, "encoder_device_ms": enc_us / 1e3,
            "step_kernels": dec_n / T5_NEW_TOKENS,
            "step_device_ms": dec_us / 1e3 / T5_NEW_TOKENS}


def t5_host_checks(work: Path, dev) -> None:
    """Phase 19 (e): preprocessing.odqa.main over tiny synthetic 2wiki files
    writes the five outputs and is_comparison_map.pkl, which read back; a
    WandbTracker over a stub module records a trainer step's record."""
    import pickle

    from kirag_tpu_torch.preprocessing import odqa
    from kirag_tpu_torch.training.trainer import BaseTrainer, TrainerConfig
    from kirag_tpu_torch.utils.wandb_tracker import WandbTracker

    raw, out = work / "odqa_raw", work / "odqa"
    raw.mkdir()

    def example(qid, a, b, kind):
        return {"_id": qid, "question": f"Which came first, {a} or {b}?", "answer": a,
                "type": kind, "context": [[t, [f"{t} opened in {1900 + len(t)}.", "It grew."]]
                                          for t in (a, b)],
                "supporting_facts": [[a, 0], [b, 1]]}

    train = [example(f"q{i}", f"Town {i}", f"Town {i + 1}",
                     "comparison" if i % 2 else "bridge") for i in range(6)]
    (raw / "train.json").write_text(json.dumps(train))
    (raw / "dev.json").write_text(json.dumps([example("d0", "Town 2", "City 0", "comparison")]))
    (raw / "test.json").write_text(json.dumps([]))
    odqa.main(["--dataset", "2wikimultihopqa", "--raw_dir", str(raw), "--save_dir", str(out),
               "--num_dev_data", "2"])
    corpus = json.loads((out / "corpus.json").read_text())
    qrels = (out / "qrels.tsv").read_text().splitlines()
    splits = [json.loads((out / f"{s}_qa_pairs.json").read_text()) for s in ("train", "dev",
                                                                            "test")]
    with open(out / "is_comparison_map.pkl", "rb") as f:
        cmp_map = pickle.load(f)
    if not (len(corpus) == 8 and len(qrels) == 14 and [len(s) for s in splits] == [4, 2, 1]
            and cmp_map["q1"] and not cmp_map["q0"] and len(cmp_map) == 7):
        raise AssertionError(f"odqa: {len(corpus)} docs, {len(qrels)} qrels, splits "
                             f"{[len(s) for s in splits]}, map {cmp_map}")

    class Stub:
        def __init__(self):
            self.calls = []

        def init(self, **kw):
            self.calls.append(("init", kw))

        def log(self, metrics, step=None):
            self.calls.append(("log", metrics, step))

        def finish(self):
            self.calls.append(("finish",))

    class Regression(BaseTrainer):
        def loss_fn(self, model, batch):
            return torch.mean((model(batch["x"]) - batch["y"]) ** 2)

    class OneBatch(list):
        def set_epoch(self, epoch):
            pass

    rng = np.random.RandomState(SEED)
    stub = Stub()
    tracker = WandbTracker(project="kirag-smoke", config={"lr": 1e-2}, wandb_module=stub)
    trainer = Regression(torch.nn.Linear(8, 1, device=dev),
                         TrainerConfig(learning_rate=1e-2, num_train_epochs=1, log_steps=1,
                                       save_dir=str(work / "wandb_run")),
                         OneBatch([{"x": rng.standard_normal((4, 8)).astype(np.float32),
                                    "y": rng.standard_normal((4, 1)).astype(np.float32)}]),
                         trackers=[tracker])
    trainer.train()
    tracker.finish()
    logs = [c for c in stub.calls if c[0] == "log"]
    if not (len(logs) == 1 and logs[0][2] == 1 and np.isfinite(logs[0][1]["loss"])
            and stub.calls[-1] == ("finish",)):
        raise AssertionError(f"WandbTracker: {stub.calls}")
    log(f"  (e) odqa.main (2wikimultihopqa): {len(corpus)} docs, {len(qrels)} qrels, splits "
        f"{[len(s) for s in splits]}, is_comparison_map.pkl of {len(cmp_map)} read back; "
        f"WandbTracker over a stub: init, one step's record ({sorted(logs[0][1])} at step "
        f"{logs[0][2]}) from the port's trainer on the card, finish")


def t5_phase(work: Path, run_e_path: str, dev, power) -> dict:
    """Phase 19: the T5 reader backend at Flan-T5-XL width (seeded weights
    built on the card under HF's names, through convert_hf_t5_state_dict),
    (a)-(e); no kernel of the port is on its path."""
    from kirag_tpu_torch.kernels import launch_counts, reset_launch_counts
    from kirag_tpu_torch.models import t5

    t_phase = time.perf_counter()
    config = t5.config_from_hf(FLAN_T5_XL)
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = t5_state_dict(FLAN_T5_XL, gen, dev)
    params = t5.convert_hf_t5_state_dict(sd, config)
    del sd
    params = t5.cast_t5_params(params, torch.bfloat16)
    torch.cuda.synchronize()
    leaves = []
    t5._map_tree(leaves.append, params)
    log(f"  seeded Flan-T5-XL state dict under HF's names (google/flan-t5-xl config.json) "
        f"built on the card and converted in {time.perf_counter() - t0:.1f} s: "
        f"{sum(x.numel() for x in leaves) / 1e9:.3f} B parameters, "
        f"{sum(x.numel() * x.element_size() for x in leaves) / 1e9:.3f} GB; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB while building")
    reset_launch_counts()
    generated = t5_generation(params, config, dev, power)
    t5_card_vs_cpu(dev, power)
    reader = t5_reader(run_e_path, generated["backend"], power)
    traced = t5_traced(work, generated, power)
    launched = {k: v for k, v in launch_counts().items() if v}
    if launched:
        raise AssertionError(f"phase 19 launched kernels of the port: {launched}")
    t5_host_checks(work, dev)
    del params, generated["backend"]
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"  phase 19: {seconds:.1f} s; no kernel of the port launched (the T5 path is "
        "cuBLAS and PyTorch's own kernels)")
    return {"seconds": seconds, "reader": reader, "traced": traced,
            "encoder_ms": generated["encoder_ms"], "step_ms": generated["step_ms"],
            "wall_s": generated["wall_s"]}

# ---------------------------------------------------------------- phase 20

MESH_QUERIES = (8, 32)                # (a), (b): query batches
MESH_FORMATS = ("float32", "bfloat16", "int8", "int4", "pq4")
MESH_RANKS = 2                        # (b): ranks on the one card, over gloo
MESH_LLM_PROMPT = 64                  # (b): tokens of each of the 4 prompts
MESH_LLM_STEPS = 16                   # (b): tokens decoded a run
MESH_F32_LAYERS = 2                   # (b): the f32 run's depth
MESH_TIMEOUT = 360                    # s: (b)'s and (c)'s processes
MESH_GATHER = (32, 100)               # (a): the timed all_gather_cols
# (d): the sharded engine's runs, (compression, mode, requests from 4 threads)
MESH_ENGINE_RUNS = (("none", "exact", 200), ("none", "approx", 100), ("int8", "exact", 100))
MESH_QUERY_TOKENS = 128               # (d): the queries' padded length (K3 takes 128-token tiles)


def nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


def mesh_formats(fmt: str, rows: torch.Tensor, gen, dev):
    """(corpus, scales, quant) of the padded rows in one of MESH_FORMATS:
    int8/int4 quantized on the card (pad rows zero codes and scales), pq4
    random codes with a seeded level table (no training, as phase 15)."""
    from kirag_tpu_torch.ops import quantize_rows_int4_torch, quantize_rows_int8_torch

    if fmt == "float32":
        return rows, None, None
    if fmt == "bfloat16":
        return rows.to(torch.bfloat16), None, None
    if fmt in ("int8", "int4"):
        quantize = quantize_rows_int8_torch if fmt == "int8" else quantize_rows_int4_torch
        codes, scales = quantize(rows)
        return codes, scales, None
    codes, table = pq_corpus(PQ_M, len(rows), gen, dev, integer=False)
    return codes, table, "pq4"


def mesh_searches(corpus, scales, quant, q, n_valid, mesh, local=True) -> dict:
    """The exact (capdom) and, but for pq4, the approximate (W = 1) search:
    sharded over ``mesh`` (``local``: this rank's shard) or unsharded."""
    from kirag_tpu_torch import ops
    from kirag_tpu_torch.parallel import shard_rows

    if local:
        corpus = shard_rows(corpus, mesh)
        if scales is not None and quant != "pq4":
            scales = shard_rows(scales, mesh)
    args = (mesh,) if local else ()
    prefix = "sharded_" if local else ""
    out = {"exact": getattr(ops, prefix + "exact_topk_mips")(
        q, corpus, K, *args, chunk_size=CHUNK, valid_rows=n_valid, scales=scales,
        quant=quant, **CAPDOM)}
    if quant != "pq4":
        out["approx"] = getattr(ops, prefix + "approx_topk_mips")(
            q, corpus, K, *args, valid_rows=n_valid, scales=scales, winners_per_group=1)
    return out


def mesh_rank(rank: int, store: str, out: str) -> None:
    """Phase 20 (b) and (d), one of MESH_RANKS processes on the one card over
    gloo (spawned; loads the library the parent built): writes what
    :func:`mesh_rank_work` returns, or the traceback, to ``out``."""
    import pickle
    import traceback

    import torch.distributed as dist

    try:
        result = mesh_rank_work(rank, store)
    except BaseException:
        result = {"error": traceback.format_exc()}
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(result, f)


def mesh_rank_work(rank: int, store: str) -> dict:
    """Every rank makes the same seeded N_ROWS x DIM rows on the card, padded
    to the chunk grid of two shards (so the valid rows end inside shard 1),
    keeps its shard, and searches it in five formats at Q = 8 and 32; the
    first rank also searches the whole corpus. Then (d), the sharded
    engine over the same rows with phase 4's texts at their rows
    (:func:`mesh_engine`), and Llama TP over the model axis at phase 9's
    depth (bf16) and at MESH_F32_LAYERS (f32), the first rank decoding the
    unsharded params too. The kernels' launches are the sharded runs' only."""
    import torch.distributed as dist

    from kirag_tpu_torch.kernels import launch_counts, load_library, reset_launch_counts
    from kirag_tpu_torch.models import llm
    from kirag_tpu_torch.parallel import create_mesh, distributed_init

    dev = distributed_init(num_processes=MESH_RANKS, process_id=rank, backend="gloo",
                           init_method=f"file://{store}", timeout_s=MESH_TIMEOUT / 2)
    load_library()
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    unit = CHUNK * MESH_RANKS
    n_pad = -(-N_ROWS // unit) * unit
    rows = torch.zeros(n_pad, DIM, device=dev)
    rows[:N_ROWS] = unit_rows(N_ROWS, gen, dev)
    queries = {n: unit_rows(n, gen, dev) for n in MESH_QUERIES}
    mesh = create_mesh(MESH_RANKS, 1)
    counts, results, checks = None, {}, []

    def add_counts():
        nonlocal counts
        c = launch_counts()
        counts = c if counts is None else {k: counts[k] + c[k] for k in c}

    t0 = time.perf_counter()
    for fmt in MESH_FORMATS:
        corpus, scales, quant = mesh_formats(fmt, rows, gen, dev)
        for n_q in MESH_QUERIES:
            q = queries[n_q].to(corpus.dtype) if fmt == "bfloat16" else queries[n_q]
            reset_launch_counts()
            got = mesh_searches(corpus, scales, quant, q, N_ROWS, mesh)
            add_counts()
            for mode, (vals, idx) in got.items():
                results[(fmt, n_q, mode)] = (vals.cpu(), idx.cpu())
            if rank == 0:
                want = mesh_searches(corpus, scales, quant, q, N_ROWS, mesh, local=False)
                for mode, (vals, idx) in want.items():
                    g = results[(fmt, n_q, mode)]
                    if not (torch.equal(g[0], vals.cpu()) and torch.equal(g[1], idx.cpu())):
                        raise AssertionError(f"{fmt} Q={n_q} {mode}: the merged search is "
                                             "not bitwise the unsharded kernel search")
                    checks.append((fmt, n_q, mode))
        del corpus, scales
    search_s = time.perf_counter() - t0
    engine = mesh_engine(rank, mesh, rows, dev)
    counts = {k: counts[k] + engine["counts"][k] for k in counts}
    del rows
    torch.cuda.empty_cache()

    # Llama TP at M = MESH_RANKS: phase 9's model, bf16, then f32 at 2 layers
    t0 = time.perf_counter()
    config = dataclasses.replace(llm.LlamaConfig(), int4_impl="kernel",
                                 num_hidden_layers=KIRAG_LAYERS)
    params = llm.init_llama_params(config, seed=SEED, device=dev, dtype=torch.bfloat16,
                                   quant_bits=4)
    ids, mask = left_padded_prompts((MESH_LLM_PROMPT,) * LLM_ROWS, config.vocab_size,
                                    SEED + 20)
    config32 = dataclasses.replace(config, num_hidden_layers=MESH_F32_LAYERS)
    params32 = {**params, "layers": params["layers"][:MESH_F32_LAYERS]}
    decoded = {}
    if rank == 0:
        decoded["bf16"] = llm.greedy_decode(params, ids, mask, config, MESH_LLM_STEPS,
                                            torch.bfloat16)
        decoded["f32"] = llm.greedy_decode(params32, ids, mask, config32, MESH_LLM_STEPS,
                                           torch.float32)
    tp_mesh = create_mesh(1, MESH_RANKS)
    backend = llm.TorchLlamaBackend(params, config, eos_token_id=EOS_ID)
    whole = llm.param_bytes(params)
    backend.shard_params(tp_mesh)
    here = llm.param_bytes(backend.params)
    sharded32 = llm.shard_llama_params(params32, config32, tp_mesh)
    del params, params32
    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tp = {"bf16": llm.greedy_decode(backend.params, ids, mask, config, MESH_LLM_STEPS,
                                    torch.bfloat16)}
    torch.cuda.synchronize()
    tp_s = time.perf_counter() - t1
    k6 = launch_counts()["int4_matmul"]
    add_counts()
    reset_launch_counts()
    tp["f32"] = llm.greedy_decode(sharded32, ids, mask, config32, MESH_LLM_STEPS, torch.float32)
    add_counts()
    llm_s = time.perf_counter() - t0
    per_step = 7 * KIRAG_LAYERS + 1
    if k6 != per_step * (MESH_LLM_STEPS - 1):
        raise AssertionError(f"TP decode: {k6} K6 launches, not {per_step} a step")
    tp_np = {k: (v[0].cpu().numpy(), v[1].cpu().numpy()) for k, v in tp.items()}
    llm_checks = {}
    if rank == 0:
        ref = {k: (v[0].cpu().numpy(), v[1].cpu().numpy()) for k, v in decoded.items()}
        (got_ids, got_lg), (ref_ids, ref_lg) = tp_np["bf16"], ref["bf16"]
        tol = LOGIT_TOL * float(np.abs(ref_lg[:, 1]).max())
        err = float(np.abs(got_lg[:, :2] - ref_lg[:, :2]).max())
        if not (err <= tol and np.isfinite(got_lg).all()):
            raise AssertionError(f"TP bf16: the prefill's and first step's logits differ from "
                                 f"the unsharded decode's by {err} > {tol}")
        agree = near_tie_agreement(got_ids, ref_ids, ref_lg, tol, "TP bf16 against unsharded")
        (got32, lg32), (ref32, ref_lg32) = tp_np["f32"], ref["f32"]
        tol32 = LOGIT_TOL_F32 * float(np.abs(ref_lg32).max())
        err32 = float(np.abs(lg32 - ref_lg32).max())
        if not (np.array_equal(got32, ref32) and err32 <= tol32):
            raise AssertionError(f"TP f32: ids differ from the unsharded decode's, or logits "
                                 f"by {err32} > {tol32}")
        llm_checks = {"err": err, "tol": tol, "agree": agree, "err32": err32, "tol32": tol32}
    dist.barrier()
    dist.destroy_process_group()
    return {"rank": rank, "counts": counts, "results": results, "checks": checks,
            "engine": engine, "llm": tp_np, "llm_checks": llm_checks, "bytes": (whole, here), "k6": k6,
            "search_s": search_s, "llm_s": llm_s, "tp_step_ms": 1e3 * tp_s / MESH_LLM_STEPS,
            "device": str(dev)}


def mesh_engine(rank: int, mesh, rows: torch.Tensor, dev) -> dict:
    """Phase 20 (d) on one rank: RetrievalEngine over ``TorchIndexer(mesh=)``
    of the first N_ROWS of ``rows`` (float32, then int8), for each of
    MESH_ENGINE_RUNS. Every rank builds the same retriever (phase 4's seeded
    E5-large, bf16; the queries padded to 128 tokens, so that the encoder
    runs K3); the first rank embeds phase 4's texts, which every rank writes
    at phase 4's rows. Each rank constructs the engine; the first rank
    leads and serves phase 4's traffic (:func:`drive_engine`), then closes,
    while the other rank's constructor follows its batches. The leader then
    holds every batch its index searched bitwise against its own unsharded
    kernel search of the same queries, and each text's own row at top-1.
    Returns the runs' launches (reset before each engine, read after it
    closed), each search's results and the leader's traffic."""
    from kirag_tpu_torch.data import E5Collator
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.kernels import launch_counts, reset_launch_counts
    from kirag_tpu_torch.models import BertConfig, BertModel, Encoder
    from kirag_tpu_torch.parallel import broadcast
    from kirag_tpu_torch.retrieval import DenseRetriever
    from kirag_tpu_torch.serving import RetrievalEngine

    t0 = time.perf_counter()
    model = BertModel(BertConfig(), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED))
    encoder = Encoder(model, "e5", compute_dtype=torch.bfloat16)
    collator = E5Collator(HashTokenizer(), query_maxlength=MESH_QUERY_TOKENS,
                          doc_maxlength=512, query_padding="max_length")
    texts, text_rows = realtext_questions(), phase4_text_rows()
    emb = torch.zeros((len(texts), DIM), device=dev)
    if rank == 0:
        emb = torch.from_numpy(DenseRetriever(encoder, collator).calculate_query_embeddings(
            texts)).to(dev)
    rows[text_rows] = broadcast(emb, mesh)
    host = rows[:N_ROWS].cpu().numpy()
    ids = list(range(N_ROWS))
    counts, runs = None, {}
    for compression in dict.fromkeys(c for c, _, _ in MESH_ENGINE_RUNS):
        index = TorchIndexer(DIM, device=dev, pallas_chunk_size=CHUNK, compression=compression,
                             mesh=mesh)
        index.index_data(ids, host)
        index.to_device()
        whole = None
        if rank == 0:  # the reference: the unsharded index of the same rows
            whole = TorchIndexer(DIM, device=dev, pallas_chunk_size=CHUNK,
                                 compression=compression)
            whole.index_data(ids, host)
            whole.to_device()
        for _, mode, n_requests in (r for r in MESH_ENGINE_RUNS if r[0] == compression):
            what = f"(d) {compression} {mode}"
            recorder = RecordingIndex(index)
            retriever = DenseRetriever(encoder, collator, indexer=recorder, batch_size=32,
                                       search_mode=mode)
            redispatches = index.redispatches
            reset_launch_counts()
            t1 = time.perf_counter()
            engine = RetrievalEngine(retriever, max_batch=32, max_wait_ms=5.0,
                                     topk_buckets=(10, K))  # a follower's returns at close()
            if engine.leader:
                requests, results, latencies, wall = drive_engine(engine, texts, n_requests,
                                                                  what)
                engine.close()
            c = launch_counts()
            counts = c if counts is None else {k: counts[k] + c[k] for k in c}
            run = {"seconds": time.perf_counter() - t1, "counts": c, "stats": dict(engine.stats),
                   "redispatches": index.redispatches - redispatches,
                   "searches": [(ids_, vals) for _, _, out, _ in recorder.calls
                                for ids_, vals in out]}
            if engine.leader:
                for r, request in enumerate(requests):
                    for j, row in zip(request, results[r]):
                        if row[0]["id"] != str(text_rows[j]) or len(row) != K:
                            raise AssertionError(f"{what}: text {j} top-1 is {row[0]['id']}, "
                                                 f"not its own row {text_rows[j]}")
                for q, top_docs, out, _ in recorder.calls:
                    want = whole.search_knn(q, top_docs, mode=mode)
                    for (got_ids, got_vals), (want_ids, want_vals) in zip(out, want):
                        if got_ids != want_ids or not np.array_equal(got_vals, want_vals):
                            raise AssertionError(f"{what}: a batch of {len(q)} is not bitwise "
                                                 "the unsharded kernel search")
                run.update(traffic_stats(requests, latencies, wall), threaded=n_requests)
            runs[(compression, mode)] = run
        del index, whole
        torch.cuda.empty_cache()
    return {"counts": counts, "runs": runs, "seconds": time.perf_counter() - t0}


def mesh_retrieve(spec_path: str) -> int:
    """Phase 20 (c), under torchrun: ``kirag_tpu_torch.cli.retrieve.main``
    with run A's arguments and ``--mesh_data 1``, the injected tokenizers of
    phase 9 and phase 9's LLM made again from its seed (its first
    KIRAG_LAYERS layers draw the same numbers as phase 8's whole model);
    writes the results' path and the launches to the spec's ``out``."""
    from kirag_tpu_torch.cli import retrieve as retrieve_cli
    from kirag_tpu_torch.kernels import load_library, reset_launch_counts
    from kirag_tpu_torch.models import llm

    spec = json.loads(Path(spec_path).read_text())
    t0 = time.perf_counter()
    load_library()
    config = dataclasses.replace(llm.LlamaConfig(), int4_impl="kernel",
                                 num_hidden_layers=KIRAG_LAYERS)
    params = llm.init_llama_params(config, seed=SEED, device=torch.device("cuda", 0),
                                   dtype=torch.bfloat16, quant_bits=4)
    reset_launch_counts()
    t1 = time.perf_counter()
    path = retrieve_cli.main(spec["argv"], tokenizer=HashTokenizer(),
                             llm_tokenizer=ByteLevelTokenizer(),
                             aligner_tokenizer=HashTokenizer(), llm=(params, config))
    Path(spec["out"]).write_text(json.dumps({
        "path": path, "counts": main_path_counts(), "run_s": time.perf_counter() - t1,
        "setup_s": t1 - t0, "world": os.environ.get("WORLD_SIZE")}))
    return 0


def mesh_nccl(work: Path, host_rows: np.ndarray, served: dict, dev, gen, power) -> dict:
    """Phase 20 (a): NCCL at world size 1 in this process, over a FileStore:
    every sharded_* search over a 1 x 1 mesh of phase 4's float32 rows and
    their int8/int4 layouts bitwise its unsharded counterpart; one
    all_gather_cols and the sharded capdom search timed beside the
    unsharded one; then RetrievalEngine over ``TorchIndexer(mesh=)`` of the
    1 x 1 mesh, its lone requests bitwise phase 4's float32 engine's
    (``served``: its encoder, collator, texts and lone results). The NCCL
    group is destroyed at the end."""
    import torch.distributed as dist

    from kirag_tpu_torch import ops
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.kernels import reset_launch_counts
    from kirag_tpu_torch.parallel import all_gather_cols, create_mesh
    from kirag_tpu_torch.retrieval import DenseRetriever
    from kirag_tpu_torch.serving import RetrievalEngine

    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(str(work / "nccl"), 1), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = create_mesh(1, 1)
        n_pad = -(-N_ROWS // CHUNK) * CHUNK
        rows = torch.zeros(n_pad, DIM, device=dev)
        rows[:N_ROWS] = torch.from_numpy(host_rows).to(dev)
        q = unit_rows(MESH_QUERIES[-1], gen, dev)
        layouts = {"float32": (rows, None)}
        for quant in QUANTS:
            layouts[quant] = mesh_formats(quant, rows, gen, dev)[:2]
        calls = []
        for fmt, (corpus, scales) in layouts.items():
            calls += [(f"exact {fmt}", "exact_topk_mips", (corpus,),
                       dict(chunk_size=CHUNK, scales=scales, **CAPDOM)),
                      (f"approx {fmt}", "approx_topk_mips", (corpus,),
                       dict(scales=scales, winners_per_group=1))]
            if fmt == "float32":
                calls += [("plain float32", "topk_mips", (corpus,), {}),
                          ("onepass float32", "topk_mips_onepass", (corpus,), {})]
            else:  # the scales come before k
                calls.append((f"plain {fmt}", f"topk_mips_{fmt}", (corpus, scales),
                              dict(chunk_size=262144)))
        reset_launch_counts()
        sharded = {what: getattr(ops, "sharded_" + fn)(q, *args, K, mesh, valid_rows=N_ROWS,
                                                       **kw)
                   for what, fn, args, kw in calls}
        counts = main_path_counts()
        for what, fn, args, kw in calls:
            want = getattr(ops, fn)(q, *args, K, valid_rows=N_ROWS, **kw)
            got = sharded[what]
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"(a) {what}: sharded_{fn} over a 1 x 1 NCCL mesh is not "
                                     f"bitwise {fn}")
        x = torch.randn(*MESH_GATHER, generator=gen, device=dev)
        gather_ms = cuda_ms(lambda: all_gather_cols(x, mesh, "data"))
        search = dict(chunk_size=CHUNK, valid_rows=N_ROWS, **CAPDOM)
        sharded_ms = cuda_ms(lambda: ops.sharded_exact_topk_mips(q, rows, K, mesh, **search))
        unsharded_ms = cuda_ms(lambda: ops.exact_topk_mips(q, rows, K, **search))
        del rows, layouts, sharded
        torch.cuda.empty_cache()
        index = TorchIndexer(DIM, device=dev, pallas_chunk_size=CHUNK, mesh=mesh)
        index.index_data(list(range(N_ROWS)), host_rows)
        index.to_device()
        retriever = DenseRetriever(served["encoder"], served["collator"], indexer=index,
                                   batch_size=32)
        reset_launch_counts()
        engine = RetrievalEngine(retriever, max_batch=32, max_wait_ms=5.0, topk_buckets=(10, K))
        lone = {n: engine.search(served["texts"][:n], topk=K) for n in served["lone"]}
        engine.close()
        engine_counts = main_path_counts()
        counts = {k: counts[k] + engine_counts[k] for k in counts}
        for n, want in served["lone"].items():
            if [[(d["id"], d["score"]) for d in row] for row in lone[n]] != [
                    [(d["id"], d["score"]) for d in row] for row in want]:
                raise AssertionError(f"(a) the engine over a 1 x 1 mesh: the request of {n} "
                                     "texts is not bitwise phase 4's float32 engine's")
        del index
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    log(f"  (a) NCCL, world size 1, a 1 x 1 mesh over {N_ROWS} x {DIM} float32 rows ({n_pad} "
        f"on the chunk grid) and their int8/int4 layouts, Q={len(q)}, k={K}: {len(calls)} "
        f"sharded searches ({', '.join(c[0] for c in calls)}) bitwise their unsharded "
        f"counterparts; launches {nonzero(counts)}")
    log(f"  [{power}] (a) all_gather_cols of {list(MESH_GATHER)} f32 over NCCL (one rank): "
        f"{gather_ms:.4f} ms; the float32 capdom search, Q={len(q)}: sharded {sharded_ms:.3f} "
        f"ms (its merge: two all_gathers and a stable sort) against unsharded "
        f"{unsharded_ms:.3f} ms (CUDA events, median of 10); {time.perf_counter() - t0:.1f} s")
    log(f"  (a) RetrievalEngine over TorchIndexer(mesh=) of the 1 x 1 mesh: requests of "
        f"{list(served['lone'])} texts alone, ids and scores bitwise phase 4's float32 "
        f"engine's; launches {nonzero(engine_counts)}")
    return {"launches": counts, "gather_ms": gather_ms, "sharded_ms": sharded_ms,
            "unsharded_ms": unsharded_ms}


def mesh_gloo(work: Path, power) -> list:
    """Phase 20 (b) and (d): MESH_RANKS spawned ranks on the one card over
    gloo (:func:`mesh_rank_work`); both ranks' results the same. Returns the
    ranks' main-path launches."""
    import pickle

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    outs = [work / f"rank_{r}.pkl" for r in range(MESH_RANKS)]
    store = str((work / "gloo").resolve())  # a file:// rendezvous wants an absolute path
    procs = [ctx.Process(target=mesh_rank, args=(r, store, str(outs[r])))
             for r in range(MESH_RANKS)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=max(1.0, MESH_TIMEOUT - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = []
    for out in outs:
        if out.exists():
            with open(out, "rb") as f:
                ranks.append(pickle.load(f))
    errors = [r["error"] for r in ranks if "error" in r]
    if errors or len(ranks) < MESH_RANKS or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"(b): rank exit codes {[p.exitcode for p in procs]} (None: "
                             f"killed after {MESH_TIMEOUT} s)\n" + "\n".join(errors))
    r0 = ranks[0]
    for r in ranks[1:]:
        same = all(torch.equal(r["results"][key][i], r0["results"][key][i])
                   for key in r0["results"] for i in (0, 1))
        if not (same and all(np.array_equal(r["llm"][k][0], r0["llm"][k][0])
                             for k in r0["llm"])):
            raise AssertionError(f"(b): rank {r['rank']}'s results differ from rank 0's")
    c = r0["llm_checks"]
    log(f"  (b) {MESH_RANKS} ranks on one card over gloo (each process's tensors on "
        f"{r0['device']}; gloo copies every collective through host memory, so these times "
        f"say nothing of NVLink or NCCL): {N_ROWS} x {DIM} seeded rows padded to two shards "
        f"of the chunk grid, the valid rows ending inside shard 1; the merged exact (capdom) "
        f"and approximate (W = 1) searches bitwise rank 0's unsharded kernel search in "
        f"{len(r0['checks'])} cases ({', '.join(MESH_FORMATS)}; Q = {MESH_QUERIES}), both "
        f"ranks the same")
    log(f"  (b) Llama TP over {MESH_RANKS} ranks (Llama-3-8B geometry, NF4, {KIRAG_LAYERS} of "
        f"32 layers, {LLM_ROWS} prompts x {MESH_LLM_PROMPT} tokens, {MESH_LLM_STEPS} steps): "
        f"bf16 prefill and first-step logits within {c['err']:.3g} of the unsharded decode's "
        f"(tolerance {c['tol']:.3g}), ids equal for {c['agree']} tokens a row (each up to "
        f"its first near-tie at least); f32 at {MESH_F32_LAYERS} layers ids equal, logits "
        f"within {c['err32']:.3g} (tolerance {c['tol32']:.3g}); {r0['k6']} K6 launches a rank "
        f"({7 * KIRAG_LAYERS + 1} a step); each rank holds {r0['bytes'][1] / 1e9:.3f} of "
        f"{r0['bytes'][0] / 1e9:.3f} GB of parameters; launches a rank "
        f"{[nonzero(r['counts']) for r in ranks]}")
    log(f"  [{power}] (b) rank 0: searches {r0['search_s']:.1f} s, LLM build and decodes "
        f"{r0['llm_s']:.1f} s, a TP decode step {r0['tp_step_ms']:.1f} ms (host clock, gloo "
        f"through the host); (b) and (d) in all {time.perf_counter() - t0:.1f} s")
    mesh_engine_check(ranks, power)
    return [r["counts"] for r in ranks]


def mesh_engine_check(ranks: list, power) -> None:
    """Phase 20 (d) across the ranks: each follower searched what the leader
    searched and got the same results, K1 (exact) or K5 (approx) ran on
    every rank, K2 on every rank over the exact runs, K3 on the leader only
    (the followers encode nothing); the traffic's numbers logged."""
    r0 = ranks[0]["engine"]
    k2 = [0] * len(ranks)
    for (compression, mode), lead in r0["runs"].items():
        quant = kernel_quant(compression)
        what = f"(d) {compression} {mode}"
        for i, r in enumerate(ranks):
            run = r["engine"]["runs"][(compression, mode)]
            same = len(run["searches"]) == len(lead["searches"]) and all(
                a[0] == b[0] and np.array_equal(a[1], b[1])
                for a, b in zip(run["searches"], lead["searches"]))
            if not same:
                raise AssertionError(f"{what}: rank {r['rank']}'s searches differ from the "
                                     "leader's")
            name = k5_name(quant) if mode == "approx" else kernel_names(quant)[0]
            if run["counts"][name] == 0 or (run["counts"]["flash_attention"] > 0) != (i == 0):
                raise AssertionError(f"{what}: rank {r['rank']} launched "
                                     f"{nonzero(run['counts'])}")
            if mode == "exact":
                k2[i] += run["counts"][kernel_names(quant)[1]]
        log(f"  (d) RetrievalEngine over {MESH_RANKS} ranks, {compression} {mode}: "
            f"{lead['stats']['requests']} requests in {lead['stats']['batches']} batches "
            f"({len(lead['searches'])} queries searched with the warm-up), each text's own row "
            f"at top-1, every batch bitwise rank 0's unsharded kernel search, each follower's "
            f"results the leader's; {lead['redispatches']} searches re-dispatched; launches "
            f"a rank {[nonzero(r['engine']['runs'][(compression, mode)]['counts']) for r in ranks]}")
        log(f"  [{power}] (d) {compression} {mode} engine: {lead['rps']:.2f} requests/s "
            f"({lead['texts_per_s']:.2f} texts/s), latency p50 {lead['p50_ms']:.2f} ms, p95 "
            f"{lead['p95_ms']:.2f} ms ({lead['threaded']} requests, host clock, 4 threads; "
            f"gloo through the host); the run "
            f"{lead['seconds']:.1f} s")
    if not all(k2):
        raise AssertionError(f"(d): K2 launches a rank over the exact runs {k2}")
    log(f"  (d) in all {r0['seconds']:.1f} s on rank 0 (retriever, indexes, runs and checks)")


def mesh_torchrun(work: Path, mesh_dir: Path, built: dict):
    """Phase 20 (c)'s start: ``torchrun --standalone --nproc_per_node 1`` of
    this script's ``--mesh-retrieve`` (:func:`mesh_retrieve`), in the
    background, with run A's arguments (its questions in ``work``, a new KG
    cache and save directory in ``mesh_dir``) and ``--mesh_data 1``.
    Returns the process and its spec."""
    argv = [*kirag_argv(work, built, mesh_dir / "kg_cache.pkl"), "--num_queries",
            str(KIRAG_QUESTIONS), "--save_dir", str(mesh_dir), "--name", "kirag_A",
            "--save_file", "results.json", "--mesh_data", "1"]
    spec = {"argv": argv, "out": str(mesh_dir / "retrieve_out.json"),
            "log": str(mesh_dir / "torchrun.log")}
    (mesh_dir / "retrieve.json").write_text(json.dumps(spec))
    with open(spec["log"], "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "1", str(Path(__file__).resolve()), "--mesh-retrieve",
             str(mesh_dir / "retrieve.json")],
            stdout=log_file, stderr=subprocess.STDOUT, cwd=str(Path(__file__).resolve().parent))
    return proc, spec


def mesh_torchrun_check(proc, spec: dict, run_a: dict, started: float, power) -> dict:
    """Phase 20 (c)'s end: the rank's --save_file byte for byte run A's, and
    the kernels of the path launched. Returns its main-path launches."""
    try:
        proc.wait(timeout=max(1.0, MESH_TIMEOUT - (time.perf_counter() - started)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"(c): torchrun still running after {MESH_TIMEOUT} s")
    if proc.returncode != 0:
        raise AssertionError(f"(c): torchrun exited {proc.returncode}:\n"
                             + Path(spec["log"]).read_text()[-3000:])
    out = json.loads(Path(spec["out"]).read_text())
    if Path(out["path"]).read_bytes() != Path(run_a["path"]).read_bytes():
        raise AssertionError("(c): cli/retrieve --mesh_data 1 under torchrun wrote another "
                             "--save_file than run A")
    idle = [k for k in ("stream_capture", "flash_attention", "int4_matmul")
            if out["counts"][k] == 0]
    if idle:
        raise AssertionError(f"(c): kernels of the path were not launched: {idle}")
    log(f"  (c) torchrun --standalone --nproc_per_node 1 (WORLD_SIZE {out['world']}) of "
        f"cli/retrieve --mesh_data 1 with run A's arguments: its --save_file equals run A's "
        f"byte for byte; launches {nonzero(out['counts'])}")
    log(f"  [{power}] (c) the run {out['run_s']:.1f} s after {out['setup_s']:.1f} s of set-up "
        f"(phase 9's model made again), beside (a) and (b)")
    return out["counts"]


def mesh_phase(work: Path, host_rows: np.ndarray, served: dict, built: dict, run_a: dict, dev,
               gen, power) -> dict:
    """Phase 20, the mesh: (c) starts first, in the background, then (a),
    and (b) with (d) in the same ranks, run; (c) is checked last. ``served``:
    phase 4's encoder, collator, texts and the float32 engine's lone
    results. Returns each run's main-path launches."""
    started = time.perf_counter()
    mesh_dir = work / "mesh"
    mesh_dir.mkdir()
    proc, spec = mesh_torchrun(work, mesh_dir, built)
    try:
        nccl = mesh_nccl(mesh_dir, host_rows, served, dev, gen, power)
        ranks = mesh_gloo(mesh_dir, power)
        retrieved = mesh_torchrun_check(proc, spec, run_a, started, power)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"  phase 20 in all {time.perf_counter() - started:.1f} s")
    return {"launches": [nccl["launches"], *ranks, retrieved], "nccl": nccl}


# ---------------------------------------------------------------- phase 21

TRAIN_MESH_STEPS = 3         # (a): micro steps of each trainer
TRAIN_MESH_LAYERS = 4        # (b): of E5-large's 24 (the collectives go through the host)
TRAIN_MESH_TEXTS = 32        # (a), (b): phase 6's first passages, the 128-token bucket
TRAIN_MESH_TIMEOUT = 240     # s: (b)'s and (c)'s processes
TP_EMB_TOL, TP_EMB_COS = 1e-5, 0.999  # (b): Encoder.shard_params, f32 / bf16
# (c) against phase 10 (c), where not bitwise: the losses' relative gap, and
# each weight within 2 x train_aligner's rate (2e-5) for each of the run's
# three updates at a non-zero rate (the first update of the warmup is at 0)
CLI_LOSS_TOL, CLI_PARAM_TOL = 1e-3, 2 * 2e-5 * 3


def phase6_passages(built: dict, n: int) -> dict:
    """The first ``n`` passages of phase 6's TSV, tokenized as the index
    build tokenized them (numpy ids and mask)."""
    from kirag_tpu_torch.data import E5Collator

    lines = Path(built["tsv"]).read_text(encoding="utf-8").splitlines()[1:n + 1]
    texts = [line.split("\t")[1] for line in lines]
    return E5Collator(HashTokenizer(), query_maxlength=64, doc_maxlength=512).encode_doc(texts)


def whole_grads(trainer) -> list:
    """Wrap ``trainer.optimizer._apply`` so that each update's gradient (the
    flat vector the optimizer applies: summed over the data axis) is kept in
    the returned list as the whole model's tensors, gathered over the model
    axis, in parameter order."""
    seen = []
    apply = trainer.optimizer._apply

    def recording(g):
        pieces = g.split([p.numel() for p in trainer.params])
        seen.append([trainer._whole(n, x.view_as(p))
                     for n, x, p in zip(trainer.names, pieces, trainer.params)])
        return apply(g)

    trainer.optimizer._apply = recording
    return seen


def timed_step(trainer, batch) -> tuple:
    """(the step's statistics, its host ms to a synchronized end)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = trainer.training_step(batch)
    torch.cuda.synchronize()
    return stats, 1e3 * (time.perf_counter() - t0)


def train_mesh_nccl(work: Path, built: dict, dev, power) -> dict:
    """Phase 21 (a): NCCL at world size 1 in this process.
    ``AlignerTrainer(mesh=create_mesh(1, 1), batch_sharding="data")`` at
    E5-large (phase 6's weights, bf16 compute over f32 weights, remat dots,
    phase 10 (d)'s batch) takes TRAIN_MESH_STEPS micro steps against the
    unsharded trainer from the same weights, both under
    ``torch.use_deterministic_algorithms``: losses and parameters bitwise;
    then ``Encoder.shard_params`` over the 1 x 1 mesh bitwise the unsharded
    encoder on phase 6's passages. The NCCL group is destroyed at the end."""
    import copy

    import torch.distributed as dist

    from kirag_tpu_torch.kernels import reset_launch_counts
    from kirag_tpu_torch.models import Encoder, load_encoder
    from kirag_tpu_torch.parallel import create_mesh
    from kirag_tpu_torch.training import AlignerTrainer, TrainerConfig

    t0 = time.perf_counter()
    batch = train_batch(TRAIN_QUERIES, np.random.RandomState(SEED + 12), padded=False)
    passages = phase6_passages(built, TRAIN_MESH_TEXTS)
    weights = load_encoder(str(built["model_dir"]), "e5", device=dev).model  # f32

    def run(mesh, name):
        model = copy.deepcopy(weights)
        trainer = AlignerTrainer(model, TrainerConfig(max_steps=10_000,
                                                      save_dir=str(work / name)),
                                 [batch], compute_dtype=torch.bfloat16, remat="dots",
                                 mesh=mesh, batch_sharding=None if mesh is None else "data")
        # PyTorch's embedding backward would otherwise sum a repeated index's
        # rows in an order of its own each run (phase 10 (b))
        with deterministic_algorithms():
            steps = [timed_step(trainer, batch) for _ in range(TRAIN_MESH_STEPS)]
        return steps, {k: v.detach().clone() for k, v in model.state_dict().items()}

    def embed(mesh):
        encoder = Encoder(copy.deepcopy(weights), "e5", compute_dtype=torch.bfloat16)
        if mesh is not None:
            encoder.shard_params(mesh)
        return encoder(passages["input_ids"], passages["attention_mask"])

    want, want_emb = run(None, "unsharded"), embed(None)
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", store=dist.FileStore(str(work / "nccl"), 1), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = create_mesh(1, 1)
        reset_launch_counts()
        got = run(mesh, "mesh")
        counts = main_path_counts()
        got_emb = embed(mesh)
    finally:
        dist.destroy_process_group()
    del weights
    torch.cuda.empty_cache()
    losses = [s["loss"] for s, _ in got[0]]
    if losses != [s["loss"] for s, _ in want[0]]:
        raise AssertionError(f"(a) losses over the 1 x 1 mesh {losses} are not the unsharded "
                             f"trainer's {[s['loss'] for s, _ in want[0]]}")
    moved = [k for k in want[1] if not torch.equal(got[1][k], want[1][k])]
    if moved:
        raise AssertionError(f"(a) parameters after {TRAIN_MESH_STEPS} steps differ from the "
                             f"unsharded trainer's: {moved[:5]}")
    if not torch.equal(got_emb, want_emb):
        raise AssertionError("(a) Encoder.shard_params over a 1 x 1 mesh is not bitwise the "
                             "unsharded encoder")
    if min(counts[k] for k in K3_NAMES) == 0:
        raise AssertionError(f"(a) K3 launches {[counts[k] for k in K3_NAMES]}")
    ms = [t for _, t in got[0]]
    log(f"  (a) NCCL, world size 1: AlignerTrainer(mesh=create_mesh(1, 1), batch_sharding="
        f"'data') at E5-large (24 layers x 1024, bf16 compute over f32 weights, remat dots, "
        f"deterministic algorithms, "
        f"{TRAIN_QUERIES} queries x {TRAIN_Q_LEN} + {TRAIN_QUERIES * DOCS_PER_QUERY} docs x "
        f"{TRAIN_D_LEN}), {TRAIN_MESH_STEPS} micro steps: losses "
        + ", ".join(f"{x:.6f}" for x in losses) + " and every parameter bitwise the unsharded "
        f"trainer's; Encoder.shard_params over the 1 x 1 mesh bitwise the unsharded encoder on "
        f"phase 6's first {TRAIN_MESH_TEXTS} passages; K3 launches "
        f"{[counts[k] for k in K3_NAMES]}")
    log(f"  [{power}] (a) a step over the mesh {statistics.median(ms[1:]):.1f} ms, unsharded "
        f"{statistics.median([t for _, t in want[0]][1:]):.1f} ms (host clock, synchronized; "
        f"median of steps 2-{TRAIN_MESH_STEPS}); {time.perf_counter() - t0:.1f} s")
    return {"launches": counts, "losses": losses, "ms": ms}


def train_mesh_rank(rank: int, store: str, out: str, spec: dict) -> None:
    """Phase 21 (b), one of MESH_RANKS processes on the one card over gloo
    (spawned; loads the library the parent built): writes what
    :func:`train_mesh_rank_work` returns, or the traceback, to ``out``."""
    import pickle
    import traceback

    import torch.distributed as dist

    try:
        result = train_mesh_rank_work(rank, store, spec)
    except BaseException:
        result = {"error": traceback.format_exc()}
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(result, f)


def train_mesh_rank_work(rank: int, store: str, spec: dict) -> dict:
    """Every rank makes the same seeded E5-large-width encoder of
    TRAIN_MESH_LAYERS layers on the card and the same global batch (phase 10
    (b)'s GRAD_QUERIES padded queries and their docs). Rank 0 takes the
    unsharded trainer's step at f32 and bf16; then every rank takes DP
    (2, 1) and TP (1, 2) steps at f32 and bf16 and TP at remat dots, whose
    gradients (summed over the data axis, gathered over the model axis)
    rank 0 holds to the unsharded ones; a TP checkpoint at step 2 resumed,
    read by an unsharded trainer, and ``save_encoder`` under TP read back;
    and ``Encoder.shard_params`` over (1, 2) against the unsharded encoder
    on phase 6's passages. The kernels' launches are the mesh runs' only."""
    import copy

    import torch.distributed as dist

    from kirag_tpu_torch.kernels import launch_counts, load_library, reset_launch_counts
    from kirag_tpu_torch.models import BertConfig, BertModel, Encoder, load_encoder
    from kirag_tpu_torch.models.bert import gather_state_dict
    from kirag_tpu_torch.parallel import create_mesh, distributed_init
    from kirag_tpu_torch.training import AlignerTrainer, TrainerConfig

    t0, wall0 = time.perf_counter(), time.time()
    torch.set_num_threads(2)  # beside (c) on the host's cores
    dev = distributed_init(num_processes=MESH_RANKS, process_id=rank, backend="gloo",
                           init_method=f"file://{store}", timeout_s=TRAIN_MESH_TIMEOUT / 2)
    load_library()
    work = Path(spec["work"])
    config = BertConfig(num_hidden_layers=TRAIN_MESH_LAYERS)
    base = BertModel(config, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED + 21))
    batch = train_batch(GRAD_QUERIES, np.random.RandomState(SEED + 21), True)
    names = [n for n, _ in base.named_parameters()]
    counts, checks, ms = dict.fromkeys(K3_NAMES, 0), {}, {}
    whole_bytes = sum(p.numel() * p.element_size() for p in base.parameters())
    torch.cuda.synchronize()
    t1 = time.perf_counter()

    def add_counts():
        for k, n in launch_counts().items():
            counts[k] = counts.get(k, 0) + n

    def trainer(mesh_shape, dtype, remat=False, name="run"):
        mesh = None if mesh_shape is None else create_mesh(*mesh_shape)
        return AlignerTrainer(copy.deepcopy(base),
                              TrainerConfig(max_steps=100, save_dir=str(work / name)),
                              [batch], compute_dtype=dtype, remat=remat, mesh=mesh,
                              batch_sharding=None if mesh is None else "data")

    ref = {}
    if rank == 0:
        for dtype in (torch.float32, torch.bfloat16):
            t = trainer(None, dtype, name="unsharded")
            seen = whole_grads(t)
            ref[dtype] = (t.training_step(batch)["loss"], seen[0])
            del t
    # the TP f32 run goes on to the checkpoint below
    runs = [((2, 1), torch.float32, False), ((2, 1), torch.bfloat16, False),
            ((1, 2), torch.bfloat16, False), ((1, 2), torch.float32, "dots"),
            ((1, 2), torch.float32, False)]
    for mesh_shape, dtype, remat in runs:
        t = trainer(mesh_shape, dtype, remat, name="tp_ckpt")
        seen = whole_grads(t)
        reset_launch_counts()
        stats, step_ms = timed_step(t, batch)
        add_counts()
        label = f"{'DP' if mesh_shape[0] > 1 else 'TP'} {mesh_shape} {str(dtype)[6:]}" + (
            f" remat {remat}" if remat else "")
        if rank == 0:
            want_loss, want = ref[dtype]
            loss = stats["loss"]
            if dtype == torch.float32:
                gap = grad_gap(seen[0], want, names)
                ok = gap[0] <= GRAD_TOL_F32 and abs(loss - want_loss) <= 1e-4 * abs(want_loss)
            else:
                gap = grad_cosine(seen[0], want, names)
                ok = gap[0] >= GRAD_COS_BF16 and abs(loss - want_loss) <= 1e-2 * abs(want_loss)
            if not ok:
                raise AssertionError(f"(b) {label}: loss {loss} against unsharded {want_loss}; "
                                     f"gradient {gap[1]} at {gap[0]}")
            checks[label] = (loss, want_loss, gap)
        ms[label] = step_ms
    heads = config.num_attention_heads // t.tp.size
    tp_bytes = sum(p.numel() * p.element_size() for p in t.model.parameters())
    del t.optimizer._apply, seen  # the class's own: no more recording
    torch.cuda.empty_cache()

    # the TP f32 run: checkpoint at step 2, step 3 resumed bitwise; read unsharded
    reset_launch_counts()
    _, ms["TP (1, 2) float32, step 2"] = timed_step(t, batch)
    at_2 = {k: v.clone() for k, v in gather_state_dict(t.model).items()}
    t.save_checkpoint()
    third, ms["TP (1, 2) float32, step 3"] = timed_step(t, batch)
    at_3 = gather_state_dict(t.model)
    t.save_encoder(str(work / "tp_encoder"))
    resumed = trainer((1, 2), torch.float32, name="tp_ckpt")
    if not (resumed.resume_training() and resumed.step == 2):
        raise AssertionError("(b) no TP checkpoint at step 2 to resume from")
    again = resumed.training_step(batch)
    add_counts()
    again_3 = gather_state_dict(resumed.model)
    if again["loss"] != third["loss"] or any(not torch.equal(again_3[k], at_3[k]) for k in at_3):
        raise AssertionError(f"(b) step 3 resumed from the TP checkpoint: loss {again['loss']} "
                             f"against {third['loss']}, or parameters not bitwise")
    if rank == 0:
        loaded = trainer(None, torch.float32, name="tp_ckpt")
        if not (loaded.resume_training() and all(
                torch.equal(loaded.model.state_dict()[k], at_2[k]) for k in at_2)):
            raise AssertionError("(b) the TP checkpoint read by an unsharded trainer is not "
                                 "the gathered state at step 2")
        saved = load_encoder(str(work / "tp_encoder"), device=dev).model.state_dict()
        if saved.keys() != at_3.keys() or any(not torch.equal(saved[k], at_3[k]) for k in at_3):
            raise AssertionError("(b) save_encoder under TP, read back, is not the gathered "
                                 "model")
        checks["resumed_loss"] = again["loss"]
    del t, resumed
    torch.cuda.empty_cache()

    # Encoder.shard_params over (1, 2) on phase 6's passages
    ids, mask = spec["passages"]["input_ids"], spec["passages"]["attention_mask"]
    for dtype in (torch.float32, torch.bfloat16):
        reset_launch_counts()
        got = Encoder(copy.deepcopy(base), "e5", compute_dtype=dtype).shard_params(
            create_mesh(1, 2))(ids, mask)
        add_counts()
        if rank == 0:
            want = Encoder(copy.deepcopy(base), "e5", compute_dtype=dtype)(ids, mask)
            if dtype == torch.float32:
                err = float((got - want).abs().max()) / float(want.abs().max())
                ok = err <= TP_EMB_TOL
            else:
                err = float(torch.sum(got * want, dim=-1).min())
                ok = err >= TP_EMB_COS
            if not ok:
                raise AssertionError(f"(b) Encoder.shard_params (1, 2) {dtype}: {err}")
            checks[f"encoder {str(dtype)[6:]}"] = err
    dist.barrier()
    dist.destroy_process_group()
    return {"rank": rank, "counts": counts, "checks": checks, "ms": ms, "heads": heads,
            "bytes": (whole_bytes, tp_bytes), "device": str(dev),
            "setup_s": t1 - t0, "seconds": time.perf_counter() - t1,
            "wall": (wall0, time.time())}


def train_mesh_gloo_start(work: Path, built: dict) -> list:
    """Phase 21 (b)'s start: MESH_RANKS spawned ranks on the one card over
    gloo (:func:`train_mesh_rank_work`), in the background. Returns the
    processes."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    spec = {"work": str(work), "passages": phase6_passages(built, TRAIN_MESH_TEXTS)}
    store = str((work / "gloo_train").resolve())
    procs = [ctx.Process(target=train_mesh_rank,
                         args=(r, store, str(work / f"train_rank_{r}.pkl"), spec))
             for r in range(MESH_RANKS)]
    for p in procs:
        p.start()
    return procs


def train_mesh_gloo_check(procs: list, work: Path, started: float, power) -> dict:
    """Phase 21 (b)'s end: every rank's checks passed and K3's kernels ran
    on each. Returns the ranks' main-path launches."""
    import pickle

    try:
        for p in procs:
            p.join(timeout=max(1.0, TRAIN_MESH_TIMEOUT - (time.perf_counter() - started)))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = []
    for r in range(MESH_RANKS):
        out = work / f"train_rank_{r}.pkl"
        if out.exists():
            with open(out, "rb") as f:
                ranks.append(pickle.load(f))
    errors = [r["error"] for r in ranks if "error" in r]
    if errors or len(ranks) < MESH_RANKS or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"(b): rank exit codes {[p.exitcode for p in procs]} (None: "
                             f"killed after {TRAIN_MESH_TIMEOUT} s)\n" + "\n".join(errors))
    idle = [(r["rank"], k) for r in ranks for k in K3_NAMES if r["counts"][k] == 0]
    if idle:
        raise AssertionError(f"(b): K3 kernels not launched: {idle}")
    r0 = ranks[0]
    c = r0["checks"]
    log(f"  (b) {MESH_RANKS} ranks on one card over gloo (each process's tensors on "
        f"{r0['device']}; gloo copies every collective through host memory): E5-large width "
        f"(1024, 16 heads), {TRAIN_MESH_LAYERS} of 24 layers, {GRAD_QUERIES} padded queries "
        f"x {TRAIN_Q_LEN} and {GRAD_QUERIES * DOCS_PER_QUERY} docs x {TRAIN_D_LEN}; against "
        "rank 0's unsharded step on the same global batch: " + "; ".join(
            f"{label} loss {v[0]:.6f} ({v[1]:.6f}), worst gradient {v[2][1]} "
            + (f"cosine {v[2][0]:.6f}" if "bfloat16" in label else f"within {v[2][0]:.3g}")
            for label, v in c.items() if label.startswith(("DP", "TP")))
        + f" (f32 tolerance {GRAD_TOL_F32} of each norm, bf16 cosine >= {GRAD_COS_BF16})")
    log(f"  (b) TP checkpoint at step 2: step 3 resumed bitwise the uninterrupted one (loss "
        f"{c['resumed_loss']:.6f}), the checkpoint read by an unsharded trainer equal to the "
        f"gathered state, save_encoder under TP read back equal; Encoder.shard_params (1, 2) "
        f"on phase 6's first {TRAIN_MESH_TEXTS} passages: f32 within "
        f"{c['encoder float32']:.3g} of the largest magnitude (tolerance {TP_EMB_TOL}), bf16 "
        f"cosine >= {c['encoder bfloat16']:.6f} ({TP_EMB_COS}); K3 [forward, dK/dV, dQ] "
        f"launches a rank {[[r['counts'][k] for k in K3_NAMES] for r in ranks]} on "
        f"{r0['heads']} of 16 heads; each TP rank holds {r0['bytes'][1] / 1e9:.3f} of "
        f"{r0['bytes'][0] / 1e9:.3f} GB of parameters")
    log(f"  [{power}] (b) rank 0, one step (host clock, synchronized; gloo through the host, "
        "so these say nothing of NCCL or NVLink; beside (c)): " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in r0["ms"].items())
        + f"; its ranks' work {r0['seconds']:.1f} s after {r0['setup_s']:.1f} s of set-up")
    return {"launches": [r["counts"] for r in ranks], "ms": r0["ms"],
            "wall": (min(r["wall"][0] for r in ranks), max(r["wall"][1] for r in ranks))}


def train_mesh_cli(spec_path: str) -> int:
    """Phase 21 (c), under torchrun: ``kirag_tpu_torch.cli.train_aligner.main``
    with phase 10 (c)'s arguments and ``--mesh_data 1``, each micro step's
    loss recorded; writes them, the result and the launches to the spec's
    ``out``."""
    from kirag_tpu_torch.cli import train_aligner
    from kirag_tpu_torch.kernels import load_library, reset_launch_counts
    from kirag_tpu_torch.training import aligner

    spec = json.loads(Path(spec_path).read_text())
    t0, wall0 = time.perf_counter(), time.time()
    load_library()
    losses = []
    step_fn = aligner.AlignerTrainer.training_step

    def step(self, collated):
        stats = step_fn(self, collated)
        losses.append(stats["loss"])
        return stats

    aligner.AlignerTrainer.training_step = step
    reset_launch_counts()
    t1 = time.perf_counter()
    result = train_aligner.main(spec["argv"], tokenizer=HashTokenizer())
    Path(spec["out"]).write_text(json.dumps({
        "result": result, "losses": losses, "counts": main_path_counts(),
        "run_s": time.perf_counter() - t1, "setup_s": t1 - t0,
        "world": os.environ.get("WORLD_SIZE"), "wall": (wall0, time.time())}))
    return 0


def train_mesh_torchrun(work: Path, built: dict):
    """Phase 21 (c)'s start: ``torchrun --standalone --nproc_per_node 1`` of
    this script's ``--train-mesh`` (:func:`train_mesh_cli`), in the
    background, with phase 10 (c)'s arguments and ``--mesh_data 1``. Returns
    the process and its spec."""
    argv = ["--retriever_model_name_or_path", str(built["model_dir"]), "--data_folders",
            str(work / "aligner_data" / "hotpotqa"), "--num_train_epochs", "1",
            "--save_dir", str(work / "train_mesh"), "--name", "run", "--mesh_data", "1"]
    spec = {"argv": argv, "out": str(work / "train_mesh_out.json"),
            "log": str(work / "train_torchrun.log")}
    (work / "train_mesh.json").write_text(json.dumps(spec))
    with open(spec["log"], "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "1", str(Path(__file__).resolve()), "--train-mesh", str(work / "train_mesh.json")],
            stdout=log_file, stderr=subprocess.STDOUT, cwd=str(Path(__file__).resolve().parent))
    return proc, spec


def train_mesh_torchrun_check(proc, spec: dict, cli: dict, work: Path, started: float,
                              power) -> dict:
    """Phase 21 (c)'s end: the run's losses and saved encoder against phase
    10 (c)'s (bitwise expected). Returns its main-path launches."""
    with np.load(work / "aligner" / "run" / "encoder" / "params.npz") as b:
        want_params = {k: b[k] for k in b.files}  # read while the run goes on
    try:
        proc.wait(timeout=max(1.0, TRAIN_MESH_TIMEOUT - (time.perf_counter() - started)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"(c): torchrun still running after {TRAIN_MESH_TIMEOUT} s")
    if proc.returncode != 0:
        raise AssertionError(f"(c): torchrun exited {proc.returncode}:\n"
                             + Path(spec["log"]).read_text()[-3000:])
    out = json.loads(Path(spec["out"]).read_text())
    got, want = out["losses"], cli["losses"]
    with np.load(Path(out["result"]["encoder_dir"]) / "params.npz") as a:
        got_params = {k: a[k] for k in a.files}
    if got_params.keys() != want_params.keys():
        raise AssertionError(f"(c): the saved encoder's leaves {sorted(got_params)[:5]} ... "
                             "are not phase 10 (c)'s")
    param_gap = max(float(np.abs(got_params[k] - v).max()) for k, v in want_params.items())
    same = param_gap == 0
    first = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y), None)
    loss_gap = max(abs(x - y) / abs(y) for x, y in zip(got, want))
    # bitwise is expected; a difference must stay within what Adam makes of
    # the gradients' last bits (PyTorch's embedding backward sums a repeated
    # index's rows in an order that changes from run to run, phase 10 (b)):
    # each element moves at most 2 x the rate a non-zero update
    if not (len(got) == len(want) and loss_gap <= CLI_LOSS_TOL
            and param_gap <= CLI_PARAM_TOL):
        raise AssertionError(f"(c): losses {got} against phase 10 (c)'s {want} (relative gap "
                             f"{loss_gap} > {CLI_LOSS_TOL}?), the saved encoder within "
                             f"{param_gap} (> {CLI_PARAM_TOL}?)")
    if first is None and same:
        same_text = "losses and the saved encoder bitwise phase 10 (c)'s"
    else:
        same_text = (f"losses bitwise phase 10 (c)'s up to micro step {first or len(got)}, then "
                     f"within "
                     f"{loss_gap:.3g} of them (tolerance {CLI_LOSS_TOL}); the saved encoder "
                     f"within {param_gap:.3g} of phase 10 (c)'s (tolerance {CLI_PARAM_TOL}); "
                     f"dev MRR {out['result']['final_metric']:.4f} against {cli['metric']:.4f}")
    idle = [k for k in K3_NAMES if out["counts"][k] == 0]
    if idle:
        raise AssertionError(f"(c): kernels of the path were not launched: {idle}")
    log(f"  (c) torchrun --standalone --nproc_per_node 1 (WORLD_SIZE {out['world']}) of "
        f"cli/train_aligner --mesh_data 1 with phase 10 (c)'s arguments: {len(got)} micro "
        f"steps, {same_text}; K3 launches {[out['counts'][k] for k in K3_NAMES]}")
    log(f"  [{power}] (c) the run {out['run_s']:.1f} s after {out['setup_s']:.1f} s of set-up, "
        f"beside (a) and (b)")
    return {"launches": out["counts"], "wall": out["wall"]}


def train_mesh_phase(work: Path, built: dict, cli: dict, dev, power) -> dict:
    """Phase 21, training over a mesh: (c) starts in the background, (a) runs
    here, then (b)'s ranks; (b) and (c) are checked last. Returns each run's
    main-path launches."""
    started, wall0 = time.perf_counter(), time.time()
    mesh_dir = work / "train_mesh_phase"
    mesh_dir.mkdir()
    proc, spec = train_mesh_torchrun(work, built)
    ranks = []
    try:
        # (a) while (c) starts; (b)'s spawns after it, so that the three
        # processes' start-ups do not share the host's cores at once
        nccl = train_mesh_nccl(mesh_dir, built, dev, power)
        a_end = time.time()
        ranks = train_mesh_gloo_start(mesh_dir, built)
        gloo = train_mesh_gloo_check(ranks, mesh_dir, started, power)
        cli_run = train_mesh_torchrun_check(proc, spec, cli, work, started, power)
    finally:
        for p in ranks:
            if p.is_alive():
                p.kill()
                p.join()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - started

    def span(w):
        return f"{w[0] - wall0:.1f}-{w[1] - wall0:.1f} s"

    log(f"  phase 21 in all {seconds:.1f} s: (a) 0.0-{a_end - wall0:.1f} s, (b)'s ranks "
        f"{span(gloo['wall'])} and (c)'s run {span(cli_run['wall'])} into the phase (host "
        "clock)")
    return {"launches": [nccl["launches"], *gloo["launches"], cli_run["launches"]],
            "seconds": seconds}


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
    started = time.perf_counter()

    def phase(title: str) -> None:
        log(f"{title} [{time.perf_counter() - started:.1f} s into the run]")

    # float32 parity is claimed below: both TF32 switches off (matmul's is off
    # by default; the port runs no convolution, cuDNN's is set for the record)
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on")
    device_name = torch.cuda.get_device_name(0)
    power = nvidia_smi("name,power.limit")
    phase("phase 1: device")
    log(f"  {device_name}, {torch.cuda.device_count()} device(s), driver "
        f"{nvidia_smi('driver_version')}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}; {tf32_flags()}")
    log(power)

    phase("phase 2: build")
    info = build()
    load_library()
    log(f"  nvcc -gencode arch=compute_90a,code=sm_90a: {info.seconds:.1f} s -> "
        f"{info.path.name}")
    for line in info.log.splitlines():  # ptxas -v: each kernel, its registers and spills
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            log("  " + line.strip())

    gen = torch.Generator(device=dev).manual_seed(SEED)
    phase(f"phase 3: kernels vs plain versions ({CHECK_ROWS} x {DIM}, chunk {CHUNK}, k={K})")
    err = check_kernels(dev, gen)

    phase("phase 4: the retrieval server (E5-large geometry, bf16 compute, seeded weights)")
    config = BertConfig()
    model = BertModel(config, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    encoder = Encoder(model, "e5", compute_dtype=torch.bfloat16)
    collator = E5Collator(HashTokenizer(), query_maxlength=64, doc_maxlength=512)
    # the repo's bundled real-text questions (a data file; read by path, since
    # an installed package may own the name `tests`)
    texts = realtext_questions()
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
    text_rows = phase4_text_rows()
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
        phase(f"phase 5: kernels vs plain versions on the {label}, and their times")
        timed[label] = index_kernels(label, index, gen, power, err)
        del index
        torch.cuda.empty_cache()

    work = Path(tempfile.mkdtemp(prefix="kirag_smoke_"))
    try:
        phase("phase 6: the index build (E5-large geometry, bf16 compute, seeded weights)")
        built = index_build(work, dev, gen, config, power, err)

        phase("phase 7: K6 (int4 matmul) vs its plain version at the 8B model's projections")
        qmm = check_qmm(dev, gen, power)
        err["int4_matmul"] = max(r["err"] for r in qmm.values())

        phase("phase 8: the LLM at Llama-3-8B-Instruct geometry, NF4 weights, seeded")
        decoded = llm_decode(work, dev, power)

        phase("phase 9: KiRAG through kirag_tpu_torch.cli.retrieve (the phase 6 index, the "
            "phase 8 LLM)")
        kirag = kirag_cli(work, built, decoded, power)
        phase("phase 16: the evaluation pipeline (construct_kg_corpus, the int8 KV cache and "
              "run E, qa_eval, the TripleSelector) with phase 9's LLM")
        evaluated = eval_pipeline(work, built, decoded, power)
        phase("phase 17: speculative decoding and the prefix-KV pool (phase 8's model, a "
              "Llama-3.2-1B-geometry draft; runs F and G at phase 9's depth)")
        spec_pool = spec_and_pool(work, built, decoded, dev, power)
        phase("phase 12 (c): build_index --shuffle_rows, then cli/retrieve --search_mode approx "
              "(run C, beside phase 9 while its LLM is on the card) and cli/retrieval_eval")
        approx_run = approx_cli(work, built, decoded, kirag["A"], dev, power)
        phase("phase 14 (c), run D: cli/retrieve --index_folder over phase 6's embeddings as a "
              "PQ index (beside phase 9 while its LLM is on the card)")
        pq_run = pq_cli(work, built, decoded, dev, power)
        del decoded["params"]
        torch.cuda.empty_cache()
        phase("phase 19: the T5 reader backend at Flan-T5-XL width (seeded, bf16), card "
              "against CPU, the reader over run E, tracing, the host utilities")
        t5_phase(work, evaluated["E"]["path"], dev, power)

        phase("phase 10: Aligner training (E5-large geometry, f32 weights, bf16 compute)")
        trained = aligner_training(work, built, dev, gen, power)

        phase(f"phase 11 (a): K1/K2 with K4's int8/int4 scoring vs plain versions "
            f"({CHECK_ROWS} x {DIM}, chunk {CHUNK}, k={K})")
        check_quantized_kernels(dev, gen, err)
        mma_order = check_mma_order(dev, gen, err)
        phase(f"phase 11 (b): the retrieval server over {N_ROWS} x {DIM} int8 and int4 indexes")
        served_q = serve_compressed(dev, encoder, collator, host_rows, texts, text_rows, gen,
                                    power, err)
        phase(f"phase 12 (a): K5 (group top-W) vs its plain version ({CHECK_ROWS} x {DIM}), "
              f"and int4 at D = {INT4_DEPTHS}")
        depth_times = check_approx_kernels(dev, gen, err)
        phase(f"phase 12 (b): the retrieval server with search_mode='approx' over {N_ROWS} x "
              f"{DIM} shuffled float32 and int4 indexes")
        served_a, approx_timed, _ = serve_approx(dev, encoder, collator, host_rows, texts,
                                                 text_rows, text_emb, gen, power, err,
                                                 {**served, **served_q})
        phase(f"phase 13: l2 indexes (float32, int8, int4) over {N_ROWS} x {DIM}, exact and "
              "approximate serving")
        served_l2 = serve_l2(dev, encoder, collator, host_rows, texts, text_rows, power)
        phase(f"phase 14 (a): K1/K2/K7a with K4's pq4 scoring vs plain versions ({CHECK_ROWS} x "
              f"{DIM}, m = {PQ_MS}, chunk {CHUNK}, k={K})")
        pq_order = check_pq_kernels(dev, gen, err)
        log("  pq4 device kernels of one call (phase 11 (a)'s fresh process, Q=8): " + "; ".join(
            f"{name} {kernels}" for name, kernels in mma_order["kernels"].items()
            if name.endswith("_pq4")))
        phase("phase 14 (b): k-means and the PQ encoder on the card")
        check_pq_training(dev, gen, power)
        phase(f"phase 14 (c): the retrieval server over {N_ROWS} x {DIM} as a PQ index "
              f"(m={PQ_M})")
        served_pq = serve_pq(work, dev, encoder, collator, host_rows, texts, text_rows,
                             text_emb, gen, power, err)
        t15 = time.perf_counter()
        phase(f"phase 15 (a): K7a/K7b/K8/K9 vs plain versions ({CHECK_ROWS} x {DIM}, chunk "
              f"{CHUNK}, k={K}, {len(VARIANT_FORMATS)} formats)")
        copy_kernels = check_variant_kernels(dev, gen, err)
        phase(f"phase 15 (b): every (impl, select) over {N_ROWS} x {DIM} float32, bfloat16, "
              "int8, int4 and PQ indexes")
        variants = check_variants(dev, host_rows, gen, power)
        phase("phase 15 (c): the retrieval server with pallas_select='merge' and 'hier'")
        served_v = serve_variants(dev, encoder, collator, host_rows, texts, text_rows, power)
        phase15_s = time.perf_counter() - t15
        phase(f"phase 18: streaming search, {STREAM_ROWS} x {DIM} rows through the card "
              f"{STREAM_BLOCK} at a time from pinned host memory; the host C++")
        streamed = streaming(work, encoder, collator, text_emb, texts, dev, gen, power)
        phase(f"phase 20: the mesh (NCCL at world size 1; {MESH_RANKS} ranks on the card over "
              "gloo with sharded searches and Llama TP; torchrun of cli/retrieve --mesh_data 1)")
        meshed = mesh_phase(work, host_rows, {
            "encoder": encoder, "collator": collator, "texts": texts,
            "lone": served["float32 index"]["lone"]}, built, kirag["A"], dev, gen, power)
        phase(f"phase 21: training over a mesh (NCCL at world size 1; {MESH_RANKS} ranks on the "
              "card over gloo with DP and TP steps at E5-large width; torchrun of "
              "cli/train_aligner --mesh_data 1)")
        train_meshed = train_mesh_phase(work, built, trained["cli"], dev, power)
        del encoder, model, host_rows
        torch.cuda.empty_cache()
        phase("phase 11 (c): build_index --compression int4 and int8 over phase 6's shards")
        cli_q = quantized_cli(work, built, dev)
        phase(f"phase 11 (d) and 12 (d): the DPR scale, {DPR_ROWS} x {DIM} on the card, int4 "
              "then int8, exact and approximate search")
        dpr, dpr_ref = dpr_scale(dev, power, err)
        phase(f"phase 14 (d): the DPR scale as a PQ index (m={PQ_M}), {DPR_ROWS} x {DIM} "
              "encoded on the card")
        dpr["pq4"] = dpr_pq(dev, power, err, dpr_ref)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # K1/K2 times at Q=32 on the float32 index; K3's at T=512 in bf16, the
    # index build's largest bucket; K6's at gate_proj, NF4, 4 rows (a decode
    # step's largest per-layer projection at the Generator's batch); K3's
    # backward kernels' at the aligner's bf16 query batch. Launches: every
    # main-path run (phases 4, 6, 8, 9, 10's CLI run, 11 b-d, 12 b-d, 13,
    # 14 c-d, 16's four runs, 17's and 18's streamed searches, 20's and 21's
    # sharded runs and engines), not the comparisons.
    paths = [s["launches"] for s in served.values()] + [built["launches"]] + [
        r["launches"] for r in kirag.values()] + [trained["launches"]] + [
        s["launches"] for s in served_q.values()] + [
        r["launches"] for r in (*cli_q.values(), *dpr.values())] + [
        s["launches"] for s in (*served_a.values(), *served_l2.values())] + [
        approx_run["launches"], served_pq["served"]["launches"], pq_run["launches"]] + [
        dpr[q]["approx"]["launches"] for q in QUANTS] + [
        variants["launches"], dpr["int4"]["variants"]["launches"]] + [
        s["launches"] for s in served_v.values()] + [
        evaluated[run]["launches"] for run in ("kg", "E", "qa", "selector")] + spec_pool[
        "launches"] + streamed["launches"] + meshed["launches"] + train_meshed["launches"]
    launches = {k: sum(c[k] for c in paths) for k in paths[0]}
    launches["int4_matmul"] += decoded["launches"]
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels that no main-path run launched: {idle}")
    headline = timed["float32 index"][32]
    sources = {"stream_capture": ("kirag_tpu_torch/csrc/stream_capture.cu",
                                  "kirag_tpu/ops/pallas_exact.py:467"),
               "gather_groups": ("kirag_tpu_torch/csrc/gather_groups.cu",
                                 "kirag_tpu/ops/pallas_exact.py:785")}
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k],
                "max_abs_err": err[k], "ms": headline[k], "plain_ms": headline[k + "_plain"],
                "bound_ms": headline[k + "_bound"][0], "bound_by": headline[k + "_bound"][1],
                "library_ms": headline[k + "_library"],
                "at": f"Q=32, float32 index {N_ROWS} x {DIM}, chunk {CHUNK}, k={K}"
                      + ("; launches count calls, a float call two kernels "
                         "(capture_sweep_kernel, peel_capture_kernel), ms both; library_ms: "
                         "torch.matmul (TF32 off) and amax, the maxima only"
                         if k == "stream_capture" else "; library_ms: an index gather of the "
                         "selected groups' rows and a batched product")}
               for k, (src, rep) in sources.items()]
    k2_times = {"float32 1M": timed["float32 index"], "bfloat16 1M": timed["bfloat16 index"],
                "float32 built index (16,384 rows)": built["k2"]}
    kernels[1]["at"] += ("; by_q: the float indexes at each Q; launches_by_shape: the main "
                         "path's float32 and bfloat16 calls by format, Q, k and the corpus's "
                         "groups")
    kernels[1]["by_q"] = {
        where: {str(n_q): {"ms": t1["gather_groups"], "plain_ms": t1["gather_groups_plain"],
                           "bound_ms": t1["gather_groups_bound"][0],
                           "bound_by": t1["gather_groups_bound"][1],
                           "library_ms": t1["gather_groups_library"]}
                for n_q, t1 in by.items()} for where, by in k2_times.items()}
    kernels[1]["launches_by_shape"] = shapes_of("float32", "bfloat16")
    k3 = built["flash"][(torch.bfloat16, 512, "segments")]
    kernels.append({"name": "flash_attention", "route": "cuda",
                    "source": "kirag_tpu_torch/csrc/flash_attention.cu",
                    "replaces": "kirag_tpu/models/bert.py:179",
                    "launches": launches["flash_attention"],
                    "max_abs_err": err["flash_attention"],
                    "max_abs_err_f32": err["flash_attention_f32"], "ms": k3["ms"],
                    "plain_ms": k3["plain_ms"], "bound_ms": k3["bound"][0],
                    "bound_by": k3["bound"][1], "library_ms": k3["library_ms"],
                    "at": f"bf16 [{BATCH}, {config.num_attention_heads}, 512, 64], mixed "
                          "padded, unpadded, all-padding and packed segment rows; "
                          "library_ms: scaled_dot_product_attention with the "
                          "same-segment mask"})
    k6 = qmm[("nf4", "gate_proj, up_proj", 4)]
    kernels.append({"name": "int4_matmul", "route": "cuda",
                    "source": "kirag_tpu_torch/csrc/int4_matmul.cu",
                    "replaces": "kirag_tpu/ops/pallas_qmm.py:69",
                    "launches": launches["int4_matmul"], "max_abs_err": err["int4_matmul"],
                    "ms": k6["ms"], "plain_ms": k6["plain_ms"], "bound_ms": k6["bound"][0],
                    "bound_by": k6["bound"][1], "library_ms": k6["library_ms"],
                    "at": "NF4 gate_proj [2048, 14336] packed, 4 bf16 rows, cold L2; "
                          "library_ms: torch.matmul with the dequantized bf16 kernel (the "
                          "bf16 model's product, 4x the weight bytes)"})
    bwd, bwd_f32 = trained["flash_bwd"][torch.bfloat16], trained["flash_bwd"][torch.float32]
    flash_py = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    for key, kernel, line in (("dkv", "flash_attention_bwd_dkv", 796),
                              ("dq", "flash_attention_bwd_dq", 1146)):
        if trained["launches_f32"][kernel] == 0:
            raise AssertionError(f"{kernel}: no f32 launch in the f32 training steps")
        kernels.append({"name": kernel, "route": "cuda",
                        "source": "kirag_tpu_torch/csrc/flash_attention_bwd.cu",
                        "replaces": f"{flash_py}:{line}",
                        "launches": launches[kernel],
                        "launches_f32": trained["launches_f32"][kernel],
                        "max_abs_err": bwd[f"err_{key}"],
                        "max_abs_err_f32": bwd_f32[f"err_{key}"], "ms": bwd[f"{key}_ms"],
                        "plain_ms": bwd["plain_ms"], "bound_ms": bwd[f"bound_{key}"][0],
                        "bound_by": bwd[f"bound_{key}"][1], "library_ms": bwd["library_ms"],
                        "ms_f32": bwd_f32[f"{key}_ms"], "plain_ms_f32": bwd_f32["plain_ms"],
                        "bound_ms_f32": bwd_f32[f"bound_{key}"][0],
                        "bound_by_f32": bwd_f32[f"bound_{key}"][1],
                        "bound_ms_f32_cuda_cores": bwd_f32["bound_cuda_cores"][f"bound_{key}"][0],
                        "library_ms_f32": bwd_f32["library_ms"],
                        "at": f"bf16 {list(BWD_SHAPE)} (the aligner's query batch), mixed "
                              "padded, unpadded, all-padding and packed segment rows; the "
                              "backward of K3, reached from kirag_tpu/models/bert.py:179; "
                              "plain_ms and library_ms: the whole backward (dq, dk, dv), "
                              "the plain version and scaled_dot_product_attention's "
                              "backward with the same-segment mask; launches: the bf16 "
                              "train_aligner run; the *_f32 keys: f32 at the same shape "
                              "(dkv_tf32_kernel, dq_tf32_kernel: split-TF32 products on the "
                              "tensor cores), launches_f32 from the f32 training steps of "
                              "the gradient check, bound_ms_f32 at 495 / 3 TFLOP/s (3xTF32), "
                              "bound_ms_f32_cuda_cores at the CUDA cores' 67"})
    # K4 (int8/int4/pq4 scoring inside K1 and K2): times at the DPR scale, Q=8
    # (where the plain versions were timed too), the other Qs beside them
    for quant in (*QUANTS, "pq4"):
        times = dpr[quant]["times"]
        for key, kernel, line in (("k1", "stream_capture", 467), ("k2", "gather_groups", 785)):
            variant = f"{kernel}_{quant}"
            t = times[DPR_QUERIES[0]]
            kernels.append({
                "name": variant, "route": "cuda", "source": f"kirag_tpu_torch/csrc/{kernel}.cu",
                "replaces": "kirag_tpu/ops/pallas_exact.py:" + ("235" if quant == "pq4" else "224"),
                "launches": launches[variant],
                "max_abs_err": err[variant], "ms": t[f"{key}_ms"], "plain_ms": t[f"{key}_plain_ms"],
                "bound_ms": t[f"{key}_bound"][0], "bound_by": t[f"{key}_bound"][1],
                "library_ms": None,
                "at": f"K4's {quant} scoring (_chunk_scores) inside "
                      f"kirag_tpu/ops/pallas_exact.py:{line}; {quant} {DPR_ROWS} x {DIM} "
                      f"(the DPR corpus, {dpr[quant]['gb']:.2f} GB), Q={DPR_QUERIES[0]}, chunk "
                      f"{CHUNK}, k={K}; by_q: the other query counts",
                "by_q": {str(n_q): {"ms": times[n_q][f"{key}_ms"],
                                    "bound_ms": times[n_q][f"{key}_bound"][0],
                                    "bound_by": times[n_q][f"{key}_bound"][1]}
                         for n_q in DPR_QUERIES},
                "recall_at_10": dpr[quant]["recall"][10],
                "recall_at_100": dpr[quant]["recall"][K]})
            if key == "k2":
                kernels[-1]["launches_by_shape"] = shapes_of(quant)
            if quant == "pq4":  # the served 1M index, Q = 8, 16, 32
                kernels[-1]["at"] += (f"; by_q_1m: the served {N_ROWS}-row PQ index; "
                                      "mma_order: the position probe's pair and error")
                kernels[-1]["mma_order"] = {f"m={m}": v for m, v in pq_order["probe"].items()}
                kernels[-1]["device_kernels_a_call"] = mma_order["kernels"][variant]
                kernels[-1]["by_q_1m"] = {
                    str(n_q): {"ms": t1[kernel], "plain_ms": t1[kernel + "_plain"],
                               "bound_ms": t1[kernel + "_bound"][0],
                               "bound_by": t1[kernel + "_bound"][1]}
                    for n_q, t1 in served_pq["timed"].items()}
            if quant in QUANTS:  # the served 1M index, Q = 8, 16, 32, 256
                kernels[-1]["at"] += (f"; by_q_1m: the served {N_ROWS}-row {quant} index; "
                                      "mma_order: the position probe's pair and error")
                kernels[-1]["by_q_1m"] = {
                    str(n_q): {"ms": t1[kernel], "plain_ms": t1[kernel + "_plain"],
                               "bound_ms": t1[kernel + "_bound"][0],
                               "bound_by": t1[kernel + "_bound"][1]}
                    for n_q, t1 in served_q[f"{quant} index"]["timed"].items()}
                kernels[-1]["mma_order"] = {f"D={d}": v for (fmt, d), v
                                            in mma_order["probe"].items() if fmt == quant}
                kernels[-1]["device_kernels_a_call"] = mma_order["kernels"][variant]
            if variant == "stream_capture_int4":  # the depths the card took since this slice
                kernels[-1]["by_depth"] = {
                    f"D={d} Q={n_q} ({CHECK_ROWS} rows)": {
                        "ms": t["k1_ms"], "plain_ms": t["k1_plain_ms"],
                        "bound_ms": t["k1_bound"][0], "bound_by": t["k1_bound"][1]}
                    for (d, n_q), t in depth_times.items()}
    # K5 (group top-W): the float kernel on phase 12 (b)'s shuffled float32
    # index at Q=32, W=1; the int8 and int4 kernels at the DPR scale (phase
    # 12 d), Q=8, W=1, where their plain versions were timed too
    k5_rows = [("group_max", approx_timed["float32"], 32,
                f"float32 shuffled index {N_ROWS} x {DIM} (1,000,064 rows in its groups), Q=32, "
                "W=1; library_ms: torch.matmul (TF32 off) and max (W > 1: topk) over 128-row "
                "groups; by_q: Q and W; by_q_bf16: a bfloat16 copy of the rows (bf16 library "
                "scores)", approx_timed["bfloat16"]),
               *((k5_name(quant), dpr[quant]["approx"]["times"], DPR_QUERIES[0],
                  f"{quant} {DPR_ROWS} x {DIM} (the DPR corpus), Q={DPR_QUERIES[0]}, W=1; by_q: "
                  "Q and W; library_ms: no PyTorch call scores codes against bf16 queries",
                  None) for quant in QUANTS)]

    def k5_by_q(times):
        return {f"Q={q} W={w}": {"ms": x["ms"], "bound_ms": x["bound"][0],
                                 "bound_by": x["bound"][1], "library_ms": x.get("library_ms")}
                for (q, w), x in times.items()}

    for name, times, n_q, at, bf16_times in k5_rows:
        t = times[(n_q, 1)]
        kernels.append({
            "name": name, "route": "cuda", "source": "kirag_tpu_torch/csrc/group_max.cu",
            "replaces": "kirag_tpu/ops/pallas_mips.py:42", "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t.get("library_ms"), "at": at, "by_q": k5_by_q(times)})
        if name in mma_order["kernels"]:
            kernels[-1]["device_kernels_a_call"] = mma_order["kernels"][name]
        if bf16_times is not None:
            kernels[-1]["by_q_bf16"] = k5_by_q(bf16_times)
    # K7a/K7b/K8/K9 (phase 15): times at Q=32 on phase 15 (b)'s 1M indexes
    # (float32; int8 and PQ for their K7a), K7a int4 at the DPR scale, Q=8;
    # by_q / by_q_21m: the DPR scale's other query counts
    t_1m, t_dpr = variants["times"], dpr["int4"]["variants"]["times"]
    at_1m = f"{{}} index {N_ROWS} x {DIM} (1,015,808 rows on the grid), Q=32, chunk {CHUNK}, k={K}"
    no_lib = {"score_gmax": "no PyTorch call scores {} codes against bf16 queries",
              "window_merge": "no PyTorch call merges a running top-k window of groups"}
    k7_rows = [("score_gmax", "score_gmax", t_1m["float32"], at_1m.format("float32")
                + "; chunk-major store; library_ms: torch.matmul (TF32 off) and amax over "
                "128-row groups, two calls"),
               ("score_gmax_int8", "score_gmax", t_1m["int8"], at_1m.format("int8") + "; "
                + no_lib["score_gmax"].format("int8")),
               ("score_gmax_int4", "score_gmax", t_dpr[8], f"int4 {DPR_ROWS} x {DIM} (the DPR "
                f"corpus), Q=8, chunk-major store; {no_lib['score_gmax'].format('int4')}; by_q: "
                "Q=32"),
               ("score_gmax_pq4", "score_gmax", t_1m["pq4"], at_1m.format(f"PQ (m={PQ_M})")
                + "; " + no_lib["score_gmax"].format("PQ")),
               ("score_gather", "score_gather", t_1m["float32"], at_1m.format("float32")
                + "; library_ms: index_select of the groups' rows of the scores viewed "
                "[rows, 128] (the flat row ids made beforehand); by_q_21m: the int4 DPR "
                "corpus"),
               ("cap_assemble", "cap_assemble", t_1m["float32"], at_1m.format("float32")
                + "; library_ms: index_select of the capture viewed [rows, 128] (the flat "
                "row ids made beforehand, contiguous); by_q_21m: the int4 DPR corpus"),
               ("window_merge", "window_merge", t_1m["float32"], at_1m.format("float32")
                + f"; K1's capture, br={t_1m['float32']['br']}; library_ms: "
                + no_lib["window_merge"] + "; by_q_21m: the int4 DPR corpus; "
                "reference_queries: the queries that took the reference's steps")]
    for name, kernel, t, at in k7_rows:
        src, rep = K7_SOURCES[kernel]
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": launches[name], "max_abs_err": err[name], "ms": t[kernel],
               "plain_ms": t[kernel + "_plain"], "bound_ms": t[kernel + "_bound"][0],
               "bound_by": t[kernel + "_bound"][1], "library_ms": t.get(kernel + "_library"),
               "at": at}
        by_q = {str(n_q): {"ms": x[kernel], "bound_ms": x[kernel + "_bound"][0],
                           "bound_by": x[kernel + "_bound"][1],
                           "library_ms": x.get(kernel + "_library")}
                for n_q, x in t_dpr.items() if kernel in x}
        if name in mma_order["kernels"]:
            row["device_kernels_a_call"] = mma_order["kernels"][name]
        if name == "score_gmax_int4":
            row["by_q"] = {q: v for q, v in by_q.items() if q != str(DPR_QUERIES[0])}
        elif kernel != "score_gmax":
            row["by_q_21m"] = by_q
        if kernel == "window_merge":  # the queries that took the reference's steps
            row["reference_queries"] = t["window_merge_reference_queries"]
            for n_q, v in by_q.items():
                v["reference_queries"] = t_dpr[int(n_q)]["window_merge_reference_queries"]
        if kernel in copy_kernels:  # K7b, K8: every Q on the float32 index, one kernel a call
            row["at"] += "; by_q_1m: the float32 index at each Q"
            row["by_q_1m"] = {
                str(n_q): {"ms": x[kernel], "plain_ms": x[kernel + "_plain"],
                           "bound_ms": x[kernel + "_bound"][0],
                           "bound_by": x[kernel + "_bound"][1],
                           "library_ms": x[kernel + "_library"]}
                for n_q, x in variants["copies"].items()}
            row["device_kernels_a_call"] = copy_kernels[kernel]
        kernels.append(row)
    merge_s, hier_s = served_v["merge"], served_v["hier"]
    log(f"  phase 15: {phase15_s + dpr['int4']['variants']['seconds']:.1f} s in all "
        f"((a)-(c) {phase15_s:.1f} s, (d) {dpr['int4']['variants']['seconds']:.1f} s); servers "
        f"merge {merge_s['rps']:.2f} / hier {hier_s['rps']:.2f} requests/s, K2 ran in "
        f"{merge_s['launches']['gather_groups']} of merge's {merge_s['searches']} searches "
        f"(in-search fallback) and hier re-dispatched {hier_s['redispatched']} of "
        f"{hier_s['searches']}")
    phase("done")
    log(f"  K2's main-path launches by shape (format, Q, k, the corpus's groups): {K2_SHAPES}")
    log(power)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-retrieve"]:  # phase 20 (c)'s rank, under torchrun
        sys.exit(mesh_retrieve(sys.argv[2]))
    if sys.argv[1:2] == ["--train-mesh"]:  # phase 21 (c)'s rank, under torchrun
        sys.exit(train_mesh_cli(sys.argv[2]))
    sys.exit(main())

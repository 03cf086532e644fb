"""Time the int8/int4/pq4 search kernels of a tree of this repository on the card.

K1 (``stream_capture``), K2 (``gather_groups``), K5 (``group_max``, W = 1;
not pq4) and K7a (``score_gmax``, chunk-major store) over seeded random
codes and scales (pq4: m = 256 codes and a [16, 1024] level table) made on
the card (the same in every process): 1,015,808 x 1024 rows at Q = 8, 16,
32, 256 and the DPR corpus's 21,015,324 x 1024 (on the 16,384-row chunk
grid) at Q = 8, 32, 256, each time beside its bound (the bytes read once
at 3.35 TB/s, or 2 Q N D operations at the bf16 989 TFLOP/s). Times are
``chip_smoke.cuda_ms``'s: CUDA events around one call, the card kept busy
while the host enqueues it, median of 10 (21M: 5; 21M at Q = 256: 3).

    python tools/time_quantized_kernels.py time TREE LABEL OUT.json [k1,k2,k5,k7a] [int8,int4,pq4]

imports TREE's ``kirag_tpu_torch`` (so an older tree unpacked with ``git
archive`` is timed by its own kernels, built into its own build directory);
one process a tree, and two trees compared in turns in one call on one card.

    python tools/time_quantized_kernels.py variant NAME DEST

copies this tree's ``kirag_tpu_torch`` to DEST with one of VARIANTS
applied: other ring depths and occupancies, int4 in two walks, a fuller
unroll, pq4's table with every t on the same banks and its sweeps at one
block an SM, and diagnostics that are wrong on purpose (no decode, no mma,
no copies, no compute; pq4: no table lookup, no copies, no compute) to
split a time into its parts. Time it with ``time``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CHUNK, K, D = 16384, 100, 1024
DPR_ROWS = 21_015_324
SIZES = {"1M": (62 * CHUNK, 62 * CHUNK - 4192),
         "21M": (-(-DPR_ROWS // CHUNK) * CHUNK, DPR_ROWS)}
FORMATS = ("int8", "int4", "pq4")
PQ_M = 256
QUERIES = {"1M": (8, 16, 32, 256), "21M": (8, 32, 256)}
HBM_BYTES_S, BF16_FLOP_S = 3.35e12, 989e12

SCORE = "kirag_tpu_torch/csrc/score.cuh"
EXACT = "kirag_tpu_torch/kernels/exact.py"


def ring(stages: int, blocks: int):
    return [(SCORE, "constexpr int SWEEP_STAGES = 2;", f"constexpr int SWEEP_STAGES = {stages};"),
            (SCORE, "constexpr int SWEEP_BLOCKS_PER_SM = 2;",
             f"constexpr int SWEEP_BLOCKS_PER_SM = {blocks};"),
            (EXACT, "STAGES = 2 ", f"STAGES = {stages} "),
            (EXACT, "BLOCKS_PER_SM = 2 ", f"BLOCKS_PER_SM = {blocks} ")]


# name: [(file, text, replacement)], each text found exactly once
VARIANTS = {
    "stages3": ring(3, 1),
    "stages4": ring(4, 1),
    "one_block": ring(2, 1),
    "two_walks": [(SCORE, "  const bool one_walk = kInt4 &&", "  const bool one_walk = false &&")],
    "unroll_all": [(SCORE, "#pragma unroll 2  // fuller unrolling spills (ptxas -v)",
                    "#pragma unroll")],
    # wrong on purpose: timing only
    "no_decode": [(SCORE, "  lo = bf16x2_add(prmt(m, 0x43434343u, 0x4140u), prmt(b7, 0xC3C3C3C3u, "
                          "0x4140u));", "  lo = m;"),
                  (SCORE, "  hi = bf16x2_add(prmt(m, 0x43434343u, 0x4342u), prmt(b7, 0xC3C3C3C3u, "
                          "0x4342u));", "  hi = b7;"),
                  (SCORE, "  lo = bf16x2_add(prmt(x, 0x42424242u, 0x4140u), 0xC28FC28Fu);",
                   "  lo = x;"),
                  (SCORE, "  hi = bf16x2_add(prmt(x, 0x42424242u, 0x4342u), 0xC28FC28Fu);",
                   "  hi = x >> 1;")],
    "no_mma": [(SCORE, '  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "\n'
                       '      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"\n'
                       '      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])\n'
                       '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));',
                '  d[0] += __uint_as_float(a[0] ^ b0);\n  d[1] += __uint_as_float(a[1] ^ b1);\n'
                '  d[2] += __uint_as_float(a[2] ^ b0);\n  d[3] += __uint_as_float(a[3] ^ b1);')],
    "no_compute": [(SCORE, "      if (mine) mma_slot_fold<kInt4, NT>(acc, slot_rows(k), "
                           "slot_queries(k, 0), s, d, sc, lane);",
                    "      if (mine && n_q < 0) mma_slot_fold<kInt4, NT>(acc, slot_rows(k), "
                    "slot_queries(k, 0), s, d, sc, lane);"),
                   (SCORE, "            mma_slot_planes<NT>(lo, hi[s], slot_rows(k), "
                           "slot_queries(k, 0),",
                    "            if (n_q < 0) mma_slot_planes<NT>(lo, hi[s], slot_rows(k), "
                    "slot_queries(k, 0),")],
    "no_copies": [(SCORE, "    if (k < total) {\n      const int p = k / n_slots;",
                   "    if (k < total && n_q < 0) {\n      const int p = k / n_slots;")],
    # pq4: every t on the same banks (W = 1: a correct layout that clashes),
    # one block an SM at every query tile, and wrong-on-purpose diagnostics
    # (no table lookup, no compute, no copies)
    "pq_shared_banks": [(SCORE, "constexpr int pq_ways() { return 128 / (16 * pq_entry_bytes<DS>()); }",
                         "constexpr int pq_ways() { return 1; }"),
                        (EXACT, "    w = 128 // (16 * eb)", "    w = 1")],
    "pq_one_block": [(SCORE, "constexpr int PQ_TWO_BLOCKS_MAX_QT = 8;",
                      "constexpr int PQ_TWO_BLOCKS_MAX_QT = 0;"),
                     (EXACT, "PQ_TWO_BLOCKS_MAX_QT = 8   #", "PQ_TWO_BLOCKS_MAX_QT = 0   #")],
    "pq_no_lookup": [(SCORE, "            v[mt][r][e] = lds_entry<EB>(prmt(x, tp, 0x7650u | e) + (4 * ks + e) * H * 128);",
                      "            v[mt][r][e] = prmt(x, tp, 0x7650u | e) + (4 * ks + e) * H * 128;")],
    "pq_no_compute": [(SCORE, "        pq_slot<DS, NT>(ch, rows,",
                       "        if (n_q < 0) pq_slot<DS, NT>(ch, rows,")],
    "pq_no_copies": [(SCORE, "    if (k < total) {\n      const int p = k / items;",
                      "    if (k < total && n_q < 0) {\n      const int p = k / items;")],
}


def make_variant(name: str, dest: str) -> None:
    """This tree's kirag_tpu_torch at ``dest``, with VARIANTS[name] applied."""
    out = Path(dest)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "kirag_tpu_torch", out / "kirag_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for rel, old, new in VARIANTS[name]:
        path = out / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} found {text.count(old)} times in {rel}")
        path.write_text(text.replace(old, new))


def time_tree(tree: str, label: str, out_path: str, kernels=("k1", "k2", "k5", "k7a"),
              formats=FORMATS) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import kirag_tpu_torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)  # this tree's timer, whatever TREE is
    spec.loader.exec_module(chip_smoke)
    from kirag_tpu_torch.kernels import (gather_groups, group_max, load_library, score_gmax,
                                         stream_capture)
    from kirag_tpu_torch.ops.exact import _capture_budget

    if not kirag_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {kirag_tpu_torch.__file__}, not {tree}'s package")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    load_library()
    dev = torch.device("cuda")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def bound(n_bytes, ops):
        t_bytes, t_ops = n_bytes / HBM_BYTES_S, ops / BF16_FLOP_S
        return [max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"]

    res = {"device": torch.cuda.get_device_name(0),
           "power": chip_smoke.nvidia_smi("name,power.limit")}
    g = torch.Generator(device=dev).manual_seed(123)
    queries = torch.nn.functional.normalize(torch.randn(256, D, generator=g, device=dev), dim=-1)
    for quant in formats:
        for size, (n, valid) in SIZES.items():
            gen = torch.Generator(device=dev).manual_seed(7)
            if quant == "int8":
                codes = torch.randint(-127, 128, (n, D), generator=gen, device=dev,
                                      dtype=torch.int8)
                scales = torch.rand(n, generator=gen, device=dev) * 0.01
            elif quant == "pq4":  # scales: the level table of every row
                codes = torch.randint(0, 256, (n, PQ_M // 2), generator=gen, device=dev,
                                      dtype=torch.uint8)
                scales = torch.randn(16, D, generator=gen, device=dev) / D ** 0.5
            else:
                codes = torch.randint(0, 256, (n, D // 2), generator=gen, device=dev,
                                      dtype=torch.uint8)
                scales = torch.rand(n, D // 128, generator=gen, device=dev) * 0.01
            b = _capture_budget(K, n // CHUNK, CHUNK // 128)
            for n_q in QUERIES[size]:
                q = queries[:n_q]
                reps = 3 if (size == "21M" and n_q == 256) else (5 if size == "21M" else 10)
                r = {}
                if "k1" in kernels:
                    outs = stream_capture(q, codes, valid, CHUNK, b, scales, quant)
                    r["k1"] = chip_smoke.cuda_ms(
                        lambda: stream_capture(q, codes, valid, CHUNK, b, scales, quant), reps)
                    r["k1_bound"] = bound(nbytes(q, codes, scales, *outs), 2 * n_q * n * D)
                    del outs
                if "k2" in kernels:
                    gg = torch.Generator(device=dev).manual_seed(99 + n_q)
                    gsel = torch.sort(torch.rand(n_q, n // 128, generator=gg, device=dev)
                                      .topk(K).indices, dim=-1).values.to(torch.int32)
                    cand = gather_groups(q, codes, gsel, scales, quant)
                    r["k2"] = chip_smoke.cuda_ms(
                        lambda: gather_groups(q, codes, gsel, scales, quant), reps)
                    row = codes.shape[1] * codes.element_size()
                    shared = nbytes(q, gsel, cand)
                    if quant == "pq4":
                        shared += nbytes(scales)
                    else:
                        row += scales[0].numel() * 4
                    r["k2_bound"] = bound(int(torch.unique(gsel).numel()) * 128 * row + shared,
                                          2 * gsel.numel() * 128 * D)
                    del cand
                if "k5" in kernels and quant != "pq4":
                    k5 = group_max(q, codes, 1, scales, quant)
                    r["k5"] = chip_smoke.cuda_ms(lambda: group_max(q, codes, 1, scales, quant),
                                                 reps)
                    r["k5_bound"] = bound(nbytes(q, codes, scales, *k5), 2 * n_q * n * D)
                    del k5
                if "k7a" in kernels and not (size == "21M" and n_q == 256):  # 21 GB of scores
                    k7 = score_gmax(q, codes, valid, CHUNK, "chunk", scales, quant)
                    r["k7a"] = chip_smoke.cuda_ms(
                        lambda: score_gmax(q, codes, valid, CHUNK, "chunk", scales, quant), reps)
                    r["k7a_bound"] = bound(nbytes(q, codes, scales, *k7), 2 * n_q * n * D)
                    del k7
                key = f"{quant} {size} Q={n_q}"
                res[key] = r
                print(f"[{label}] {key}: " + ", ".join(
                    f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v[0]:.4f} ({v[1]})"
                    for k, v in r.items()), flush=True)
            del codes, scales
            torch.cuda.empty_cache()
    Path(out_path).write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    if len(sys.argv) >= 5 and sys.argv[1] == "time":
        time_tree(sys.argv[2], sys.argv[3], sys.argv[4],
                  tuple(sys.argv[5].split(",")) if len(sys.argv) > 5 else ("k1", "k2", "k5",
                                                                            "k7a"),
                  tuple(sys.argv[6].split(",")) if len(sys.argv) > 6 else FORMATS)
    elif len(sys.argv) == 4 and sys.argv[1] == "variant":
        make_variant(sys.argv[2], sys.argv[3])
    else:
        sys.exit(__doc__)

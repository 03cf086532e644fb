"""Time K9 (``window_merge``) and K2's float re-score (``gather_groups`` on
float32 and bfloat16 corpora) of a tree of this repository on the card.

K9 over K1-shaped outputs made on the card from a seed: each chunk's bc = 8
groups (distinct, of its 128) with keys in descending order and a residual
below them, at the DPR corpus's geometry (C = 1283 chunks, br = 104) at Q =
8, 32, 256 and the served 1M index's (C = 62) at Q = 32. Keys "random"
(normal: the segments) and "integer" (-2..2, ties across the peel's edge:
queries go to the reference's steps; the count of such queries where the
tree reports it). K2 over seeded unit rows: 1,015,808 x 1024 float32 and
bfloat16 at Q = 8, 16, 32 (each query's top 100 of random group scores, so
few groups are shared), and the built index's 16,384 rows at Q = 8, 64 (100
of its 128 groups a query, so most are shared), beside one PyTorch call for
the same function (``chip_smoke.library_gather``). Each time beside its
bound (the bytes read once at 3.35 TB/s; K2 also 2 Q k 128 D operations at
the f32 67 TFLOP/s, whichever is longer). Times are ``chip_smoke.cuda_ms``'s:
CUDA events around one call, the card kept busy while the host enqueues it,
median of 10.

    python tools/time_merge_gather.py time TREE LABEL OUT.json [k9|k2]

imports TREE's ``kirag_tpu_torch`` (so an older tree unpacked with ``git
archive`` is timed by its own kernels, built into its own build directory);
one process a tree, and two trees compared in turns in one call on one card.

    python tools/time_merge_gather.py segments OUT.json

times this tree's K9 at 8, 16 and 32 segments a query (random keys; C =
1283 at Q = 8, 32, 256 and C = 62 at Q = 32).

    python tools/time_merge_gather.py variant NAME DEST

copies this tree's ``kirag_tpu_torch`` to DEST with one of VARIANTS applied:
wrong on purpose, to split a time into its parts, K9 stopped after the
segments' first sweep, after the scan, or after the replay, or without one
of them (never taking the reference's steps), and K2 stopped after the scan
of the pair list, without the fmas, or without the row loads; or K2 with a
ring of three slots (one block an SM). Time it with ``time``.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
K, D, BC, BR, GROUPS = 100, 1024, 8, 104, 128
MERGE_CASES = [("21M", 1283, q) for q in (8, 32, 256)] + [("1M", 62, 32)]
GATHER_CASES = [("1M", 1015808, q) for q in (8, 16, 32)] + [("built", 16384, q) for q in (8, 64)]
HBM_BYTES_S, F32_FLOP_S = 3.35e12, 67e12

MERGE = "kirag_tpu_torch/csrc/window_merge.cu"
GATHER = "kirag_tpu_torch/csrc/gather_groups.cu"
NEVER_REFERENCE = (MERGE, "  const bool reference = head[0] != 0;",
                   "  const bool reference = false;")
# name: [(file, text, replacement)], each text found exactly once
VARIANTS = {
    "k9_no_first_sweep": [NEVER_REFERENCE, (MERGE, "    sweep<false>(mine, winners,",
                                            "    if (false) sweep<false>(mine, winners,")],
    "k9_no_scan": [NEVER_REFERENCE,  # each warp replays from its own segment's top list
                   (MERGE, "    for (int span = 1; span < n_seg; span *= 2) {",
                    "    for (int span = n_seg; span < n_seg; span *= 2) {"),
                   (MERGE, "      copy_list(list_of(warp - 1, head[4 + warp - 1]), start, br);",
                    "      copy_list(list_of(warp, head[4 + warp]), start, br);")],
    "k9_no_replay": [NEVER_REFERENCE, (MERGE, "    sweep<true>(start, winners,",
                                       "    if (false) sweep<true>(start, winners,")],
    # K9 stopped after a phase (each phase's cost is the step between two)
    "k9_stop_after_first_sweep": [(MERGE, "    // B: the window after each segment",
                                   "    return;\n    // B: the window after each segment")],
    "k9_stop_after_scan": [(MERGE, "    // C: the replay, writing lost",
                            "    return;\n    // C: the replay, writing lost")],
    "k9_stop_after_replay": [(MERGE, "    if (lane == 0 && flag) head[0] = 1;\n",
                              "    if (lane == 0 && flag) head[0] = 1;\n    return;\n")],
    "k2_scan_only": [(GATHER, "  if (tiles == 0) return;", "  return;")],
    # a ring of three slots, one block an SM
    "k2_three_slots": [(GATHER, "  constexpr int NS = SWEEP_STAGES;", "  constexpr int NS = 3;"),
                       (GATHER, "static_cast<size_t>(SWEEP_STAGES) * gather_stage_bytes<T>()",
                        "static_cast<size_t>(3) * gather_stage_bytes<T>()"),
                       (GATHER, "__global__ void __launch_bounds__(THREADS, SWEEP_BLOCKS_PER_SM)",
                        "__global__ void __launch_bounds__(THREADS, 1)")],
    "k2_no_fma": [(GATHER, "    if (busy) {\n      fma_pass_tile",
                   "    if (false) {\n      fma_pass_tile")],
    "k2_no_row_loads": [(GATHER, "    if (u < tiles) {\n      const T* src",
                         "    if (u < 0) {\n      const T* src")],
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


def k9_inputs(n_c: int, n_q: int, keys: str, dev):
    """K1-shaped capdom outputs made on the card (seed 11 + Q): each chunk's
    BC groups of its GROUPS with keys in descending order, a residual below
    them, a random payload; the arguments of ``window_merge``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(11 + n_q)
    shape = (n_c, BC, n_q)
    v = (torch.randn(shape, generator=g, device=dev) if keys == "random" else
         torch.randint(-2, 3, shape, generator=g, device=dev).float())
    capmax = v.sort(dim=1, descending=True).values.contiguous()
    local = torch.rand(n_c, GROUPS, n_q, generator=g, device=dev).argsort(dim=1)[:, :BC]
    gids = (local + torch.arange(n_c, device=dev).view(-1, 1, 1) * GROUPS).to(
        torch.int32).contiguous()
    resid = (capmax[:, -1:, :] - 1).contiguous()
    capture = torch.randn(n_c, n_q, BC * 128, generator=g, device=dev)
    return gids, capmax, resid, capture, BR, n_c * GROUPS


def time_segments(out_path: str) -> dict:
    """This tree's K9 on random keys at explicit segment counts (the
    evidence for ``kernels.exact.merge_segments``)."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from kirag_tpu_torch.kernels import window_merge

    dev = torch.device("cuda")
    res = {"power": chip_smoke.nvidia_smi("name,power.limit")}
    for n_c, n_q in ((1283, 8), (1283, 32), (1283, 256), (62, 32)):
        args = k9_inputs(n_c, n_q, "random", dev)
        res[f"C={n_c} Q={n_q}"] = {
            s: chip_smoke.cuda_ms(lambda: window_merge(*args, segments=s)) for s in (8, 16, 32)}
        print(f"K9 C={n_c} Q={n_q}: {res[f'C={n_c} Q={n_q}']}", flush=True)
    Path(out_path).write_text(json.dumps(res, indent=1))
    return res


def time_tree(tree: str, label: str, out_path: str, which=("k9", "k2")) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import kirag_tpu_torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)  # this tree's timer, whatever TREE is
    spec.loader.exec_module(chip_smoke)
    from kirag_tpu_torch.kernels import gather_groups, load_library, window_merge

    if not kirag_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {kirag_tpu_torch.__file__}, not {tree}'s package")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    load_library()
    dev = torch.device("cuda")
    reports_paths = "paths" in inspect.signature(window_merge).parameters

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def bound(n_bytes, ops=0.0):
        t_bytes, t_ops = n_bytes / HBM_BYTES_S, ops / F32_FLOP_S
        return [max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"]

    res = {"device": torch.cuda.get_device_name(0),
           "power": chip_smoke.nvidia_smi("name,power.limit")}
    for size, n_c, n_q in MERGE_CASES if "k9" in which else ():
        for keys in ("random", "integer"):
            args = k9_inputs(n_c, n_q, keys, dev)
            out = window_merge(*args)
            r = {"ms": chip_smoke.cuda_ms(lambda: window_merge(*args)),
                 "bound": bound(nbytes(*args[:3], *out[1:]) + 2 * nbytes(out[0]))}
            if reports_paths:
                paths = torch.zeros(n_q, dtype=torch.int32, device=dev)
                window_merge(*args, paths=paths)
                r["reference_queries"] = int(paths.sum())
            key = f"K9 {size} {keys} Q={n_q}"
            res[key] = r
            print(f"[{label}] {key}: {r}", flush=True)
            del args, out
    for size, n, n_q in GATHER_CASES if "k2" in which else ():
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(5)
            corpus = chip_smoke.unit_rows(n, g, dev, D).to(dtype)
            q = chip_smoke.unit_rows(n_q, g, dev, D).to(dtype)
            gsel = torch.sort(torch.rand(n_q, n // 128, generator=g, device=dev).topk(K).indices,
                              dim=-1).values
            cand = gather_groups(q, corpus, gsel)
            row = D * corpus.element_size()
            r = {"ms": chip_smoke.cuda_ms(lambda: gather_groups(q, corpus, gsel)),
                 "library_ms": chip_smoke.cuda_ms(
                     lambda: chip_smoke.library_gather(q, corpus, gsel)),
                 "distinct_groups": int(torch.unique(gsel).numel()),
                 "bound": bound(int(torch.unique(gsel).numel()) * 128 * row
                                + nbytes(q, gsel, cand), 2 * gsel.numel() * 128 * D)}
            key = f"K2 {size} {str(dtype)[6:]} Q={n_q}"
            res[key] = r
            print(f"[{label}] {key}: {r}", flush=True)
            del corpus, cand
            torch.cuda.empty_cache()
    Path(out_path).write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    if len(sys.argv) in (5, 6) and sys.argv[1] == "time":
        time_tree(sys.argv[2], sys.argv[3], sys.argv[4],
                  (sys.argv[5],) if len(sys.argv) == 6 else ("k9", "k2"))
    elif len(sys.argv) == 3 and sys.argv[1] == "segments":
        time_segments(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "variant":
        make_variant(sys.argv[2], sys.argv[3])
    else:
        sys.exit(__doc__)

"""Build and load the port's CUDA kernels.

The sources under ``kirag_tpu_torch/csrc`` are compiled with ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` process per ``.cu`` file, all started
together, and linked into one shared library with a plain C interface, which
is loaded through ``ctypes``. Nothing is built at import time: the first
launch builds the library into ``kirag_tpu_torch/kernels/build/`` (listed in
``.gitignore``), named by a hash of the sources and flags, so an edit to any
source rebuilds and an unchanged tree reuses the file.

The host C++ under ``kirag_tpu_torch/csrc/host`` (the DPR TSV parser and
the CPU flat index) is built the same way by :func:`build_host`, one
``g++`` shared library a source, into the same directory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
HOST_DIR = CSRC_DIR / "host"
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp", "-std=c++17")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # wall time of the nvcc runs; 0.0 when the library already existed
    log: str        # nvcc's messages (ptxas registers, shared memory, spills)


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit (set CUDA_HOME)")
    return found


def _cu_sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libkirag_kernels_{digest.hexdigest()[:16]}.so"


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> BuildInfo:
    """Compile the library unless a build of these exact sources exists."""
    out = library_path()
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _cu_sources()]
    tmp = BUILD_DIR / f"{tag}.tmp"
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=len(objects)) as pool:
            logs = list(pool.map(
                _run, [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                       for src, obj in zip(_cu_sources(), objects)]))
        logs.append(_run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)]))
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    return BuildInfo(out, time.perf_counter() - t0, "".join(logs))


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: ``-march=native`` builds for them, so a
    library built on another CPU is not reused."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def host_library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    digest.update((HOST_DIR / f"{name}.cpp").read_bytes())
    digest.update(_cpu_flags())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _host_compilers() -> list:
    """The C++ compilers to try, in order: ``$CXX``, then g++ on the PATH (a
    ``$CXX`` may lack OpenMP's runtime, which ``-fopenmp`` needs)."""
    return list(dict.fromkeys(c for c in (os.environ.get("CXX"), shutil.which("g++")) if c))


def build_host(name: str) -> BuildInfo:
    """Compile ``csrc/host/<name>.cpp`` with HOST_FLAGS by the first of
    :func:`_host_compilers` that builds it, unless a build of that exact
    source exists; raises with every compiler's messages when none does."""
    src = HOST_DIR / f"{name}.cpp"
    if not src.exists():
        raise FileNotFoundError(f"host source missing: {src}")
    out = host_library_path(name)
    if out.exists():
        return BuildInfo(out, 0.0, "")
    compilers = _host_compilers()
    if not compilers:
        raise RuntimeError("g++ not found: the host libraries are built with a C++ compiler "
                           "(set CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    errors = []
    try:
        for cxx in compilers:
            try:
                log = _run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)])
            except (RuntimeError, OSError) as e:  # refused the flags, or not runnable
                errors.append(f"{cxx}: {e}")
                continue
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
            return BuildInfo(out, time.perf_counter() - t0, f"{cxx}\n{log}")
    finally:
        tmp.unlink(missing_ok=True)
    raise RuntimeError("no C++ compiler built " + src.name + ":\n" + "\n".join(errors))


_host_libs: dict = {}


def load_host_library(name: str) -> ctypes.CDLL:
    """The host library ``name``, built on first use (once per process)."""
    with _lock:
        if name not in _host_libs:
            _host_libs[name] = ctypes.CDLL(str(build_host(name).path))
    return _host_libs[name]


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kirag_stream_capture.argtypes = [
        ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr,  # q, corpus, kind, scales, 5 outputs
        ptr, ptr,                                     # scratch, its group ids
        i32, i32, i32, i32, i32, i64,                 # n_q .. valid_rows
        i32, i32, i32, i32, i32, ptr]                 # q_tile, splits, gpb, slots, smem, stream
    lib.kirag_stream_capture.restype = i32
    lib.kirag_gather_groups.argtypes = [
        ptr, ptr, i32, ptr, ptr, ptr, i32, i32, i32, i64, ptr]
    lib.kirag_gather_groups.restype = i32
    lib.kirag_score_gmax.argtypes = [
        ptr, ptr, i32, ptr, ptr, ptr,      # q, corpus, kind, scales, scores (or null), gmax
        i32, i32, i32, i32, i64, i64, i64,  # n_q, d, num_chunks, chunk_size, valid, strides
        i32, i32, i32, i32, ptr]           # q_tile, splits, gpb, smem, stream
    lib.kirag_score_gmax.restype = i32
    for name in ("kirag_score_gather", "kirag_cap_assemble"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i32, i64, i64, ptr,  # src, idx, its bytes and strides, out
                       i32, i32, i32, i32,            # C, Q, k, per
                       i32, i32, ptr]                 # warps a block, blocks, stream
        fn.restype = i32
    lib.kirag_window_merge.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # gids, capmax, resid, capture, 4 outputs
        i32, i32, i32, i32, i32,                 # n_c, bc, n_q, br, total_groups
        i32, ptr, ptr]                           # segments, paths (or null), stream
    lib.kirag_window_merge.restype = i32
    lib.kirag_group_max.argtypes = [
        ptr, ptr, i32, ptr, ptr, ptr,  # q, corpus, kind, scales, gmax, gidx
        i32, i32, i64, i32,            # n_q, d, n_rows, winners
        i32, i32, i32, i32, ptr]       # q_tile, splits, gpb, smem, stream
    lib.kirag_group_max.restype = i32
    lib.kirag_score_probe.argtypes = [
        ptr, i32, ptr, ptr, ptr,  # codes, kind, scales, queries, out
        i32, i32, ptr]            # tiles, d, stream
    lib.kirag_score_probe.restype = i32
    lib.kirag_flash_attention.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,             # q, k, v, seg, out, lse (or null)
        i32, i32, i32, i32,                       # bf16, b, h, t
        ctypes.c_float, ctypes.POINTER(i64), ptr]  # sm_scale, strides[12], stream
    lib.kirag_flash_attention.restype = i32
    lib.kirag_flash_attention_bwd_dkv.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # q, k, v, seg, lse, di, dout, dk, dv
        i32, i32, i32, i32,                           # bf16, b, h, t
        ctypes.c_float, ctypes.POINTER(i64), ptr]     # sm_scale, strides[21], stream
    lib.kirag_flash_attention_bwd_dkv.restype = i32
    lib.kirag_flash_attention_bwd_dq.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,       # q, k, v, seg, lse, di, dout, dq
        i32, i32, i32, i32,
        ctypes.c_float, ctypes.POINTER(i64), ptr]
    lib.kirag_flash_attention_bwd_dq.restype = i32
    lib.kirag_int4_matmul.argtypes = [
        ptr, i32, ptr, ptr, ptr, ptr,   # x, bf16, packed, scales, codebook, out
        i32, i32, i32,                  # rows, half, out_dim
        i32, i32, i32, i32, i32, ptr]   # tiles, row_blocks, col_blocks, cluster, steps, stream
    lib.kirag_int4_matmul.restype = i32
    lib.kirag_error_string.argtypes = [i32]
    lib.kirag_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            _declare(lib)
            _lib = lib
    return _lib

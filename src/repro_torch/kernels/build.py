"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Each ``.cu`` source has a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds.  All sources compile in parallel, one
``nvcc`` each, and link into one shared library that ``ctypes`` loads.
The library lands in ``build/repro_torch/`` at the repository root
(git-ignored), named by a hash of the sources and flags, so an unchanged
tree reuses it.  Nothing builds at import time: the first CUDA launch, or
an explicit :func:`build`, does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis import locks
from repro_torch.errors import KernelError

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: C entry points of the library: (argument types, return type).  Every
#: pointer, the stream included, is a ``c_void_p``: a bare Python int
#: would be passed as a 32-bit int and cut.  The launchers return the
#: CUDA error code of the launch (0 on success).
SIGNATURES = {
    # issue, meta, boundary, timing, records, S, S_pad, C, K, R,
    # banks_per_rank, M (the cases), shared (one program for every case)
    # and stream
    "repro_dram_serve_prepass_batch": ([_P] * 5 + [_L, _L] + [_I] * 6
                                       + [_P], _I),
    # records, timing, 6 carry inputs, finish, 6 carry outputs, S, S_pad,
    # T, C, K, B, R, M and stream
    "repro_dram_serve_batch": ([_P] * 15 + [_L, _L] + [_I] * 6 + [_P], _I),
    # issue, bank, row, valid, timing, 7 carry inputs, finish, kind,
    # 7 carry outputs, C, L, B, R, banks_per_rank, stream
    "repro_dram_timing": ([_P] * 21 + [_I, _L, _I, _I, _I, _P], _I),
    # the same, then the chunk length T, the carry scan's group length G
    # and float[7] launch times (or null)
    "repro_dram_timing_chunks": ([_P] * 21 + [_I, _L, _I, _I, _I, _I, _I,
                                              _P, _P], _I),
    # C, L, R -> the chunk length repro_dram_timing takes
    "repro_dram_timing_chunk_len": ([_I, _L, _I], _I),
    # as repro_dram_timing
    "repro_dram_timing_serial": ([_P] * 21 + [_I, _L, _I, _I, _I, _P], _I),
    # values, src, dst, m, add, stream
    "repro_sweep_min": ([_P, _P, _P, _L, _I, _P], _I),
    # values, x0, cols, slice_ptr, slice_rows, n_slices, chunk_ptr,
    # chunk_rows, n_chunks, n, add, max_rounds, status, stream
    "repro_sweep_min_rounds": ([_P] * 5 + [_L, _P, _P, _L, _I, _I, _I, _P,
                                           _P], _I),
    # ids, values, out, scratch, m, d, num_segments, op, bf16, stream
    "repro_segment_reduce": ([_P] * 4 + [_L, _I, _I, _I, _I, _P], _I),
    # src, w, values, active, upd, valid, m, q, op, stream
    "repro_edge_scatter": ([_P] * 6 + [_L, _I, _I, _P], _I),
    # cols, vals, x, y, slice_ptr, slice_rows, n_slices, chunk_ptr,
    # chunk_rows, n_chunks, ny, k, nx, stream
    "repro_spmv_ell": ([_P] * 6 + [_L, _P, _P, _I, _L, _I, _I, _P], _I),
    # seg_ptr, tag, pos, tags, age, hit, U, W, stream
    "repro_cache_lookup": ([_P] * 6 + [_I, _I, _P], _I),
    "repro_cache_lookup_max_ways": ([], _I),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
}

#: the first caller builds and loads the library; the rest wait on it
_lock = locks.make_lock("kernel-library")
_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh", ".h"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile every source (in parallel) and link the shared library;
    returns its path.  A library already built from the same sources is
    reused."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    failed = []
    for src, _obj, proc in procs:
        out, err = proc.communicate()
        if verbose and (out or err):
            print(f"[nvcc {src.name}]\n{out}{err}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{err}")
    if failed:
        raise KernelError("nvcc failed:\n" + "\n".join(failed))
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    objs = [str(obj) for _src, obj, _p in procs]
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                           str(tmp)], capture_output=True, text=True)
    for obj in objs:
        os.unlink(obj)
    if link.returncode != 0:
        raise KernelError(f"nvcc link failed:\n{link.stderr}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with every entry
    point's argument and return types declared.  A library that does not
    load raises :class:`KernelError` (not the ``OSError`` of ``ctypes``,
    which a retry policy would take for an I/O blip)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelError(
                    f"the kernel library {path} did not load: {e}") from e
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check_launch(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error: a refused launch never
    runs, and a later synchronize would not report it."""
    if code != 0:
        msg = library().repro_cuda_error_string(code).decode()
        raise KernelError(f"{what} launch failed: CUDA error {code} "
                           f"({msg})")

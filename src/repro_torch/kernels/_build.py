"""Build and load the CUDA kernels: ``nvcc`` into a shared library, ctypes.

The library is compiled at first use from the ``csrc/*.cu`` sources for
``sm_90a`` (a plain C interface, no PyTorch headers: seconds, not minutes)
into ``kernels/build/`` beside this file — a directory git ignores — under a
name keyed by a hash of the sources, headers and flags, so an edited source
builds anew and an unchanged one is reused.  Each source compiles in its own
``nvcc`` process, all started together, and one more links the objects.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "bsr_kernels.cu", CSRC / "bsr_row_tiled.cu",
           CSRC / "bsr_row_tiled_gated.cu", CSRC / "bsr_matmul.cu",
           CSRC / "moe_ffn.cu", CSRC / "adamw.cu")
HEADERS = (CSRC / "common.cuh", CSRC / "row_tile.cuh", CSRC / "split_k.cuh")
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",              # registers, shared memory, spills
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ROW_TILED = ([_I] * 2 + [_P] * 14 + [_I] * 8
              + [ctypes.c_uint, ctypes.POINTER(_I), _P, ctypes.POINTER(_I)])
_SIGNATURES = {
    # x_dtype, w_dtype, x, blocks, rows, cols, run_ptr, step_run, part_off,
    # bias, scales, partial, arrivals, out, B, n_in, n_out, bm, bn, n_steps,
    # k_slice, n_slices, vec, act, stream
    "bsr_matmul_launch": [_I, _I] + [_P] * 12 + [_I] * 10 + [_P],
    # x_dtype, w_dtype, vec, x, blocks, rows, cols, run_ptr, step_run,
    # part_off, bias_idx, bias_tiles, scales, occ0, slots, occ, hidden,
    # partial, arrivals, out, B, n_in, n_out, bs, n_layers, hidden_tiles,
    # k_slice, n_slices, max_layer_steps, act, final_act, epoch, seg (host
    # int[n_layers + 1]), stream, grid (int*, out)
    "bsr_megakernel_launch": [_I] * 3 + [_P] * 17 + [_I] * 11
                             + [ctypes.c_uint, ctypes.POINTER(_I), _P,
                                ctypes.POINTER(_I)],
    # both: x_dtype, w_dtype, x, blocks, rows, cols, run_ptr, run_order,
    # bias_idx, bias_tiles, scales, occ0, slots, occ, hidden, out, B, n_in,
    # n_out, bs, n_layers, hidden_tiles, act, final_act, epoch, run_seg
    # (host int[n_layers + 1]), stream, grid (int*, out)
    "bsr_megakernel_row_tiled_launch": _ROW_TILED,
    "bsr_megakernel_row_tiled_gated_launch": _ROW_TILED,
    # dtype, x, w_up, w_down, out, scratch, E, C, d, f, rows, stages,
    # f_chunk, route, act, stream
    "moe_ffn_launch": [_I] + [_P] * 5 + [_I] * 9 + [_P],
    # leaves (device table), n_leaves, n_chunks, scale, lr, bc1, bc2, b1,
    # 1 - b1, b2, 1 - b2, eps, weight_decay, stream
    "adamw_launch": [_P, _I, ctypes.c_longlong] + [_P] * 4
                    + [ctypes.c_float] * 6 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built with the CUDA toolkit's nvcc")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"bsr_kernels_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, float, str]:
    """Compile the library unless it is built already.

    Returns ``(path, seconds, compiler output)``; seconds and output are 0
    and empty when an existing build was reused.  Raises with nvcc's output
    when the build fails.
    """
    so = library_path()
    if so.exists():
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(SOURCES, objs))]
    logs = []
    failed = None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is None:
        tmp = so.with_name(f"{tag}.tmp.so")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs.append(proc.stdout)
        if proc.returncode:
            failed = (cmd, proc.returncode, proc.stdout)
        else:
            os.replace(tmp, so)   # atomic: a concurrent build sees all or nothing
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed with exit code {rc}:\n"
                           f"{' '.join(cmd)}\n{out}")
    return so, time.perf_counter() - t0, "".join(logs)


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use, once per process)."""
    global _lib
    if _lib is None:
        so, _, _ = build()
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib

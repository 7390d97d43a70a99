"""Build and load the CUDA kernels: ``nvcc`` into a shared library, ctypes.

The library is compiled at first use from ``csrc/bsr_kernels.cu`` for
``sm_90a`` (a plain C interface, no PyTorch headers: seconds, not minutes)
into ``kernels/build/`` beside this file — a directory git ignores — under a
name keyed by a hash of the sources and flags, so an edited source builds
anew and an unchanged one is reused.  Nothing here runs at import time.
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

SOURCES = (Path(__file__).resolve().parent / "csrc" / "bsr_kernels.cu",)
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",              # registers, shared memory, spills
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x_dtype, w_dtype, x, blocks, rows, cols, run_ptr, bias, scales, out,
    # B, n_in, n_out, bm, bn, n_runs, act, stream
    "bsr_matmul_launch": [_I, _I] + [_P] * 8 + [_I] * 7 + [_P],
    # x_dtype, w_dtype, x, blocks, rows, cols, run_ptr, layer_runs,
    # bias_idx, bias_tiles, scales, hidden, out, B, n_in, n_out, bs,
    # n_layers, hidden_tiles, max_layer_runs, act, final_act, stream
    "bsr_megakernel_launch": [_I, _I] + [_P] * 11 + [_I] * 9 + [_P],
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
    for src in SOURCES:
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
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)   # atomic: a concurrent build sees all or nothing
    return so, seconds, proc.stdout + proc.stderr


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

"""Build and load the hand-written CUDA kernels (csrc/row_ops.cu).

The source is compiled with nvcc for Hopper (``sm_90a``) into a shared
library with a plain C interface, once per source content: the library's
name carries a hash of the source and the flags, and lives in
``cdlrm_tpu_torch/csrc/build/`` (listed in .gitignore). It is loaded with
ctypes; pointers and the stream pass as ``c_void_p``, sizes as ``c_int64``,
a scale as ``c_float``.
Nothing here runs at import time: the first kernel launch builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "row_ops.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "csrc", "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels of cdlrm_tpu_torch are built from source"
    )


def build() -> str:
    """Compile csrc/row_ops.cu if no library of this source and these flags
    exists yet; returns the library's path."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(_BUILD_DIR, f"librow_ops_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # per-process temporary name: concurrent builds (the CLI in a child
    # process) must not tear each other's output
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.cdlrm_gather_rows.argtypes = [_P, _P, _P, _I64, _I64, _P]
            lib.cdlrm_gather_rows.restype = ctypes.c_int
            lib.cdlrm_scatter_set_rows.argtypes = [_P, _P, _P, _P, _I64, _I64, _P]
            lib.cdlrm_scatter_set_rows.restype = ctypes.c_int
            lib.cdlrm_scatter_add_rows.argtypes = [_P, _P, _P, _P, _I64, _I64, _P]
            lib.cdlrm_scatter_add_rows.restype = ctypes.c_int
            lib.cdlrm_index_add_rows.argtypes = [_P, _P, _P, _I64, _I64, ctypes.c_float, _P]
            lib.cdlrm_index_add_rows.restype = ctypes.c_int
            lib.cdlrm_cuda_error_string.argtypes = [ctypes.c_int]
            lib.cdlrm_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check_operands(kernel: str, tensors: dict, dtypes: dict) -> None:
    """The kernels take contiguous tensors of one CUDA device with fixed
    dtypes: raise on anything else (no silent fallback)."""
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {dev}")
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{kernel}: {key} on {t.device}, expected {dev}")
        if t.dtype != dtypes[key]:
            raise TypeError(f"{kernel}: {key} must be {dtypes[key]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {key} must be contiguous")


def check(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.cdlrm_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")

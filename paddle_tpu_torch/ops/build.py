"""Builds the port's CUDA sources (``paddle_tpu_torch/csrc/*.cu``) into
shared libraries with a plain C interface and loads them with ctypes; and
the helpers every kernel wrapper shares (``bind``, ``cuda_device``,
``check_tensors``, ``raise_on``).

Each source compiles with ``nvcc`` for ``sm_90a`` at its first use, into
``build/paddle_tpu_torch/`` under the checkout (listed in ``.gitignore``).
A library's file name carries a hash of its source and flags, so an edit
rebuilds and a second process of the same checkout reuses the first one's
build. ``build_all`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: on PATH, else under $CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "paddle_tpu_torch build on a machine with the CUDA "
                       "toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build_all(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source that has no current build, one nvcc per
    source, all started together. Returns {name: seconds}; the compiler's
    resource report (``-Xptxas -v``) goes to ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    secs = {}
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (see {out.with_suffix('.log')})")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}")
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def bind(name: str, entry: str, n_ptr: int, n_int: int):
    """The C function ``entry`` of ``csrc/<name>.cu`` taking ``n_ptr``
    pointers, ``n_int`` ints and the stream, returning an int error."""
    fn = getattr(load(name), entry)
    # every pointer as c_void_p: an undeclared argument would pass as a
    # 32-bit int and cut the pointer
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cuda_device(kernel: str, t: torch.Tensor) -> torch.device:
    if not t.is_cuda:
        raise ValueError(f"{kernel}: no kernel for device {t.device}")
    return t.device


def check_tensors(kernel: str, device, **tensors):
    """Every tensor a contiguous float32 CUDA tensor on ``device`` with the
    given shape (``name=(tensor, shape)``)."""
    for name, (t, shape) in tensors.items():
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous float32 "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                             f"{device}")


def raise_on(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA "
                           f"error {err}")

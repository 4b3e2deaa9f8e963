"""Builds the port's CUDA sources (``paddle_tpu_torch/csrc/*.cu``) into
shared libraries with a plain C interface and loads them with ctypes; and
the helpers every kernel wrapper shares (``bind``, ``cuda_device``,
``check_tensors``, ``check_weight``, ``raise_on``), those of the
recurrent-step cells, which launch once per step from a Python loop
(``check_cell``: every check in one pass; ``call``: the current stream,
with a device guard only off the current device), and those of the
persistent (cooperative) kernels (``device_sms``, ``raise_coop``,
``aligned``).

Each source compiles with ``nvcc`` for ``sm_90a`` at its first use, into
``build/paddle_tpu_torch/`` under the checkout (listed in ``.gitignore``).
A library's file name carries a hash of its source, the headers it
includes and the flags, so an edit rebuilds and a second process of the
same checkout reuses the first one's build. ``build_all`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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


def _sources(name: str) -> bytes:
    """``csrc/<name>.cu`` and the headers of ``csrc`` it includes."""
    src = (CSRC / f"{name}.cu").read_bytes()
    heads = re.findall(rb'^#include "([^"]+)"', src, flags=re.M)
    return src + b"".join((CSRC / h.decode()).read_bytes() for h in heads)


def library_path(name: str) -> Path:
    """The build of ``csrc/<name>.cu``: its file name carries a hash of the
    source, the headers it includes and the flags."""
    key = hashlib.sha1(_sources(name) + " ".join(NVCC_FLAGS).encode()
                       ).hexdigest()[:12]
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
def bind(name: str, entry: str, n_ptr: int, n_int: int, n_float: int = 0):
    """The C function ``entry`` of ``csrc/<name>.cu`` taking ``n_ptr``
    pointers, ``n_int`` ints, ``n_float`` floats and the stream, returning
    an int error."""
    fn = getattr(load(name), entry)
    # every pointer as c_void_p: an undeclared argument would pass as a
    # 32-bit int and cut the pointer
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_float] * n_float + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def count_launch(fn, t: torch.Tensor, steps: int = None):
    """One call of the wrapper ``fn`` that launched its kernel in the
    form of ``t``'s dtype: a bf16 form's in ``fn.bf16_launches``, the
    float32 form's in ``fn.launches`` with its ``steps`` device launches
    (where the wrapper counts them) in ``fn.step_launches``."""
    if t.dtype == torch.bfloat16:
        fn.bf16_launches += 1
    else:
        fn.launches += 1
        if steps is not None:
            fn.step_launches += steps


def cuda_device(kernel: str, t: torch.Tensor) -> torch.device:
    if not t.is_cuda:
        raise ValueError(f"{kernel}: no kernel for device {t.device}")
    return t.device


def check_tensors(kernel: str, device, **tensors):
    """Every tensor a contiguous CUDA tensor on ``device`` with the given
    shape and dtype (``name=(tensor, shape)`` for float32, ``name=(tensor,
    shape, dtype)`` otherwise)."""
    for name, (t, shape, *dt) in tensors.items():
        dtype = dt[0] if dt else torch.float32
        if t.dtype != dtype or not t.is_cuda or not t.is_contiguous():
            dname = str(dtype).replace("torch.", "")
            raise ValueError(f"{kernel}: {name} must be a contiguous {dname} "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                             f"{device}")


def check_cell(kernel, tensors, weights=()):
    """The checks of ``check_tensors`` and ``check_weight`` in one pass,
    for a wrapper called once per step: ``tensors`` are (name, tensor,
    shape) that must be contiguous float32 on one card, or (name, tensor,
    shape, dtype) of another dtype, ``weights`` (name, matrix, shape)
    float32 matrices on that card with contiguous columns. Returns (the
    card's index, the weights' row strides). Where any check fails, those
    functions raise with their message."""
    idx = tensors[0][1].get_device()  # -1 on the CPU
    f32 = torch.float32
    ok = idx >= 0
    for _, t, shape, *dt in tensors:
        ok = (ok and t.dtype is (dt[0] if dt else f32)
              and t.get_device() == idx
              and t.shape == shape and t.is_contiguous())
    lds = []
    for _, w, shape in weights:
        st = w.stride()
        ok = (ok and w.dtype is f32 and w.get_device() == idx
              and w.shape == shape and st[1] == 1 and st[0] >= shape[1])
        lds.append(st[0])
    if not ok:
        dev = cuda_device(kernel, tensors[0][1])
        check_tensors(kernel, dev,
                      **{n: (t, s, *dt) for n, t, s, *dt in tensors})
        for name, w, shape in weights:
            check_weight(kernel, dev, name, w, shape)
    return idx, lds


def call(fn, idx, *args):
    """``fn(*args, stream)``: a bound C entry on the current (PyTorch's)
    stream of card ``idx``, under a device guard only where ``idx`` is not
    the current device. Nothing is cached: the stream is read at each
    call."""
    if idx == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def raise_on(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA "
                           f"error {err}")


# shared memory a block may opt into on Hopper (csrc/persistent.cuh:
# kSmemLimit) and the H100's SMs
SMEM_BYTES = 232448
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def _sms_of(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_sms(t) -> int:
    """SMs of the card ``t`` lies on; H100_SMS for a CPU tensor, whose
    plain versions follow the route the H100 would take."""
    return _sms_of(t.device.index if t.device.index is not None
                   else torch.cuda.current_device()) if t.is_cuda \
        else H100_SMS


_COOP_ERRORS = {
    -1: "the block's shared memory exceeds the card's opt-in limit",
    -2: "the cooperative grid does not fit on the card at once "
        "(cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs < blocks)",
    -3: "the device does not support cooperative launches",
    -4: "the kernel does not take this plan (H % 4, tiles or chunk)",
}


def raise_coop(err, kernel, plan):
    """Raises for a persistent launch's error code (csrc/persistent.cuh:
    launch_cooperative), naming the reason and the plan."""
    if err in _COOP_ERRORS:
        raise RuntimeError(f"{kernel}: persistent launch refused: "
                           f"{_COOP_ERRORS[err]} (plan {plan})")
    raise_on(err, kernel)


def aligned(t):
    """``t``, or a copy of it on a 16-byte boundary (the persistent
    kernels stage it with 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_weight(kernel, device, name, w, shape, dtype=torch.float32):
    """A CUDA matrix of ``dtype`` on ``device`` of ``shape`` whose columns
    are contiguous (a column slice of a wider matrix is fine: the kernels
    take its row stride). Returns that row stride."""
    if w.dtype != dtype or not w.is_cuda:
        dname = str(dtype).replace("torch.", "")
        raise ValueError(f"{kernel}: {name} must be a {dname} CUDA tensor, "
                         f"got {w.dtype} on {w.device}")
    if tuple(w.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(w.shape)}, "
                         f"expected {tuple(shape)}")
    if w.device != device:
        raise ValueError(f"{kernel}: {name} is on {w.device}, expected "
                         f"{device}")
    if w.stride(1) != 1 or w.stride(0) < w.shape[1]:
        raise ValueError(f"{kernel}: {name} must have contiguous columns "
                         f"(strides {tuple(w.stride())}); a column slice of "
                         "a row-major matrix is fine, a transpose is not")
    return w.stride(0)

"""Checkpoint save/load: the port of ``paddle_tpu/trainer/checkpoint.py``,
in the same on-disk format, so files cross between the packages in both
directions.

One ``.npz`` holds ``param::<name>`` for every parameter and
``opt::slots/<name>/<slot>``, ``opt::t`` (int32) and
``opt::num_samples`` (float32) for the optimizer state (``opt::avg/<name>``
under model averaging), with a ``.meta`` JSON sidecar carrying the MD5 of
the ``.npz`` bytes. Writes are atomic (temporary file, fsync, rename).

A save directory holds one generation per pass end, named as the JAX
package's ``Checkpointer`` names them
(``checkpoint-p{pass:05d}-b{batch:08d}.npz``, ``paddle_tpu/dist/
checkpoint.py:61,112``), with its ``LATEST`` pointer, and the newest
three kept, so either package restores the other's directory. The
background writer and auto-resume of that ``Checkpointer`` are not
ported.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_GEN_RE = re.compile(r"^checkpoint-p(\d+)-b(\d+)\.npz$")
_KEEP = 3  # generations a save directory keeps (the JAX Checkpointer's)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, bool):
        return np.asarray(v)
    if isinstance(v, int):
        return np.asarray(v, dtype=np.int32)
    if isinstance(v, float):
        return np.asarray(v, dtype=np.float32)
    return np.asarray(v)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
        return flat
    return {prefix.rstrip("/"): _host(tree)}


def snapshot_arrays(params, opt_state=None) -> Dict[str, np.ndarray]:
    """Every parameter and optimizer-state entry as host numpy, under its
    ``param::`` / ``opt::`` key."""
    arrays = {f"param::{k}": _host(v) for k, v in params.items()}
    if opt_state is not None:
        arrays.update({f"opt::{k}": v
                       for k, v in _flatten(opt_state).items()})
    return arrays


def write_snapshot(path: str, arrays: Dict[str, np.ndarray],
                   meta: Optional[dict] = None) -> str:
    """Write ``arrays`` to ``path`` (``.npz`` appended when missing) and its
    ``.meta`` sidecar, each atomically; returns the ``.npz`` path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    real_path = path if path.endswith(".npz") else path + ".npz"
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    data = buf.getvalue()
    _write_atomic(real_path, data)
    sidecar = json.dumps({"md5": hashlib.md5(data).hexdigest(),
                          **(meta or {})}).encode()
    _write_atomic(real_path + ".meta", sidecar)
    return real_path


def _write_atomic(path: str, data: bytes):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_params(path: str, params: Dict[str, Any],
                opt_state: Optional[Any] = None,
                meta: Optional[dict] = None) -> str:
    return write_snapshot(path, snapshot_arrays(params, opt_state), meta)


def load_checkpoint(path: str, check_integrity: bool = True
                    ) -> Tuple[dict, dict, dict]:
    """(params, opt_flat, trainer_state) as numpy from one checkpoint file;
    raises IOError when the bytes fail the sidecar's MD5. Trainer state
    (the JAX package's ``state::`` arrays, e.g. its RNG key) is returned
    but not used by the port; pickled ``stateobj::`` entries come back as
    their raw bytes, never unpickled."""
    real_path = path if path.endswith(".npz") else path + ".npz"
    with open(real_path, "rb") as f:
        raw = f.read()
    if check_integrity and os.path.exists(real_path + ".meta"):
        with open(real_path + ".meta") as f:
            meta = json.load(f)
        if hashlib.md5(raw).hexdigest() != meta.get("md5"):
            raise IOError(f"checkpoint {real_path} failed MD5 integrity "
                          "check")
    params, opt_flat, state = {}, {}, {}
    with np.load(io.BytesIO(raw)) as data:
        for k in data.files:
            ns, _, name = k.partition("::")
            target = {"param": params, "opt": opt_flat, "state": state,
                      "stateobj": state}.get(ns)
            if target is not None:
                target[name] = data[k]
    return params, opt_flat, state


def load_params(path: str, check_integrity: bool = True):
    params, opt_flat, _ = load_checkpoint(path, check_integrity)
    return params, opt_flat


def generation_path(save_dir: str, pass_id: int, batch_id: int = 0) -> str:
    """The JAX ``Checkpointer``'s file name of one generation."""
    return os.path.join(save_dir,
                        f"checkpoint-p{pass_id:05d}-b{batch_id:08d}.npz")


def _generations(save_dir: str):
    """Generation file names of ``save_dir``, newest first: by pass, an
    end-of-pass save (batch 0) newest of its pass, then by batch."""
    def key(name):
        m = _GEN_RE.match(name)
        pass_id, batch_id = int(m.group(1)), int(m.group(2))
        return pass_id, batch_id == 0, batch_id

    if not os.path.isdir(save_dir):
        return []
    return sorted((n for n in os.listdir(save_dir) if _GEN_RE.match(n)),
                  key=key, reverse=True)


def save_generation(save_dir: str, pass_id: int, params, opt_state) -> str:
    """The end-of-pass save: the generation file, its sidecar (with the
    pass/batch metadata the JAX ``Checkpointer`` reads) and the ``LATEST``
    pointer, written after the data is durable; then all but the newest
    three generations are deleted, as the JAX ``Checkpointer`` does."""
    path = write_snapshot(
        generation_path(save_dir, pass_id),
        snapshot_arrays(params, opt_state),
        {"pass_id": pass_id, "batch_id": 0, "end_of_pass": True,
         "time": time.time()})
    _write_atomic(os.path.join(save_dir, "LATEST"),
                  os.path.basename(path)[:-len(".npz")].encode())
    for name in _generations(save_dir)[_KEEP:]:
        for suffix in ("", ".meta"):
            try:
                os.remove(os.path.join(save_dir, name + suffix))
            except FileNotFoundError:
                pass
    return path


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """The newest generation of ``save_dir`` that has its ``.meta``
    sidecar (the ``LATEST`` target first, then the newest generation), or
    None."""
    names = []
    try:
        with open(os.path.join(save_dir, "LATEST")) as f:
            names.append(f.read().strip() + ".npz")
    except FileNotFoundError:
        pass
    for name in names + _generations(save_dir):
        path = os.path.join(save_dir, name)
        if os.path.exists(path) and os.path.exists(path + ".meta"):
            return path
    return None

"""Checkpoint save/load: the port of ``paddle_tpu/trainer/checkpoint.py``,
in the same on-disk format, so files cross between the packages in both
directions.

One ``.npz`` holds ``param::<name>`` for every parameter and
``opt::slots/<name>/<slot>``, ``opt::t`` (int32) and
``opt::num_samples`` (float32) for the optimizer state (``opt::avg/<name>``
under model averaging), with a ``.meta`` JSON sidecar carrying the MD5 of
the ``.npz`` bytes. Writes are atomic (temporary file, fsync, rename).

Exact-resume state rides in a third namespace, ``state::<key>`` (the
JAX package's): the port's step generator as ``state::torch_rng`` and
the carried truncated-BPTT state as ``state::carried/<layer>[/<part>]``
arrays (a tuple's parts named ``#0``, ``#1``), so nothing is pickled.
The JAX package's own ``state::rng`` key and ``stateobj::`` pickles are
read back as they are and not used.

A save directory holds generations named as the JAX package's
``Checkpointer`` names them (``checkpoint-p{pass:05d}-b{batch:08d}.npz``,
``paddle_tpu/dist/checkpoint.py:61,112``) with its ``LATEST`` pointer,
so either package restores the other's directory. The cadence, the
background writer and the resume live in ``dist/checkpoint.py``.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch



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


def _flatten_state(tree: Any, prefix: str) -> Dict[str, np.ndarray]:
    """A nest of dicts, tuples and tensors as flat arrays: a dict's
    keys and a tuple's ``#i`` joined by ``/``."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (tuple, list)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    else:
        return {prefix: _host(tree)}
    flat = {}
    for k, v in items:
        flat.update(_flatten_state(v, f"{prefix}/{k}"))
    return flat


def unflatten_state(flat: Dict[str, Any]) -> Any:
    """The inverse of the ``state::`` flattening below one key: paths
    relative to it (``""`` for a leaf) -> the nest, tuples where every key
    of a level is ``#i``."""
    if "" in flat:
        return flat[""]
    heads: Dict[str, Dict[str, Any]] = {}
    for path, v in flat.items():
        head, _, rest = path.partition("/")
        heads.setdefault(head, {})[rest] = v
    if heads and all(h.startswith("#") for h in heads):
        return tuple(unflatten_state(heads[f"#{i}"])
                     for i in range(len(heads)))
    return {h: unflatten_state(sub) for h, sub in heads.items()}


def snapshot_arrays(params, opt_state=None, extra_state=None
                    ) -> Dict[str, np.ndarray]:
    """Every parameter, optimizer-state and extra-state entry as host
    numpy, under its ``param::`` / ``opt::`` / ``state::`` key: the
    synchronous half of a save (what remains is file I/O a background
    thread can own). Each argument may be a zero-argument callable that
    gives it."""
    if callable(params):
        params = params()
    if callable(opt_state):
        opt_state = opt_state()
    if callable(extra_state):
        extra_state = extra_state()
    arrays = {f"param::{k}": _host(v) for k, v in params.items()}
    if opt_state is not None:
        arrays.update({f"opt::{k}": v
                       for k, v in _flatten(opt_state).items()})
    for k, v in (extra_state or {}).items():
        if v is not None:
            arrays.update(_flatten_state(v, f"state::{k}"))
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


def load_checkpoint(path: str, check_integrity: bool = True,
                    meta: Optional[dict] = None
                    ) -> Tuple[dict, dict, dict]:
    """(params, opt_flat, state) as numpy from one checkpoint file;
    raises IOError when the bytes fail the sidecar's MD5 (``meta``: the
    sidecar already parsed). ``state`` maps the ``state::`` keys (flat,
    as written); pickled ``stateobj::`` entries of the JAX package come
    back as their raw bytes, never unpickled."""
    real_path = path if path.endswith(".npz") else path + ".npz"
    with open(real_path, "rb") as f:
        raw = f.read()
    if check_integrity and (meta is not None
                            or os.path.exists(real_path + ".meta")):
        if meta is None:
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


def save_generation(save_dir: str, pass_id: int, params, opt_state) -> str:
    """An end-of-pass save, as ``dist.checkpoint.Checkpointer`` writes it
    (the generation, its sidecar, the ``LATEST`` pointer, the newest three
    kept); returns the ``.npz`` path."""
    from paddle_tpu_torch.dist.checkpoint import Checkpointer
    return Checkpointer(save_dir).save(params, opt_state, pass_id=pass_id,
                                       end_of_pass=True) + ".npz"


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """The newest generation of ``save_dir`` that has its ``.meta``
    sidecar (the ``LATEST`` target first, then the newest generation), or
    None."""
    from paddle_tpu_torch.dist.checkpoint import candidates
    for name in candidates(save_dir):
        path = os.path.join(save_dir, name)
        if os.path.exists(path) and os.path.exists(path + ".meta"):
            return path
    return None

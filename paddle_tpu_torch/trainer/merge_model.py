"""Deploy-time model merging (`paddle/trainer/MergeModel.cpp`): the PTM1
format of ``paddle_tpu/trainer/merge_model.py``, read and written by the
port.

Format: ``b"PTM1" + md5(payload)[16 bytes] + pickle(payload)`` where
payload = {"graph": ModelDef, "params": {name: np.ndarray},
"outputs": [names]}, plus the optional ``"quant"`` and ``"golden"``
sections of a quantized merge (``paddle_tpu_torch/quant.py``), written
only when given, so an unquantized payload is the plain format.

A bf16 leaf the port writes is a ``uint16`` array of its bits, marked by
``"bf16_storage": "uint16"`` in the ``quant`` section, so the file needs
no ``ml_dtypes`` to load. A bf16 file the JAX package wrote pickles
``ml_dtypes.bfloat16`` arrays: it loads where ``ml_dtypes`` is
importable and raises :class:`Bfloat16Unavailable` where it is not.

A PTM1 file written by the JAX package pickles
``paddle_tpu.config.model_config.ModelDef``. Loading goes through an
unpickler that maps that module (and ``paddle_tpu.data.types``) onto the
port's copies and refuses every other ``paddle_tpu`` module, so loading
never imports the JAX package.

SECURITY: the MD5 gives integrity (torn-file detection), not
authenticity — the payload is a pickle, so only load model files from
trusted sources.
"""

from __future__ import annotations

import hashlib
import io
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

_MAGIC = b"PTM1"

# JAX-package modules whose pickled classes have a copy in the port
_MODULE_MAP = {
    "paddle_tpu.config.model_config": "paddle_tpu_torch.config.model_config",
    "paddle_tpu.data.types": "paddle_tpu_torch.data.types",
}


class Bfloat16Unavailable(IOError):
    """A merged model holds ``ml_dtypes.bfloat16`` arrays (a bf16 merge
    written by the JAX package) and ``ml_dtypes`` is not installed."""


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "ml_dtypes" or module.startswith("ml_dtypes."):
            try:
                return super().find_class(module, name)
            except ImportError as e:
                raise Bfloat16Unavailable(
                    f"merged model stores {module}.{name} arrays (a bf16 "
                    "merge written by the JAX package), and ml_dtypes is "
                    "not installed: install it, or re-merge with "
                    "paddle_tpu_torch, which stores bf16 leaves as uint16 "
                    "bits") from e
        if module in _MODULE_MAP:
            module = _MODULE_MAP[module]
        elif module == "paddle_tpu" or module.startswith("paddle_tpu."):
            raise pickle.UnpicklingError(
                f"merged model references {module}.{name}, which has no "
                "counterpart in paddle_tpu_torch; refusing to import the "
                "JAX package")
        return super().find_class(module, name)


def merge_model(path: str, graph, params: Dict[str, object],
                outputs: Optional[List[str]] = None,
                quant: Optional[Dict] = None,
                golden: Optional[Dict] = None):
    """Write a PTM1 file; tensors are stored as numpy arrays. ``quant``
    and ``golden`` (``quant.py:quantize_params`` and ``golden_section``)
    are written only when given."""
    data = {
        "graph": graph,
        "params": {k: (v.detach().cpu().numpy()
                       if isinstance(v, torch.Tensor) else np.asarray(v))
                   for k, v in params.items()},
        "outputs": list(outputs or graph.output_layer_names or []),
    }
    if quant is not None:
        data["quant"] = quant
    if golden is not None:
        data["golden"] = golden
    payload = pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)
    with open(path, "wb") as f:
        f.write(_MAGIC + hashlib.md5(payload).digest() + payload)


def merged_digest(path: str) -> str:
    """The PTM1 payload MD5 (hex) without unpickling the payload."""
    with open(path, "rb") as f:
        head = f.read(20)
    if head[:4] != _MAGIC:
        raise IOError(f"{path}: not a merged model (bad magic)")
    return head[4:20].hex()


def load_merged_ex(path: str):
    """-> (graph, params, output_names, extras); ``extras`` holds the
    optional sections of a quantized merge (``"quant"``, ``"golden"``),
    an empty dict for a plain f32 artifact. Raises on corruption."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != _MAGIC:
        raise IOError(f"{path}: not a merged model (bad magic)")
    digest, payload = raw[4:20], raw[20:]
    if hashlib.md5(payload).digest() != digest:
        raise IOError(f"{path}: merged model failed MD5 integrity check")
    data = _PortUnpickler(io.BytesIO(payload)).load()
    extras = {k: data[k] for k in ("quant", "golden") if k in data}
    return data["graph"], data["params"], data["outputs"], extras

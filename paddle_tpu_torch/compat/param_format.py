"""The reference's binary parameter-file format: the port's copy of
``paddle_tpu/compat/param_format.py``.

``Parameter::save/load`` (``paddle/parameter/Parameter.cpp:279-360``)
writes one file per parameter: a 16-byte header ``{int32 version=0,
uint32 valueSize=sizeof(real)=4, uint64 size}`` followed by the raw
float32 values. ``ParamUtil`` saves one such file per parameter, named
exactly like the parameter, into a pass directory: the model format of
``--init_model_path``, ``MergeModel`` and the model-zoo downloads. Files
cross between the two packages in both directions.
"""

from __future__ import annotations

import os
import struct
from typing import Dict

import numpy as np

_HEADER = struct.Struct("<iIQ")   # version, valueSize, size
_VERSION = 0


def load_v1_param(path: str) -> np.ndarray:
    """One parameter file -> flat float32 array (header-validated)."""
    with open(path, "rb") as f:
        raw = f.read(_HEADER.size)
        if len(raw) != _HEADER.size:
            raise IOError(f"{path}: truncated parameter header")
        version, value_size, size = _HEADER.unpack(raw)
        if version != _VERSION:
            raise IOError(f"{path}: unsupported format version {version}")
        if value_size != 4:
            raise IOError(
                f"{path}: valueSize {value_size} (only float32 supported)")
        data = np.frombuffer(f.read(size * 4), dtype="<f4")
        if data.size != size:
            raise IOError(f"{path}: expected {size} values, got {data.size}")
        return np.array(data)   # writable copy


def save_v1_param(path: str, value: np.ndarray):
    arr = np.ascontiguousarray(np.asarray(value, dtype="<f4").reshape(-1))
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_VERSION, 4, arr.size))
        f.write(arr.tobytes())


def load_v1_model_dir(model_dir: str) -> Dict[str, np.ndarray]:
    """A pass/model directory -> {parameter name: flat float32 array}:
    every regular file that parses as a v1 parameter (the reference names
    the files after the parameters)."""
    out: Dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(model_dir)):
        path = os.path.join(model_dir, name)
        if not os.path.isfile(path):
            continue
        try:
            out[name] = load_v1_param(path)
        except IOError:
            continue  # not a parameter file (a done-marker, a config)
    return out


def save_v1_model_dir(model_dir: str, params: Dict[str, np.ndarray]):
    os.makedirs(model_dir, exist_ok=True)
    for name, value in params.items():
        save_v1_param(os.path.join(model_dir, name), value)

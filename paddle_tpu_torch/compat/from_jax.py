"""Parameters carried across from the JAX package.

The port keeps the JAX package's parameter names and layouts (``fc``
weights [in, out], ``lstmemory`` w0 [H, 4H] and wbias [7H], embedding
tables [vocab, dim]), so a JAX parameter dict, as numpy, maps onto the
port's by name. PTM1 files carry the same names.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_numpy(np_params: Dict[str, object], device="cuda",
                      network=None) -> Dict[str, torch.Tensor]:
    """{name: array} -> {name: f32 tensor on ``device``}. With a
    ``network`` (``core/network.py:Network``), every parameter it needs
    must be present with its spec's shape."""
    if network is not None:
        missing = sorted(set(network.param_specs) - set(np_params))
        if missing:
            raise KeyError(f"parameters missing for this graph: {missing}")
        for name, spec in network.param_specs.items():
            shape = tuple(np.shape(np_params[name]))
            if shape != tuple(spec.shape):
                raise ValueError(f"parameter {name!r} has shape {shape}, "
                                 f"the graph needs {tuple(spec.shape)}")
    return {name: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for name, v in np_params.items()}

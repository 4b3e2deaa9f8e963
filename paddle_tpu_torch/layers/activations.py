"""Activation functions (``ActivationFunction.cpp``): the subset the ported
layers use — linear, tanh, sigmoid, relu, softmax."""

from __future__ import annotations

from typing import Callable, Dict

import torch

_ACTIVATIONS: Dict[str, Callable] = {
    "linear": lambda x: x,
    "": lambda x: x,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "relu": torch.relu,
    "tanh": torch.tanh,
}


def apply_activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name not in _ACTIVATIONS:
        raise KeyError(f"activation {name!r} is not ported yet; ported: "
                       f"{sorted(k for k in _ACTIVATIONS if k)}")
    return _ACTIVATIONS[name](x)

"""Activation functions (``ActivationFunction.cpp``): the reference's 16 —
linear, sigmoid, softmax, sequence_softmax, relu, brelu, tanh, stanh,
softrelu, abs, square, exponential, reciprocal, sqrt and log — with the
expressions of ``paddle_tpu/layers/activations.py``. Each takes the
layer's value and its sequence mask (None for non-sequence values)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

_NEG_INF = -1e30


def _sequence_softmax(x, mask):
    """Softmax across the *time* dimension of each sequence. Input is
    [B, T, 1] or [B, T]; padded steps are excluded via the mask and read
    0, as ``paddle_tpu/layers/activations.py:_sequence_softmax``."""
    if mask is None:
        raise ValueError("sequence_softmax requires sequence input")
    squeeze = x.dim() == 3
    v = x[..., 0] if squeeze else x
    v = torch.where(mask > 0, v, torch.full((), _NEG_INF, dtype=v.dtype,
                                            device=v.device))
    v = torch.softmax(v, dim=-1) * mask
    return v.unsqueeze(-1) if squeeze else v


_ACTIVATIONS: Dict[str, Callable] = {
    "linear": lambda x, m=None: x,
    "": lambda x, m=None: x,
    "sigmoid": lambda x, m=None: torch.sigmoid(x),
    "softmax": lambda x, m=None: torch.softmax(x, dim=-1),
    "sequence_softmax": _sequence_softmax,
    "relu": lambda x, m=None: torch.relu(x),
    "brelu": lambda x, m=None: torch.clamp(x, 0.0, 24.0),
    "tanh": lambda x, m=None: torch.tanh(x),
    "stanh": lambda x, m=None: 1.7159 * torch.tanh((2.0 / 3.0) * x),
    "softrelu": lambda x, m=None: torch.log1p(torch.exp(
        torch.clamp(x, -40.0, 40.0))),
    "abs": lambda x, m=None: torch.abs(x),
    "square": lambda x, m=None: torch.square(x),
    "exponential": lambda x, m=None: torch.exp(x),
    "reciprocal": lambda x, m=None: 1.0 / x,
    "sqrt": lambda x, m=None: torch.sqrt(x),
    "log": lambda x, m=None: torch.log(x),
}


def apply_activation(name: str, x: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if name not in _ACTIVATIONS:
        raise KeyError(f"unknown activation {name!r}")
    return _ACTIVATIONS[name](x, mask)


def activation_names():
    return sorted(k for k in _ACTIVATIONS if k)

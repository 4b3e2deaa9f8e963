"""Activation functions (``ActivationFunction.cpp``): the subset the ported
layers use — linear, tanh, sigmoid, relu, softmax and sequence_softmax.
Each takes the layer's value and its sequence mask (None for non-sequence
values), as ``paddle_tpu/layers/activations.py`` does."""

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
    "tanh": lambda x, m=None: torch.tanh(x),
}


def apply_activation(name: str, x: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if name not in _ACTIVATIONS:
        raise KeyError(f"activation {name!r} is not ported yet; ported: "
                       f"{sorted(k for k in _ACTIVATIONS if k)}")
    return _ACTIVATIONS[name](x, mask)

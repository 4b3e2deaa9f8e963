"""Argument: the inter-layer value type (``paddle/parameter/Argument.h``).

A sequence batch is padded and masked, as in ``paddle_tpu/core/argument.py``:
``value[B, T, D]`` (``[B, T]`` for ids) with an f32 ``mask[B, T]`` (1.0 =
real token). Non-sequence batches carry ``mask=None``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass
class Argument:
    """A batch flowing between layers.

    value: [B, ...] dense data; for sequence data [B, T, D] (or [B, T] ids).
    mask:  [B, T] float32 (1.0 = real token), None for non-sequence data.
    state: optional recurrent state, e.g. an LSTM's (hT, cT).
    """

    value: torch.Tensor
    mask: Optional[torch.Tensor] = None
    state: Any = None

    @property
    def is_sequence(self) -> bool:
        return self.mask is not None

    @property
    def batch_size(self) -> int:
        return self.value.shape[0]

    def with_value(self, value: torch.Tensor) -> "Argument":
        return dataclasses.replace(self, value=value)

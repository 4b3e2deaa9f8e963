"""Argument: the inter-layer value type (``paddle/parameter/Argument.h``).

A sequence batch is padded and masked, as in ``paddle_tpu/core/argument.py``:
``value[B, T, D]`` (``[B, T]`` for ids) with an f32 ``mask[B, T]`` (1.0 =
real token). Non-sequence batches carry ``mask=None``. A two-level (nested)
batch is ``value[B, S, T(, D)]`` with ``mask[B, S, T]``, or a flat
``[B, T, D]`` with ``sub_starts_mask[B, T]`` marking where each
sub-sequence begins.
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
    sub_starts_mask: [B, T] float32 marking the positions that begin a
        sub-sequence (nested sequences), None unless nested.
    state: optional recurrent state, e.g. an LSTM's (hT, cT).
    """

    value: torch.Tensor
    mask: Optional[torch.Tensor] = None
    sub_starts_mask: Optional[torch.Tensor] = None
    state: Any = None

    @property
    def is_sequence(self) -> bool:
        return self.mask is not None

    @property
    def batch_size(self) -> int:
        return self.value.shape[0]

    def with_value(self, value: torch.Tensor) -> "Argument":
        return dataclasses.replace(self, value=value)

    def to(self, device) -> "Argument":
        """The Argument with its value and masks on ``device`` (the state
        as it is)."""
        def move(t):
            return None if t is None else t.to(device)
        return dataclasses.replace(self, value=move(self.value),
                                   mask=move(self.mask),
                                   sub_starts_mask=move(self.sub_starts_mask))


def check_dead(count_live: torch.Tensor, what: str) -> None:
    """The guard of a padded-length alignment (JAX ``check_dead``): a
    length mismatch between padded inputs is benign only when every
    trimmed or zero-filled position is masked dead. ``count_live`` counts
    the live positions that would be dropped or made up; a host sync reads
    it and raises when it is not zero."""
    n = int(count_live.item())
    if n > 0:
        raise ValueError(
            f"{what}: {n} live (unmasked) positions would be "
            "silently dropped/zero-filled by padded-length alignment; "
            "the inputs are genuinely misaligned, not just padded")

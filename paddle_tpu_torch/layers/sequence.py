"""Sequence aggregation layers: masked reductions over the padded
``[B, T, D]`` layout (``MaxLayer.cpp`` in the reference). The port's
counterpart of ``paddle_tpu/layers/sequence.py:MaxLayer`` for flat
sequences."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import LayerImpl, ShapeInfo, register_layer

_NEG_INF = -1e30


@register_layer("max")
class MaxLayer(LayerImpl):
    """Max over time of each sequence. An all-padding row reads
    ``_NEG_INF``, as in the JAX package."""

    def infer(self, cfg, in_infos):
        if cfg.attrs.get("trans_type") == "seq":
            raise NotImplementedError(
                "max pooling of nested sequences is not ported yet")
        return ShapeInfo(size=in_infos[0].size, is_sequence=False)

    def apply(self, cfg, params, ins, ctx):
        a = ins[0]
        v = torch.where(a.mask.unsqueeze(-1) > 0, a.value,
                        torch.full((), _NEG_INF, dtype=a.value.dtype,
                                   device=a.value.device))
        return Argument(value=v.amax(dim=1))

"""Cost layers (``paddle/gserver/layers/CostLayer.cpp``), the port of
``paddle_tpu/layers/cost.py``'s ``multi-class-cross-entropy``.

A cost layer emits a per-sample cost ``[B, 1]``; for sequence inputs the
per-token cost is mask-summed over time first. The trainer averages over
the batch (``Argument::sum(outArgs)/batchSize`` in
``TrainerInternal.cpp``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import LayerImpl, ShapeInfo, register_layer

_EPS = 1e-10


def _reduce_tokens(cost, mask):
    """[B,T] token costs + mask -> [B,1]; [B] -> [B,1]."""
    if cost.dim() == 2 and mask is not None:
        cost = (cost * mask).sum(dim=1)
    return cost.reshape(-1, 1)


@register_layer("multi-class-cross-entropy")
class MultiClassCrossEntropy(LayerImpl):
    """-log p[label]; input 0 = probabilities (post-softmax), input 1 = int
    labels."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=1)

    def apply(self, cfg, params, ins, ctx):
        prob, label = ins[0], ins[1]
        lab = label.value.long()
        if (prob.mask is not None and label.mask is not None
                and lab.shape[1] != prob.value.shape[1]):
            # the feeder pads each slot on its own: trim or zero-pad the
            # label to the output's padded length (the masks carry truth)
            T = prob.value.shape[1]
            lab = (lab[:, :T] if lab.shape[1] > T
                   else F.pad(lab, (0, T - lab.shape[1])))
        p = torch.clamp(prob.value, _EPS, 1.0)
        ll = torch.gather(p, -1, lab.unsqueeze(-1))[..., 0]
        return Argument(value=_reduce_tokens(-torch.log(ll), prob.mask))

"""Cost layers (``paddle/gserver/layers/CostLayer.cpp``, ``LambdaCost.cpp``),
the port of ``paddle_tpu/layers/cost.py``: the cross-entropies, square
error, smooth L1, Huber, the ranking costs, the self-normalised softmax
cost, the sum cost and the Gaussian KL term.

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


class _CostBase(LayerImpl):
    def infer(self, cfg, in_infos):
        return ShapeInfo(size=1)


@register_layer("multi-class-cross-entropy")
class MultiClassCrossEntropy(_CostBase):
    """-log p[label]; input 0 = probabilities (post-softmax), input 1 = int
    labels."""

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


def _binary_xent(ins):
    """sum_j -(t log p + (1-t) log(1-p)) per row, p clipped to (eps,
    1-eps)."""
    p = torch.clamp(ins[0].value, _EPS, 1.0 - _EPS)
    t = ins[1].value
    cost = -(t * torch.log(p) + (1 - t) * torch.log1p(-p)).sum(dim=-1)
    return Argument(value=_reduce_tokens(cost, ins[0].mask))


@register_layer("soft_binary_class_cross_entropy")
class SoftBinaryCrossEntropyCost(_CostBase):
    """Binary cross-entropy against soft targets of the input's shape."""

    def apply(self, cfg, params, ins, ctx):
        return _binary_xent(ins)


@register_layer("multi_binary_label_cross_entropy")
class MultiBinaryLabelCrossEntropyCost(_CostBase):
    """Multi-label: sigmoid probabilities against a 0/1 label matrix."""

    def apply(self, cfg, params, ins, ctx):
        return _binary_xent(ins)


@register_layer("square_error")
class SquareErrorCost(_CostBase):
    """0.5 * ||x - y||^2 per sample (``SumOfSquaresCostLayer``)."""

    def apply(self, cfg, params, ins, ctx):
        d = ins[0].value - ins[1].value
        cost = 0.5 * torch.square(d).sum(dim=-1)
        return Argument(value=_reduce_tokens(cost, ins[0].mask))


@register_layer("smooth_l1")
class SmoothL1Cost(_CostBase):
    """Smooth L1 (Huber with delta 1) summed over the features
    (``SmoothL1CostLayer``)."""

    def apply(self, cfg, params, ins, ctx):
        d = ins[0].value - ins[1].value
        a = torch.abs(d)
        cost = torch.where(a < 1.0, 0.5 * d * d, a - 0.5).sum(dim=-1)
        return Argument(value=_reduce_tokens(cost, ins[0].mask))


@register_layer("huber_classification", "huber")
class HuberTwoClassCost(_CostBase):
    """Huber loss of binary classification, labels {0, 1} read as y in
    {-1, +1} (``HuberTwoClassification``)."""

    def apply(self, cfg, params, ins, ctx):
        x = ins[0].value[..., 0]
        y = 2.0 * ins[1].value.to(x.dtype) - 1.0
        yx = y * x
        cost = torch.where(yx < -1.0, -4.0 * yx,
                           torch.where(yx < 1.0, torch.square(1.0 - yx),
                                       torch.zeros_like(yx)))
        return Argument(value=_reduce_tokens(cost, ins[0].mask))


@register_layer("rank-cost")
class RankCost(_CostBase):
    """Pairwise ranking cost (``RankingCost``): inputs (left score, right
    score, label in [0, 1]); the cross-entropy of sigmoid(left - right)
    against the label."""

    def apply(self, cfg, params, ins, ctx):
        o = ins[0].value[..., 0] - ins[1].value[..., 0]
        t = ins[2].value.to(o.dtype)
        if t.dim() > o.dim():
            t = t[..., 0]
        cost = F.softplus(o) - t * o
        return Argument(value=_reduce_tokens(cost, ins[0].mask))


@register_layer("lambda_cost")
class LambdaCost(_CostBase):
    """The list-wise ranking cost over each sequence (``LambdaCost.cpp``)
    as the JAX package computes it: for every pair of real steps whose
    relevance is strictly higher on the left, softplus(-(s_i - s_j)),
    summed per list. Equal relevances make no pair."""

    def apply(self, cfg, params, ins, ctx):
        score = ins[0].value[..., 0]  # [B, T]
        rel = ins[1].value
        if rel.dim() == 3:
            rel = rel[..., 0]
        mask = ins[0].mask
        pair_valid = mask.unsqueeze(2) * mask.unsqueeze(1)
        s_diff = score.unsqueeze(2) - score.unsqueeze(1)
        r_diff = rel.unsqueeze(2) - rel.unsqueeze(1)
        better = (r_diff > 0).to(score.dtype) * pair_valid
        cost = (better * F.softplus(-s_diff)).sum(dim=(1, 2))
        return Argument(value=cost.reshape(-1, 1))


@register_layer("multi_class_cross_entropy_with_selfnorm")
class CrossEntropyWithSelfNormCost(_CostBase):
    """Cross-entropy plus alpha * log(Z)^2, which pushes the partition sum
    Z toward 1 (``MultiClassCrossEntropyWithSelfNorm``)."""

    def apply(self, cfg, params, ins, ctx):
        prob, label = ins[0], ins[1]
        p = torch.clamp_min(prob.value, _EPS)
        z = p.sum(dim=-1)
        pn = p / z.unsqueeze(-1)
        ll = torch.gather(pn, -1, label.value.long().unsqueeze(-1))[..., 0]
        alpha = cfg.attrs.get("softmax_selfnorm_alpha", 0.1)
        cost = -torch.log(ll) + alpha * torch.square(torch.log(z))
        return Argument(value=_reduce_tokens(cost, prob.mask))


@register_layer("sum_cost")
class SumCost(_CostBase):
    """``SumCostLayer``: the cost is the sum of the input row."""

    def apply(self, cfg, params, ins, ctx):
        return Argument(value=_reduce_tokens(ins[0].value.sum(dim=-1),
                                             ins[0].mask))


@register_layer("kl_gaussian")
class KLGaussianCost(_CostBase):
    """KL(N(mu, exp(logvar)) || N(0, I)) of a diagonal Gaussian given (mu,
    logvar): -0.5 * sum(1 + logvar - mu^2 - exp(logvar))."""

    def apply(self, cfg, params, ins, ctx):
        mu, logvar = ins[0].value, ins[1].value
        kl = -0.5 * (1.0 + logvar - mu * mu - torch.exp(logvar)).sum(dim=-1)
        return Argument(value=_reduce_tokens(kl, ins[0].mask))

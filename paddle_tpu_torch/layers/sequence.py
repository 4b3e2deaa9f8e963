"""Sequence layers: masked reductions over the padded ``[B, T, D]`` layout
(``MaxLayer.cpp``, ``AverageLayer.cpp``, ``SequenceLastInstanceLayer.cpp``,
``ExpandLayer.cpp``) and the reshape and time concatenation of sequences
(``SequenceReshapeLayer.cpp``, ``SequenceConcatLayer.cpp``). The port's
counterpart of ``paddle_tpu/layers/sequence.py`` for flat sequences;
nested (two-level) inputs and ``agg_level`` TO_SEQUENCE raise
``NotImplementedError``."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import LayerImpl, ShapeInfo, register_layer

_NEG_INF = -1e30


def _pooled_info(cfg, in_infos, what):
    if cfg.attrs.get("trans_type") == "seq":
        raise NotImplementedError(
            f"{what} of nested sequences is not ported yet")
    return ShapeInfo(size=in_infos[0].size, is_sequence=False)


def _flat_mask(a: Argument, what: str) -> torch.Tensor:
    if a.mask is not None and a.mask.dim() != 2:
        raise NotImplementedError(
            f"{what} of nested sequences is not ported yet")
    return a.mask


@register_layer("max")
class MaxLayer(LayerImpl):
    """Max over time of each sequence. An all-padding row reads
    ``_NEG_INF``, as in the JAX package."""

    def infer(self, cfg, in_infos):
        return _pooled_info(cfg, in_infos, "max pooling")

    def apply(self, cfg, params, ins, ctx):
        a = ins[0]
        v = torch.where(a.mask.unsqueeze(-1) > 0, a.value,
                        torch.full((), _NEG_INF, dtype=a.value.dtype,
                                   device=a.value.device))
        return Argument(value=v.amax(dim=1))


@register_layer("average")
class AverageLayer(LayerImpl):
    """Mean, sum or sqrt-n over time (``average_strategy`` "average",
    "sum", "squarerootn")."""

    def infer(self, cfg, in_infos):
        return _pooled_info(cfg, in_infos, "average pooling")

    def apply(self, cfg, params, ins, ctx):
        a = ins[0]
        mask = _flat_mask(a, "average pooling")
        strategy = cfg.attrs.get("average_strategy", "average")
        s = (a.value * mask.unsqueeze(-1)).sum(dim=1)
        if strategy == "sum":
            return Argument(value=s)
        n = torch.clamp_min(mask.sum(dim=1, keepdim=True), 1.0)
        if strategy == "squarerootn":
            return Argument(value=s / torch.sqrt(n))
        return Argument(value=s / n)


@register_layer("seqlastins")
class SeqLastInsLayer(LayerImpl):
    """Last (or first, with ``select_first``) real token of each sequence,
    found from the mask itself."""

    def infer(self, cfg, in_infos):
        return _pooled_info(cfg, in_infos, "first/last instance")

    def apply(self, cfg, params, ins, ctx):
        a = ins[0]
        m = _flat_mask(a, "first/last instance")
        if m is None:
            m = a.value.new_ones(a.value.shape[:2])
        live = (m > 0).to(torch.int32)
        if cfg.attrs.get("select_first", False):
            idx = torch.argmax(live, dim=1)
        else:
            idx = m.shape[1] - 1 - torch.argmax(live.flip(1), dim=1)
        v = torch.gather(a.value, 1, idx.view(-1, 1, 1).expand(
            -1, 1, a.value.shape[-1]))
        return Argument(value=v[:, 0])


@register_layer("expand")
class ExpandLayer(LayerImpl):
    """Broadcast a per-sequence vector (input 0, [B, D]) across the
    timesteps of input 1, zero on its padded steps."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=in_infos[0].size, is_sequence=True)

    def apply(self, cfg, params, ins, ctx):
        src, ref = ins
        mask = _flat_mask(ref, "expand")
        if src.value.dim() != 2:
            raise NotImplementedError(
                "expand of a per-sub-sequence input is not ported yet")
        B, T = mask.shape
        v = src.value.unsqueeze(1).expand(B, T, src.value.shape[-1])
        return Argument(value=v * mask.unsqueeze(-1), mask=mask)


def _lengths(a: Argument) -> torch.Tensor:
    """[B] true lengths (int64)."""
    return (a.mask > 0).sum(dim=1)


@register_layer("seqreshape")
class SeqReshapeLayer(LayerImpl):
    """[B, T, D] -> [B, T*D // size, size], the mask recomputed from each
    sequence's true token count."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=cfg.size, is_sequence=True)

    def apply(self, cfg, params, ins, ctx):
        a = ins[0]
        b, t, d = a.value.shape
        new_t = t * d // cfg.size
        toks = _lengths(a) * d // cfg.size
        pos = torch.arange(new_t, device=a.value.device)
        mask = (pos.unsqueeze(0) < toks.unsqueeze(1)).to(a.mask.dtype)
        return Argument(value=a.value.reshape(b, new_t, cfg.size), mask=mask)


@register_layer("seqconcat")
class SeqConcatLayer(LayerImpl):
    """Two sequences concatenated in time: the second placed after each
    first sequence's true length, the rest padding."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=in_infos[0].size, is_sequence=True)

    def apply(self, cfg, params, ins, ctx):
        a, b = ins
        Ta, Tb = a.value.shape[1], b.value.shape[1]
        la, lb = _lengths(a), _lengths(b)
        pos = torch.arange(Ta + Tb, device=a.value.device).unsqueeze(0)
        mask = (pos < (la + lb).unsqueeze(1)).to(a.mask.dtype)
        D = a.value.shape[-1]
        idx_a = pos.clamp(0, Ta - 1).expand(a.value.shape[0], -1)
        idx_b = (pos - la.unsqueeze(1)).clamp(0, Tb - 1)
        va = torch.gather(a.value, 1, idx_a.unsqueeze(-1).expand(-1, -1, D))
        vb = torch.gather(b.value, 1, idx_b.unsqueeze(-1).expand(-1, -1, D))
        v = torch.where((pos < la.unsqueeze(1)).unsqueeze(-1), va, vb)
        return Argument(value=v * mask.unsqueeze(-1), mask=mask)

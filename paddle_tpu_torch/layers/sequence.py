"""Sequence layers: masked reductions over the padded ``[B, T, D]`` layout
(``MaxLayer.cpp``, ``AverageLayer.cpp``, ``SequenceLastInstanceLayer.cpp``,
``ExpandLayer.cpp``), the reshape and time concatenation of sequences
(``SequenceReshapeLayer.cpp``, ``SequenceConcatLayer.cpp``) and the span of
each sequence (``SubSequenceLayer.cpp``). The port's counterpart of
``paddle_tpu/layers/sequence.py``.

Nested (two-level) inputs come as ``[B, S, T, D]`` with a ``[B, S, T]``
mask, or as a recurrent group's flattened output carrying that view in
``state["nested"]``. ``agg_level`` TO_SEQUENCE (``trans_type == "seq"``)
reduces each sub-sequence, giving a flat sequence over S whose mask marks
the sub-sequences that have tokens.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.argument import Argument, check_dead
from paddle_tpu_torch.core.registry import (LayerImpl, ParamSpec, ShapeInfo,
                                            register_layer)

_NEG_INF = -1e30


def _pooled_info(cfg, in_infos):
    if _to_sequence(cfg):
        return ShapeInfo(size=in_infos[0].size, is_sequence=True)
    return ShapeInfo(size=in_infos[0].size, is_sequence=False)


def _nested_view(a: Argument):
    """(value [B, S, T, D], mask [B, S, T]) of a two-level input: the
    group's stashed un-flattened view or a directly nested Argument; None
    for a flat one."""
    if isinstance(a.state, dict) and "nested" in a.state:
        nested = a.state["nested"]
        return nested.value, nested.mask
    if a.mask is not None and a.mask.dim() == 3:
        return a.value, a.mask
    return None


def _to_sequence(cfg) -> bool:
    return cfg.attrs.get("trans_type") == "seq"


def _sub_live(m3: torch.Tensor) -> torch.Tensor:
    """[B, S] f32: 1 where the sub-sequence has a token."""
    return (m3.sum(dim=-1) > 0).to(torch.float32)


@register_layer("max")
class MaxLayer(LayerImpl):
    """Max over time of each sequence; with TO_SEQUENCE on a nested input,
    max over each sub-sequence. An all-padding row reads ``_NEG_INF``, as
    in the JAX package."""

    def infer(self, cfg, in_infos):
        return _pooled_info(cfg, in_infos)

    def apply(self, cfg, params, ins, ctx):
        a = ins[0]
        neg = torch.full((), _NEG_INF, dtype=a.value.dtype,
                         device=a.value.device)
        if _to_sequence(cfg):
            v4, m3 = _nested_view(a)
            out = torch.where(m3.unsqueeze(-1) > 0, v4, neg).amax(dim=2)
            live = _sub_live(m3)
            return Argument(value=out * live.unsqueeze(-1), mask=live)
        v = torch.where(a.mask.unsqueeze(-1) > 0, a.value, neg)
        return Argument(value=v.amax(dim=1))


@register_layer("average")
class AverageLayer(LayerImpl):
    """Mean, sum or sqrt-n over time (``average_strategy`` "average",
    "sum", "squarerootn"); with TO_SEQUENCE, over each sub-sequence."""

    def infer(self, cfg, in_infos):
        return _pooled_info(cfg, in_infos)

    def apply(self, cfg, params, ins, ctx):
        a = ins[0]
        strategy = cfg.attrs.get("average_strategy", "average")
        if _to_sequence(cfg):
            v4, m3 = _nested_view(a)
            s = (v4 * m3.unsqueeze(-1)).sum(dim=2)
            n = torch.clamp_min(m3.sum(dim=2).unsqueeze(-1), 1.0)
            live = _sub_live(m3)
            out = (s if strategy == "sum" else
                   s / torch.sqrt(n) if strategy == "squarerootn" else s / n)
            return Argument(value=out * live.unsqueeze(-1), mask=live)
        mask = a.mask
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
    found from the mask itself (a flattened nested layout pads between
    sub-sequences); with TO_SEQUENCE, of each sub-sequence."""

    def infer(self, cfg, in_infos):
        return _pooled_info(cfg, in_infos)

    def apply(self, cfg, params, ins, ctx):
        a = ins[0]
        first = cfg.attrs.get("select_first", False)
        if _to_sequence(cfg):
            v4, m3 = _nested_view(a)
            if first:
                idx = torch.zeros(m3.shape[:2], dtype=torch.long,
                                  device=m3.device)
            else:
                idx = torch.clamp_min(m3.sum(dim=-1).long() - 1, 0)
            D = v4.shape[-1]
            v = torch.gather(v4, 2, idx[:, :, None, None].expand(
                -1, -1, 1, D))[:, :, 0]
            live = _sub_live(m3)
            return Argument(value=v * live.unsqueeze(-1), mask=live)
        m = a.mask
        if m is None:
            m = a.value.new_ones(a.value.shape[:2])
        live = (m > 0).to(torch.int32)
        if first:
            idx = torch.argmax(live, dim=1)
        else:
            idx = m.shape[1] - 1 - torch.argmax(live.flip(1), dim=1)
        v = torch.gather(a.value, 1, idx.view(-1, 1, 1).expand(
            -1, 1, a.value.shape[-1]))
        return Argument(value=v[:, 0])


@register_layer("expand")
class ExpandLayer(LayerImpl):
    """Broadcast a per-sequence vector (input 0, [B, D]) across the
    timesteps of input 1, zero on its padded steps. Onto a nested target
    ``[B, S, T]``: a per-sub-sequence vector ``[B, S', D]`` over each
    sub-sequence's steps (S' aligned to S where the extra or missing
    entries are dead), a per-sequence one over all of them. A sequence of
    per-sub-sequence vectors onto a flattened nested target: position t
    takes sub-sequence ``t // T_sub``."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=in_infos[0].size, is_sequence=True)

    def apply(self, cfg, params, ins, ctx):
        src, ref = ins
        if ref.mask is not None and ref.mask.dim() == 3:
            B, S, T = ref.mask.shape
            sv = src.value
            if sv.dim() == 3 and sv.shape[1] != S:
                if sv.shape[1] > S:
                    if src.mask is None:
                        raise ValueError(
                            f"expand: maskless per-sub source (len "
                            f"{sv.shape[1]}) cannot align to the "
                            f"target's {S} sub-sequences")
                    check_dead(src.mask[:, S:].sum(),
                               "expand: per-sub source longer than the "
                               f"target's {S} sub-sequences")
                    sv = sv[:, :S]
                else:
                    check_dead(
                        (ref.mask.sum(dim=-1) > 0)[:, sv.shape[1]:].sum(),
                        f"expand: per-sub source (len {sv.shape[1]}) "
                        "shorter than the target's live sub-sequences")
                    sv = F.pad(sv, (0, 0, 0, S - sv.shape[1]))
            v = sv[:, :, None, :] if sv.dim() == 3 else sv[:, None, None, :]
            v = v.expand(B, S, T, sv.shape[-1])
            return Argument(value=v * ref.mask.unsqueeze(-1), mask=ref.mask)
        T = ref.value.shape[1]
        if src.value.dim() == 3:
            nested = _nested_view(ref) if ref.mask.dim() == 2 else None
            if nested is None:
                raise ValueError(
                    "expand of a per-sub-sequence input needs a nested "
                    "target (a group output carrying its 2-level view)")
            t_sub = nested[1].shape[-1]
            sub_of = torch.arange(T, device=src.value.device) // t_sub
            v = src.value.index_select(1, sub_of)
            return Argument(value=v * ref.mask.unsqueeze(-1), mask=ref.mask)
        mask = ref.mask
        B = src.value.shape[0]
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


@register_layer("subseq")
class SubSequenceLayer(LayerImpl):
    """``SubSequenceLayer.cpp``: a span of each sequence, ``out[b] =
    x[b, off[b] : off[b] + n[b]]`` shifted to position 0, as one gather
    with a recomputed mask; a span past the source's true length is
    clamped and masked. Inputs: sequence [B, T, D], offsets [B], sizes
    [B]; an optional bias on the kept positions."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=in_infos[0].size, is_sequence=True)

    def params(self, cfg, in_infos):
        if cfg.bias:
            return {"wbias": ParamSpec(shape=(in_infos[0].size,),
                                       init="zeros", is_bias=True)}
        return {}

    def apply(self, cfg, params, ins, ctx):
        a, off_a, size_a = ins
        x = a.value
        B, T = x.shape[0], x.shape[1]
        off = off_a.value.reshape(B).long()
        n = size_a.value.reshape(B).long()
        pos = torch.arange(T, device=x.device).unsqueeze(0)
        idx = torch.clamp(pos + off.unsqueeze(1), 0, T - 1)
        out = torch.gather(x, 1, idx.unsqueeze(-1).expand(-1, -1,
                                                          x.shape[-1]))
        mask = (pos < n.unsqueeze(1)).to(torch.float32)
        if a.mask is not None:
            mask = mask * torch.gather(a.mask, 1, idx)
        out = out * mask.unsqueeze(-1)
        if "wbias" in params:
            out = out + params["wbias"] * mask.unsqueeze(-1)
        return Argument(value=out, mask=mask)

"""Core dense layers: data, fc, embedding (``DataLayer``,
``FullyConnectedLayer``, ``TableProjection`` in the reference). The port's
counterpart of the same layers in ``paddle_tpu/layers/common.py``; fc over
a sequence is one batched ``torch.matmul``."""

from __future__ import annotations

from typing import Dict, List

import torch

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import (LayerImpl, ParamSpec, ShapeInfo,
                                            register_layer)


def _first_mask(ins: List[Argument]):
    for a in ins:
        if a.mask is not None:
            return a.mask
    return None


def _flat(a: Argument) -> torch.Tensor:
    """Flatten image (non-sequence >2D) inputs to [B, features]."""
    if a.mask is None and a.value.dim() > 2:
        return a.value.reshape(a.value.shape[0], -1)
    return a.value


@register_layer("data")
class DataLayer(LayerImpl):
    """Pass-through input layer; the executor feeds it directly."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=cfg.size or 0,
                         channels=cfg.attrs.get("channels"),
                         height=cfg.attrs.get("height"),
                         width=cfg.attrs.get("width"),
                         is_sequence=cfg.attrs.get("is_sequence", False))


@register_layer("fc")
class FcLayer(LayerImpl):
    """y = act(sum_i x_i W_i + b), weight layout [in, out]."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=cfg.size,
                         is_sequence=any(i.is_sequence for i in in_infos))

    def params(self, cfg, in_infos):
        specs: Dict[str, ParamSpec] = {}
        for i, info in enumerate(in_infos):
            specs[f"w{i}"] = ParamSpec(shape=(info.size, cfg.size))
        if cfg.bias:
            specs["wbias"] = ParamSpec(shape=(cfg.size,), init="zeros",
                                       is_bias=True)
        return specs

    def apply(self, cfg, params, ins, ctx):
        out = None
        for i, a in enumerate(ins):
            y = _flat(a) @ params[f"w{i}"]
            out = y if out is None else out + y
        if "wbias" in params:
            out = out + params["wbias"]
        return Argument(value=out, mask=_first_mask(ins))


@register_layer("embedding")
class EmbeddingLayer(LayerImpl):
    """Table lookup."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=cfg.size, is_sequence=in_infos[0].is_sequence)

    def params(self, cfg, in_infos):
        vocab = cfg.attrs["vocab_size"]
        return {"w0": ParamSpec(shape=(vocab, cfg.size), sparse_grad=True)}

    def apply(self, cfg, params, ins, ctx):
        out = _table_lookup(params["w0"], ins[0].value.long())
        return Argument(value=out, mask=ins[0].mask)


def _table_lookup(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup with the reference's ignore semantics: id -1 (the OOV
    sentinel) and ids >= vocab read a ZERO row, never a clamped neighbour,
    exactly as ``paddle_tpu/layers/common.py:_table_lookup``. The serving
    feeder validates ids on the host and answers a typed 400 before a bad
    id reaches this lookup."""
    valid = (ids >= 0) & (ids < w.shape[0])
    out = w[ids.clamp(0, w.shape[0] - 1)]
    return out * valid.unsqueeze(-1).to(out.dtype)

"""Core dense layers: data, fc, embedding, addto, concat, scaling
(``DataLayer``, ``FullyConnectedLayer``, ``TableProjection``,
``AddtoLayer``, ``ConcatenateLayer``, ``ScalingLayer`` in the reference).
The port's counterpart of the same layers in
``paddle_tpu/layers/common.py``; fc over a sequence is one batched
``torch.matmul``."""

from __future__ import annotations

from typing import Dict, List

import torch

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import (LayerImpl, ParamSpec, ShapeInfo,
                                            register_layer)
from paddle_tpu_torch.layers.conv import to_nhwc


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


@register_layer("addto")
class AddtoLayer(LayerImpl):
    """Element-wise sum of the inputs (plus an optional bias)."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=in_infos[0].size,
                         channels=in_infos[0].channels,
                         height=in_infos[0].height, width=in_infos[0].width,
                         is_sequence=any(i.is_sequence for i in in_infos))

    def params(self, cfg, in_infos):
        if cfg.bias:
            return {"wbias": ParamSpec(shape=(in_infos[0].size,),
                                       init="zeros", is_bias=True)}
        return {}

    def apply(self, cfg, params, ins, ctx):
        out = ins[0].value
        for a in ins[1:]:
            out = out + a.value
        if "wbias" in params:
            out = out + params["wbias"]
        return Argument(value=out, mask=_first_mask(ins))


@register_layer("concat")
class ConcatLayer(LayerImpl):
    """Feature-wise concatenation; image inputs with matching spatial
    extents concatenate channel-wise (inception blocks), keeping their
    geometry so pooling can follow."""

    def infer(self, cfg, in_infos):
        info = ShapeInfo(size=sum(i.size for i in in_infos),
                         is_sequence=any(i.is_sequence for i in in_infos))
        if all(i.height is not None and i.channels is not None
               for i in in_infos) and len(
                {(i.height, i.width) for i in in_infos}) == 1:
            info.channels = sum(i.channels for i in in_infos)
            info.height = in_infos[0].height
            info.width = in_infos[0].width
        return info

    def apply(self, cfg, params, ins, ctx):
        vals = []
        for a, info in zip(ins, ctx.in_infos):
            v = a.value
            if ctx.out_info.channels is not None and v.dim() == 2:
                # flat channel-major rows -> NHWC before channel concat
                v = to_nhwc(v, info.channels, info.height, info.width)
            vals.append(v)
        return Argument(value=torch.cat(vals, dim=-1),
                        mask=_first_mask(ins))


@register_layer("scaling")
class ScalingLayer(LayerImpl):
    """out[i] = w[i] * x[i]: the weight input first ([B, 1], or [B, T, 1]
    per timestep), the data input second (``ScalingLayer.cpp``)."""

    def infer(self, cfg, in_infos):
        return in_infos[1]

    def apply(self, cfg, params, ins, ctx):
        w, x = ins
        return Argument(value=w.value * x.value, mask=x.mask)


def _table_lookup(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup with the reference's ignore semantics: id -1 (the OOV
    sentinel) and ids >= vocab read a ZERO row, never a clamped neighbour,
    exactly as ``paddle_tpu/layers/common.py:_table_lookup``. The serving
    feeder validates ids on the host and answers a typed 400 before a bad
    id reaches this lookup."""
    valid = (ids >= 0) & (ids < w.shape[0])
    out = w[ids.clamp(0, w.shape[0] - 1)]
    return out * valid.unsqueeze(-1).to(out.dtype)

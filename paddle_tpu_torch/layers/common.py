"""Core dense layers: data, fc, embedding, mixed and its projections,
addto, concat, concat2, slope_intercept, scaling, interpolation, maxid,
cos, trans (``DataLayer``, ``FullyConnectedLayer``, ``MixedLayer`` and the
``*Projection``/``*Operator`` classes, ``AddtoLayer``,
``ConcatenateLayer[2]``, ``SlopeInterceptLayer``, ``ScalingLayer``,
``InterpolationLayer``, ``MaxIdLayer``, ``CosSimLayer``, ``TransLayer`` in
the reference). The port's counterpart of ``paddle_tpu/layers/common.py``;
fc over a sequence is one batched ``torch.matmul``."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import (LayerImpl, ParamSpec, ShapeInfo,
                                            register_layer)
from paddle_tpu_torch.layers.conv import (_conv_geom, _conv_spec,
                                          conv_transpose_grouped, derive_geom,
                                          to_nhwc)
from paddle_tpu_torch.utils.precision import matmul


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
            y = matmul(_flat(a), params[f"w{i}"])
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


# --------------------------------------------------------------------- mixed
def _project(proj: dict, x: torch.Tensor, w) -> torch.Tensor:
    kind = proj.get("type", "full_matrix")
    if kind == "full_matrix":
        return matmul(x, w)
    if kind == "trans_full_matrix":
        return matmul(x, w.T)
    if kind == "identity":
        return x
    if kind == "dot_mul":
        return x * w
    if kind == "table":
        ids = x
        if (proj.get("dense_argmax_ids") and ids.is_floating_point()
                and ids.dim() >= 2 and ids.shape[-1] == w.shape[0]):
            # a dense float layer feeds the table, flagged by the config:
            # the id is the row's argmax
            ids = torch.argmax(ids, dim=-1)
        return _table_lookup(w, ids.long())
    if kind == "scaling":
        return x * w[0]
    if kind == "slice":
        return torch.cat([x[..., s:e] for s, e in proj["slices"]], dim=-1)
    raise KeyError(f"unknown projection type {kind!r}")


def _context_project(proj: dict, a: Argument, w) -> torch.Tensor:
    """Sliding-window concat over time (``ContextProjection``): output
    step t is [x[t+start], ..., x[t+start+len-1]] concatenated, with
    out-of-sequence positions read from the padding rows ``w`` (begin rows
    then end rows; zeros without them)."""
    x, mask = a.value, a.mask
    if x.dim() == 2:
        # a non-sequence batch is B sequences of length 1
        y = _context_project(proj, Argument(
            value=x.unsqueeze(1), mask=x.new_ones(x.shape[0], 1)), w)
        return y[:, 0]
    if x.dim() != 3:
        raise ValueError("context projection needs a sequence input")
    B, T, D = x.shape
    start = int(proj.get("context_start", 0))
    length = int(proj.get("context_length", 1))
    begin_pad = max(0, -start)
    lengths = (mask.sum(dim=1).long() if mask is not None
               else torch.full((B,), T, dtype=torch.long, device=x.device))
    t_idx = torch.arange(T, device=x.device)
    pieces = []
    for o in range(start, start + length):
        idx = t_idx + o                                   # [T]
        src = x[:, idx.clamp(0, T - 1)]                   # [B, T, D]
        before = (idx < 0).view(1, T, 1)
        after = (idx.unsqueeze(0) > lengths.unsqueeze(1) - 1).unsqueeze(-1)
        if w is not None:
            total_pad = w.shape[0]
            brow = w[(idx + begin_pad).clamp(0, total_pad - 1)]   # [T, D]
            arow = w[(begin_pad + idx.unsqueeze(0) - lengths.unsqueeze(1))
                     .clamp(0, total_pad - 1)]                    # [B, T, D]
        else:
            brow = x.new_zeros(T, D)
            arow = x.new_zeros(B, T, D)
        piece = torch.where(before, brow.unsqueeze(0).expand(B, T, D), src)
        pieces.append(torch.where(after, arow, piece))
    return torch.cat(pieces, dim=-1)


def _conv_proj_geom(proj: dict, info):
    """(c_in, in_h, in_w, out_h, out_w) of a conv projection or operator
    over one input."""
    c, in_h, in_w = derive_geom(info, proj.get("num_channels"))
    fs, fsy, st, sty, pad, pady = _conv_spec(proj, info)[:6]
    if proj["type"] in ("convt", "convt_op"):
        oh = (in_h - 1) * sty + fsy - 2 * pady
        ow = (in_w - 1) * st + fs - 2 * pad
    else:
        oh = _conv_geom(in_h, fsy, pady, sty)
        ow = _conv_geom(in_w, fs, pad, st)
    return c, in_h, in_w, oh, ow


def _conv_project(proj: dict, a: Argument, w, info):
    """One conv/convt projection -> NHWC [B, oh, ow, nf]; ``w`` is HWIO as
    the conv layers keep it."""
    c, in_h, in_w, _, _ = _conv_proj_geom(proj, info)
    fs, fsy, st, sty, pad, pady, groups, _ = _conv_spec(proj, info)
    x = to_nhwc(a.value, c, in_h, in_w)
    if proj["type"] == "conv":
        return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                        stride=(sty, st), padding=(pady, pad),
                        groups=groups).permute(0, 2, 3, 1)
    return conv_transpose_grouped(x, w, strides=(sty, st),
                                  padding=(pady, pad), groups=groups)


def _conv_operator(op: dict, img: Argument, flt: Argument, info):
    """A conv with each sample's own filters (``ConvOperator.cpp``,
    ``ConvTransOperator.cpp``): input 0 the image, input 1 a layer output
    holding each sample's filter bank, flat in the reference's order [nf,
    c, fsy, fs]. The B convolutions are one grouped convolution over the
    batch folded into the channels."""
    c, in_h, in_w, _, _ = _conv_proj_geom(op, info)
    nf = op["num_filters"]
    fs, fsy, st, sty, pad, pady = _conv_spec(op, info)[:6]
    x = to_nhwc(img.value, c, in_h, in_w)                # [B, H, W, C]
    B = x.shape[0]
    if flt.value.shape[0] != B:
        raise ValueError(
            f"conv_operator: filter batch {flt.value.shape[0]} != image "
            f"batch {B} (ConvOperator.cpp:61 CHECK_EQ)")
    k = flt.value.reshape(B, nf, c, fsy, fs)
    xg = x.permute(0, 3, 1, 2).reshape(1, B * c, in_h, in_w)
    if op["type"] == "conv_op":
        y = F.conv2d(xg, k.reshape(B * nf, c, fsy, fs), stride=(sty, st),
                     padding=(pady, pad), groups=B)
    else:                                                # convt_op
        y = F.conv_transpose2d(
            xg, k.transpose(1, 2).reshape(B * c, nf, fsy, fs),
            stride=(sty, st), padding=(pady, pad), groups=B)
    return y.reshape(B, nf, y.shape[2], y.shape[3]).permute(0, 2, 3, 1)


@register_layer("mixed")
class MixedLayer(LayerImpl):
    """Sum of per-input projections and operators (``MixedLayer.cpp``).
    Each entry of the ``projections`` attr is {"type": ..., ...} for its
    input: full_matrix, trans_full_matrix, identity, dot_mul, table,
    scaling, slice, context, conv, convt; ``operators`` holds dot_mul_op,
    conv_op and convt_op over pairs of inputs."""

    def infer(self, cfg, in_infos):
        projs = cfg.attrs.get("projections") or []
        # a conv projection or operator gives the output image geometry
        for proj, info in zip(projs, in_infos):
            if proj and proj.get("type") in ("conv", "convt"):
                nf = proj["num_filters"]
                _, _, _, oh, ow = _conv_proj_geom(proj, info)
                return ShapeInfo(size=nf * oh * ow, channels=nf,
                                 height=oh, width=ow)
        for op in cfg.attrs.get("operators") or []:
            if op.get("type") in ("conv_op", "convt_op"):
                nf = op["num_filters"]
                idx = op["input_indices"][0]
                _, _, _, oh, ow = _conv_proj_geom(op, in_infos[idx])
                return ShapeInfo(size=nf * oh * ow, channels=nf,
                                 height=oh, width=ow)
        return ShapeInfo(size=cfg.size,
                         is_sequence=any(i.is_sequence for i in in_infos))

    @staticmethod
    def _default_projs(cfg, n):
        """full_matrix for every input but the operators' arguments, which
        carry no projection of their own."""
        op_args = {i for op in (cfg.attrs.get("operators") or [])
                   for i in op.get("input_indices", [])}
        return [{"type": "identity_op_arg"} if i in op_args
                else {"type": "full_matrix"} for i in range(n)]

    def params(self, cfg, in_infos):
        projs = cfg.attrs.get("projections") or self._default_projs(
            cfg, len(in_infos))
        specs: Dict[str, ParamSpec] = {}
        for i, info in enumerate(in_infos):
            specs.update(self._param_for(i, projs[i] or {}, info, cfg))
        if cfg.bias:
            size = cfg.size
            for proj in projs:
                if proj and proj.get("type") in ("conv", "convt"):
                    size = proj["num_filters"]  # shared conv bias per map
                    break
            else:
                for op in cfg.attrs.get("operators") or []:
                    if op.get("type") in ("conv_op", "convt_op"):
                        size = op["num_filters"]
                        break
            specs["wbias"] = ParamSpec(shape=(size,), init="zeros",
                                       is_bias=True)
        return specs

    def _param_for(self, i, proj, info, cfg):
        kind = proj.get("type", "full_matrix")
        if kind == "full_matrix":
            return {f"w{i}": ParamSpec(shape=(info.size, cfg.size))}
        if kind == "trans_full_matrix":
            return {f"w{i}": ParamSpec(shape=(cfg.size, info.size))}
        if kind == "dot_mul":
            return {f"w{i}": ParamSpec(shape=(cfg.size,))}
        if kind == "table":
            return {f"w{i}": ParamSpec(shape=(proj["vocab_size"], cfg.size),
                                       sparse_grad=True)}
        if kind == "scaling":
            return {f"w{i}": ParamSpec(shape=(1,))}
        if kind == "context":
            start = int(proj.get("context_start", 0))
            length = int(proj.get("context_length", 1))
            total_pad = max(0, -start) + max(0, start + length - 1)
            if total_pad == 0:
                return {}
            # the padding rows: static zeros unless trainable_padding
            return {f"w{i}": ParamSpec(
                shape=(total_pad, info.size), init="const",
                initial_mean=0.0, initial_std=0.0,
                is_static=not proj.get("trainable_padding", False))}
        if kind in ("conv", "convt"):
            c = _conv_proj_geom(proj, info)[0]
            fs, fsy, _, _, _, _, groups, _ = _conv_spec(proj, info)
            nf = proj["num_filters"]
            if kind == "conv":
                return {f"w{i}": ParamSpec(shape=(fsy, fs, c // groups, nf),
                                           wire_dims=())}
            return {f"w{i}": ParamSpec(shape=(fsy, fs, nf // groups, c),
                                       wire_dims=())}
        return {}  # identity, slice

    def apply(self, cfg, params, ins, ctx):
        projs = cfg.attrs.get("projections") or self._default_projs(
            cfg, len(ins))
        ops = cfg.attrs.get("operators") or []
        conv_kinds = {"conv", "convt"}
        kinds = {p.get("type", "full_matrix") for p in projs
                 if p and p.get("type") != "identity_op_arg"}
        image_side = bool(kinds & conv_kinds) or any(
            o.get("type") in ("conv_op", "convt_op") for o in ops)
        flat_side = bool(kinds - conv_kinds) or any(
            o.get("type") in ("dot_mul", "dot_mul_op") for o in ops)
        if image_side and flat_side:
            # NHWC maps and [B, size] rows have no sum (nor in the
            # reference)
            raise NotImplementedError(
                "a mixed layer cannot combine conv projections/operators "
                "with flat projections")
        out = None
        op_arg_idx = set()
        for op in ops:
            idxs = list(op.get("input_indices", []))
            op_arg_idx.update(idxs)
            if op.get("type") in ("dot_mul", "dot_mul_op"):
                # DotMulOperator.cpp: a * b * scale of two layer outputs
                av, bv = _flat(ins[idxs[0]]), _flat(ins[idxs[1]])
                if av.shape[-1] != bv.shape[-1]:
                    raise ValueError(
                        f"dotmul_operator argument widths differ: "
                        f"{av.shape[-1]} vs {bv.shape[-1]}")
                t = av * bv * float(op.get("scale", 1.0))
            elif op.get("type") in ("conv_op", "convt_op"):
                t = _conv_operator(op, ins[idxs[0]], ins[idxs[1]],
                                   ctx.in_infos[idxs[0]])
            else:
                raise NotImplementedError(
                    f"mixed-layer operator {op.get('type')!r} is not "
                    "executable")
            out = t if out is None else out + t
        for i, (a, proj) in enumerate(zip(ins, projs)):
            if i in op_arg_idx:
                continue
            y = _projection(i, proj, a, params, ctx)
            out = y if out is None else out + y
        if "wbias" in params:
            out = out + params["wbias"]
        return Argument(value=out, mask=_first_mask(ins))


def _projection(i, proj, a, params, ctx):
    """Input ``i``'s projection ``proj`` of ``a``."""
    kind = (proj or {}).get("type", "full_matrix")
    if kind in ("conv", "convt"):
        return _conv_project(proj, a, params[f"w{i}"], ctx.in_infos[i])
    if kind == "context":
        return _context_project(proj, a, params.get(f"w{i}"))
    x = a.value if kind == "table" else _flat(a)
    return _project(proj or {}, x, params.get(f"w{i}"))


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


@register_layer("concat2")
class Concat2Layer(MixedLayer):
    """``ConcatenateLayer2.cpp``: per-input projections whose outputs are
    concatenated, each keeping its own width ("size" in its entry, the
    input's width without one); conv projections concatenate their maps
    on the channel axis."""

    def infer(self, cfg, in_infos):
        projs = cfg.attrs.get("projections") or []
        conv_kinds = [(p or {}).get("type") in ("conv", "convt")
                      for p in projs]
        if any(conv_kinds):
            if not all(conv_kinds):
                raise NotImplementedError(
                    "concat2 cannot mix conv projections with flat "
                    "projections (4-D maps vs [B, size] vectors)")
            nf_total, oh, ow = 0, None, None
            for p, info in zip(projs, in_infos):
                _, _, _, poh, pow_ = _conv_proj_geom(p, info)
                nf_total += int(p["num_filters"])
                if oh is None:
                    oh, ow = poh, pow_
                elif (oh, ow) != (poh, pow_):
                    raise ValueError(
                        "concat2 conv projections disagree on output "
                        f"geometry: {(oh, ow)} vs {(poh, pow_)}")
            return ShapeInfo(size=nf_total * oh * ow, channels=nf_total,
                             height=oh, width=ow)
        total = sum(int((p or {}).get("size") or info.size)
                    for p, info in zip(projs, in_infos))
        return ShapeInfo(size=total,
                         is_sequence=any(i.is_sequence for i in in_infos))

    def params(self, cfg, in_infos):
        projs = cfg.attrs.get("projections") or [
            {"type": "identity"} for _ in in_infos]
        specs: Dict[str, ParamSpec] = {}
        for i, info in enumerate(in_infos):
            psize = int((projs[i] or {}).get("size") or info.size)
            sub_cfg = dataclasses.replace(cfg, size=psize)
            specs.update(self._param_for(i, projs[i] or {}, info, sub_cfg))
        if cfg.bias:
            if any((p or {}).get("type") in ("conv", "convt")
                   for p in projs):
                # one shared bias per output channel
                bias_size = sum(int(p["num_filters"]) for p in projs)
            else:
                bias_size = self.infer(cfg, in_infos).size
            specs["wbias"] = ParamSpec(shape=(bias_size,), init="zeros",
                                       is_bias=True)
        return specs

    def apply(self, cfg, params, ins, ctx):
        projs = cfg.attrs.get("projections") or [
            {"type": "identity"} for _ in ins]
        out = torch.cat([_projection(i, proj or {"type": "identity"}, a,
                                     params, ctx)
                         for i, (a, proj) in enumerate(zip(ins, projs))],
                        dim=-1)
        if "wbias" in params:
            out = out + params["wbias"]
        return Argument(value=out, mask=_first_mask(ins))


@register_layer("slope_intercept")
class SlopeInterceptLayer(LayerImpl):
    """slope * x + intercept (``SlopeInterceptLayer.cpp``)."""

    def infer(self, cfg, in_infos):
        return in_infos[0]

    def apply(self, cfg, params, ins, ctx):
        slope = cfg.attrs.get("slope", 1.0)
        intercept = cfg.attrs.get("intercept", 0.0)
        return ins[0].with_value(slope * ins[0].value + intercept)


@register_layer("scaling")
class ScalingLayer(LayerImpl):
    """out[i] = w[i] * x[i]: the weight input first ([B, 1], or [B, T, 1]
    per timestep), the data input second (``ScalingLayer.cpp``)."""

    def infer(self, cfg, in_infos):
        return in_infos[1]

    def apply(self, cfg, params, ins, ctx):
        w, x = ins
        return Argument(value=w.value * x.value, mask=x.mask)


@register_layer("interpolation")
class InterpolationLayer(LayerImpl):
    """out = w*x1 + (1-w)*x2; inputs [w [B,1], x1, x2]
    (``InterpolationLayer.cpp``)."""

    def infer(self, cfg, in_infos):
        return in_infos[1]

    def apply(self, cfg, params, ins, ctx):
        w, x1, x2 = ins
        return Argument(value=w.value * x1.value + (1.0 - w.value) * x2.value,
                        mask=x1.mask)


@register_layer("maxid")
class MaxIdLayer(LayerImpl):
    """The index of each row's largest entry (``MaxIdLayer.cpp``); the
    first on ties, as ``jnp.argmax``."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=1, is_sequence=in_infos[0].is_sequence)

    def apply(self, cfg, params, ins, ctx):
        return Argument(value=torch.argmax(ins[0].value, dim=-1),
                        mask=ins[0].mask)


@register_layer("cos")
class CosSimLayer(LayerImpl):
    """Row-wise cosine similarity scaled by ``cos_scale``
    (``CosSimLayer.cpp``)."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=1,
                         is_sequence=any(i.is_sequence for i in in_infos))

    def apply(self, cfg, params, ins, ctx):
        a, b = ins[0].value, ins[1].value
        scale = cfg.attrs.get("cos_scale", 1.0)
        dot = (a * b).sum(dim=-1, keepdim=True)
        na = torch.sqrt((a * a).sum(dim=-1, keepdim=True) + 1e-12)
        nb = torch.sqrt((b * b).sum(dim=-1, keepdim=True) + 1e-12)
        return Argument(value=scale * dot / (na * nb), mask=_first_mask(ins))


@register_layer("trans")
class TransLayer(LayerImpl):
    """Transpose of the [B, N] batch viewed as a matrix
    (``TransLayer.cpp``)."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=in_infos[0].size)

    def apply(self, cfg, params, ins, ctx):
        return Argument(value=ins[0].value.T)


def _table_lookup(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup with the reference's ignore semantics: id -1 (the OOV
    sentinel) and ids >= vocab read a ZERO row, never a clamped neighbour,
    exactly as ``paddle_tpu/layers/common.py:_table_lookup``. The serving
    feeder validates ids on the host and answers a typed 400 before a bad
    id reaches this lookup."""
    valid = (ids >= 0) & (ids < w.shape[0])
    out = w[ids.clamp(0, w.shape[0] - 1)]
    return out * valid.unsqueeze(-1).to(out.dtype)

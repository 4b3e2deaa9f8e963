"""Long-tail layer types: elementwise, shape and image utility layers, the
port's counterpart of ``paddle_tpu/layers/misc.py``. Each class names the
reference implementation in ``paddle/gserver/layers/``; each is plain
tensor code, differentiated by autograd. Anything image-shaped flows NHWC
(see ``conv.py``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import (LayerImpl, ParamSpec, ShapeInfo,
                                            register_layer)
from paddle_tpu_torch.layers.common import _first_mask
from paddle_tpu_torch.layers.conv import to_nhwc


class _FeedSlot(LayerImpl):
    """An identity connector when wired; without inputs a slot the
    executor feeds by name (the memory and in-link agents of an expanded
    recurrent sub-model, which the reference wires at run time)."""

    feed_slot = True

    def infer(self, cfg, in_infos):
        if not in_infos:
            return ShapeInfo(size=cfg.size or 0,
                             is_sequence=cfg.attrs.get("is_sequence", False))
        return in_infos[0]

    def apply(self, cfg, params, ins, ctx):
        return ins[0]


@register_layer("agent")
class AgentLayer(_FeedSlot):
    """``AgentLayer.cpp``: forwards another layer's output unchanged."""


@register_layer("scatter_agent")
class ScatterAgentLayer(_FeedSlot):
    """``AgentLayer.cpp`` (``scatter_agent``): the in-link boundary that
    receives one frame of the outer sequence."""


@register_layer("gather_agent")
class GatherAgentLayer(LayerImpl):
    """``AgentLayer.cpp`` (``gather_agent``): one wired input passes
    through; several concatenate along time, in order."""

    def infer(self, cfg, in_infos):
        if not in_infos:
            return ShapeInfo(size=cfg.size or 0, is_sequence=True)
        return dataclasses.replace(in_infos[0], is_sequence=True)

    def apply(self, cfg, params, ins, ctx):
        if len(ins) == 1:
            return ins[0]
        masks = [a.mask if a.mask is not None
                 else a.value.new_ones(a.value.shape[:2]) for a in ins]
        return Argument(value=torch.cat([a.value for a in ins], dim=1),
                        mask=torch.cat(masks, dim=1))


@register_layer("out_prod")
class OuterProdLayer(LayerImpl):
    """``OuterProdLayer.cpp``: out[b] = flatten(x0[b] ⊗ x1[b])."""

    def infer(self, cfg, in_infos):
        if in_infos[0].is_sequence != in_infos[1].is_sequence:
            raise ValueError(
                "out_prod needs two inputs of the same kind (both "
                "sequence or both non-sequence); the reference pairs "
                "rows 1:1 (OuterProdLayer.cpp CHECK_EQ on heights)")
        return ShapeInfo(size=in_infos[0].size * in_infos[1].size,
                         is_sequence=in_infos[0].is_sequence)

    def apply(self, cfg, params, ins, ctx):
        x0, x1 = ins[0].value, ins[1].value
        out = x0.unsqueeze(-1) * x1.unsqueeze(-2)
        out = out.reshape(out.shape[:-2] + (x0.shape[-1] * x1.shape[-1],))
        return Argument(value=out, mask=_first_mask(ins))


@register_layer("data_norm")
class DataNormLayer(LayerImpl):
    """``DataNormLayer.cpp``: normalises with precomputed statistics held
    in one static 5 x size parameter (rows: min, 1/(max-min), mean, 1/std,
    1/10^j): z-score, min-max or decimal-scaling."""

    def infer(self, cfg, in_infos):
        return dataclasses.replace(in_infos[0])

    def params(self, cfg, in_infos):
        return {"w0": ParamSpec(shape=(5, in_infos[0].size), init="zeros",
                                is_static=True)}

    def apply(self, cfg, params, ins, ctx):
        w = params["w0"]
        mode = cfg.attrs.get("data_norm_strategy", "z-score")
        x = ins[0].value
        if mode == "z-score":
            out = (x - w[2]) * w[3]
        elif mode == "min-max":
            out = (x - w[0]) * w[1]
        elif mode == "decimal-scaling":
            out = x * w[4]
        else:
            raise ValueError(
                f"unknown data normalization strategy {mode!r} "
                "(z-score | min-max | decimal-scaling)")
        return ins[0].with_value(out)


@register_layer("clip")
class ClipLayer(LayerImpl):
    """``ClipLayer.cpp``: elementwise clamp to [min, max]."""

    def infer(self, cfg, in_infos):
        return in_infos[0]

    def apply(self, cfg, params, ins, ctx):
        return ins[0].with_value(torch.clamp(
            ins[0].value, cfg.attrs.get("min", -1.0),
            cfg.attrs.get("max", 1.0)))


@register_layer("power")
class PowerLayer(LayerImpl):
    """``PowerLayer.cpp``: out = x ** p with a per-sample exponent; the
    exponent input first ([B, 1]), the data second."""

    def infer(self, cfg, in_infos):
        return in_infos[1]

    def apply(self, cfg, params, ins, ctx):
        p, x = ins[0].value, ins[1].value
        p = p.reshape((p.shape[0],) + (1,) * (x.dim() - 1))
        return ins[1].with_value(x ** p)


@register_layer("prelu")
class PReluLayer(LayerImpl):
    """``ParameterReluLayer.cpp``: out = max(0, x) + alpha * min(0, x);
    ``partial_sum`` adjacent features share one learned alpha."""

    def infer(self, cfg, in_infos):
        return in_infos[0]

    def params(self, cfg, in_infos):
        n = in_infos[0].size // cfg.attrs.get("partial_sum", 1)
        # smart-normal like any input parameter (no dims recorded)
        return {"w0": ParamSpec(shape=(n,), wire_dims=())}

    def apply(self, cfg, params, ins, ctx):
        x = ins[0].value
        alpha = params["w0"].repeat_interleave(
            cfg.attrs.get("partial_sum", 1))
        return ins[0].with_value(torch.clamp_min(x, 0.0)
                                 + alpha * torch.clamp_max(x, 0.0))


@register_layer("maxout")
class MaxOutLayer(LayerImpl):
    """``MaxOutLayer.cpp``: the max over groups of adjacent channels
    (output i = max of input channels [i*g, i*g + g))."""

    def infer(self, cfg, in_infos):
        g = cfg.attrs["groups"]
        info = in_infos[0]
        if info.channels:
            return ShapeInfo(size=info.size // g, channels=info.channels // g,
                             height=info.height, width=info.width)
        return ShapeInfo(size=info.size // g)

    def apply(self, cfg, params, ins, ctx):
        g = cfg.attrs["groups"]
        info = ctx.in_infos[0]
        x = ins[0].value
        if info.channels:
            x = to_nhwc(x, info.channels, info.height, info.width)
            b, h, w, c = x.shape
            return Argument(value=x.reshape(b, h, w, c // g, g).amax(dim=4))
        return ins[0].with_value(x.reshape(x.shape[0], -1, g).amax(dim=2))


@register_layer("multiplex")
class MultiplexLayer(LayerImpl):
    """``MultiplexLayer.cpp``: the first input an index column; output row
    b copies row b of data input index[b]."""

    def infer(self, cfg, in_infos):
        return in_infos[1]

    def apply(self, cfg, params, ins, ctx):
        idx = ins[0].value.reshape(-1).long()
        stack = torch.stack([a.value for a in ins[1:]], dim=0)  # [N, B, D]
        rows = torch.arange(idx.shape[0], device=idx.device)
        return ins[1].with_value(stack[idx, rows])


@register_layer("eos_id")
class EosIdCheckLayer(LayerImpl):
    """``EosIdCheckLayer.cpp``: 1.0 where the input id equals eos_id."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=1, is_sequence=in_infos[0].is_sequence)

    def apply(self, cfg, params, ins, ctx):
        ids = ins[0].value
        if ids.dim() > 2:
            ids = ids[..., 0]
        out = (ids == cfg.attrs["eos_id"]).to(torch.float32).unsqueeze(-1)
        return Argument(value=out, mask=ins[0].mask)


@register_layer("sampling_id")
class SamplingIdLayer(LayerImpl):
    """``SamplingIdLayer.cpp``: one id a row drawn from the row's
    distribution. The draw is the Gumbel-max of log(max(p, 1e-20)) (JAX's
    ``random.categorical`` on the same logits), its uniforms from a
    ``torch.Generator`` on the value's device seeded by the step's seed
    folded with the layer's name: one seed, one draw. The streams are not
    JAX's, so the ids agree with the JAX package only in distribution."""

    needs_rng = True

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=in_infos[0].size,
                         is_sequence=in_infos[0].is_sequence)

    def apply(self, cfg, params, ins, ctx):
        p = ins[0].value
        logits = torch.log(torch.clamp_min(p, 1e-20))
        gen = torch.Generator(device=p.device)
        gen.manual_seed(ctx.layer_seed(cfg.name))
        u = torch.rand(p.shape, generator=gen, device=p.device,
                       dtype=p.dtype)
        tiny = torch.finfo(p.dtype).tiny
        gumbel = -torch.log(-torch.log(torch.clamp_min(u, tiny)))
        return Argument(value=torch.argmax(logits + gumbel, dim=-1),
                        mask=ins[0].mask)


@register_layer("print")
class PrintLayer(LayerImpl):
    """``PrintLayer.cpp``: prints the input with the layer's name on every
    forward and passes it through unchanged."""

    def infer(self, cfg, in_infos):
        return in_infos[0]

    def apply(self, cfg, params, ins, ctx):
        print(f"{cfg.name}: {ins[0].value.detach().cpu()}", flush=True)
        return ins[0]


@register_layer("resize")
class ResizeLayer(LayerImpl):
    """``ResizeLayer.cpp``: the batch reread as rows of ``size`` (the
    element count kept, the batch dimension changed)."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=cfg.size)

    def apply(self, cfg, params, ins, ctx):
        return Argument(value=ins[0].value.reshape(-1, cfg.size))


@register_layer("rotate")
class RotateLayer(LayerImpl):
    """``RotateLayer.cpp``: each image turned 90 degrees clockwise,
    out[a, b] = in[H-1-b, a]."""

    def infer(self, cfg, in_infos):
        info = in_infos[0]
        return ShapeInfo(size=info.size, channels=info.channels,
                         height=info.width, width=info.height)

    def apply(self, cfg, params, ins, ctx):
        info = ctx.in_infos[0]
        x = to_nhwc(ins[0].value, info.channels, info.height, info.width)
        return Argument(value=torch.flip(x, [1]).transpose(1, 2))


@register_layer("bilinear_interp")
class BilinearInterpLayer(LayerImpl):
    """``BilinearInterpLayer.cpp``: bilinear resize to (out_size_y,
    out_size_x) with half-pixel centres and, when it shrinks, the
    triangle filter widened by the scale (``jax.image.resize``'s
    "bilinear" with its default antialias)."""

    def infer(self, cfg, in_infos):
        info = in_infos[0]
        oh = cfg.attrs["out_size_y"]
        ow = cfg.attrs["out_size_x"]
        return ShapeInfo(size=info.channels * oh * ow, channels=info.channels,
                         height=oh, width=ow)

    def apply(self, cfg, params, ins, ctx):
        info = ctx.in_infos[0]
        x = to_nhwc(ins[0].value, info.channels, info.height, info.width)
        out = F.interpolate(x.permute(0, 3, 1, 2),
                            size=(cfg.attrs["out_size_y"],
                                  cfg.attrs["out_size_x"]),
                            mode="bilinear", align_corners=False,
                            antialias=True)
        return Argument(value=out.permute(0, 2, 3, 1))


def _pairs(cfg):
    return (cfg.attrs.get("pad_c", [0, 0]), cfg.attrs.get("pad_h", [0, 0]),
            cfg.attrs.get("pad_w", [0, 0]))


@register_layer("pad")
class PadLayer(LayerImpl):
    """``PadLayer.cpp``: zero padding along C, H and W by [before, after]
    pairs (``pad_c``, ``pad_h``, ``pad_w``)."""

    def infer(self, cfg, in_infos):
        info = in_infos[0]
        pc, ph, pw = _pairs(cfg)
        c = info.channels + sum(pc)
        h = info.height + sum(ph)
        w = info.width + sum(pw)
        return ShapeInfo(size=c * h * w, channels=c, height=h, width=w)

    def apply(self, cfg, params, ins, ctx):
        info = ctx.in_infos[0]
        x = to_nhwc(ins[0].value, info.channels, info.height, info.width)
        pc, ph, pw = _pairs(cfg)
        return Argument(value=F.pad(x, (*pc, *pw, *ph)))


@register_layer("crop")
class CropLayer(LayerImpl):
    """``CropLayer.cpp``: crop from ``axis`` on (NCHW numbering: 0 batch,
    1 C, 2 H, 3 W) at per-axis offsets, to the second input's geometry or
    the ``shape`` attr."""

    def infer(self, cfg, in_infos):
        info = in_infos[0]
        axis = cfg.attrs.get("axis", 2)
        if len(in_infos) > 1:
            ref = in_infos[1]
            c, h, w = ref.channels, ref.height, ref.width
        else:
            # 4 values: full NCHW (the batch extent ignored); 3: (c, h, w);
            # fewer: the extents of NCHW axes [axis..3]
            shape = list(cfg.attrs["shape"])
            dims = [info.channels, info.height, info.width]
            if len(shape) == 4:
                shape = shape[1:]
            start = 1 if len(shape) == 3 else max(axis, 1)
            for ax, s in zip(range(start, 4), shape):
                dims[ax - 1] = s
            c, h, w = dims
        c = c if axis <= 1 else info.channels
        h = h if axis <= 2 else info.height
        w = w if axis <= 3 else info.width
        return ShapeInfo(size=c * h * w, channels=c, height=h, width=w)

    def apply(self, cfg, params, ins, ctx):
        info = ctx.in_infos[0]
        out = ctx.out_info
        x = to_nhwc(ins[0].value, info.channels, info.height, info.width)
        axis = cfg.attrs.get("axis", 2)
        offs = {ax: off for ax, off in zip(
            range(axis, 4), cfg.attrs.get("offset", [0] * (4 - axis)))}
        oc, oh, ow = offs.get(1, 0), offs.get(2, 0), offs.get(3, 0)
        return Argument(value=x[:, oh:oh + out.height, ow:ow + out.width,
                                oc:oc + out.channels])


@register_layer("conv_shift")
class ConvShiftLayer(LayerImpl):
    """``ConvShiftLayer.cpp``: circular correlation, out[i] = sum_j
    a[(i + j - (M-1)/2) mod N] * b[j], b a row of odd length M."""

    def infer(self, cfg, in_infos):
        return in_infos[0]

    def apply(self, cfg, params, ins, ctx):
        a, b = ins[0].value, ins[1].value
        N, M = a.shape[1], b.shape[1]
        ar = torch.arange(N, device=a.device)
        idx = (ar.unsqueeze(1) + torch.arange(M, device=a.device)
               - (M - 1) // 2) % N
        return ins[0].with_value(torch.einsum("bij,bj->bi", a[:, idx], b))


@register_layer("row_conv")
class RowConvLayer(LayerImpl):
    """``RowConvLayer.cpp``: DeepSpeech2's lookahead row convolution,
    out[t] = sum_{j<k} x[t+j] * w[j] per feature, within each sequence."""

    def infer(self, cfg, in_infos):
        return in_infos[0]

    def params(self, cfg, in_infos):
        return {"w0": ParamSpec(shape=(cfg.attrs["context_length"],
                                       in_infos[0].size))}

    def apply(self, cfg, params, ins, ctx):
        x, mask = ins[0].value, ins[0].mask  # [B, T, D]
        k = cfg.attrs["context_length"]
        w = params["w0"]
        T = x.shape[1]
        xm = x if mask is None else x * mask.unsqueeze(-1)
        xp = F.pad(xm, (0, 0, 0, k - 1))
        out = torch.zeros_like(x)
        for j in range(k):
            out = out + xp[:, j:j + T] * w[j]
        if mask is not None:
            out = out * mask.unsqueeze(-1)
        return Argument(value=out, mask=mask)


@register_layer("tensor")
class TensorLayer(LayerImpl):
    """``TensorLayer.cpp``: the bilinear form out[k] = x W_k y^T, the
    parameter kept [Dx, size * Dy]."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=cfg.size)

    def params(self, cfg, in_infos):
        dx, dy = in_infos[0].size, in_infos[1].size
        specs = {"w0": ParamSpec(shape=(dx, cfg.size * dy),
                                 wire_dims=(dx, dy, cfg.size))}
        if cfg.bias:
            specs["wbias"] = ParamSpec(shape=(cfg.size,), init="zeros",
                                       is_bias=True)
        return specs

    def apply(self, cfg, params, ins, ctx):
        x, y = ins[0].value, ins[1].value
        w = params["w0"].reshape(x.shape[-1], cfg.size, y.shape[-1])
        out = torch.einsum("bi,ikj,bj->bk", x, w, y)
        if "wbias" in params:
            out = out + params["wbias"]
        return Argument(value=out)


@register_layer("selective_fc")
class SelectiveFcLayer(LayerImpl):
    """``SelectiveFullyConnectedLayer.cpp``: an fc whose unselected output
    columns read zero; the selection is the optional second input as a 0/1
    row mask, applied after the activation, which this layer therefore
    applies itself (``active_type``)."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=cfg.size)

    def params(self, cfg, in_infos):
        specs = {"w0": ParamSpec(shape=(in_infos[0].size, cfg.size))}
        if cfg.bias:
            specs["wbias"] = ParamSpec(shape=(cfg.size,), init="zeros",
                                       is_bias=True)
        return specs

    def apply(self, cfg, params, ins, ctx):
        from paddle_tpu_torch.layers.activations import apply_activation
        out = ins[0].value @ params["w0"]
        if "wbias" in params:
            out = out + params["wbias"]
        act = cfg.attrs.get("active_type", "linear")
        if act and act != "linear":
            out = apply_activation(act, out)
        if len(ins) > 1:
            out = out * ins[1].value
        return Argument(value=out)


@register_layer("blockexpand")
class BlockExpandLayer(LayerImpl):
    """``BlockExpandLayer.cpp``: a block window slid over the image, one
    sequence step per block position (im2col as a sequence): ``F.unfold``
    on the NCHW view, features in (C, block_y, block_x) order, positions
    row-major over (out_y, out_x). Every step is real: the mask is all
    ones, padded columns of a batch included, as in the JAX package."""

    def _geom(self, cfg, info):
        bx, by = cfg.attrs["block_x"], cfg.attrs["block_y"]
        sx = cfg.attrs.get("stride_x", 1)
        sy = cfg.attrs.get("stride_y", 1)
        px = cfg.attrs.get("padding_x", 0)
        py = cfg.attrs.get("padding_y", 0)
        return bx, by, sx, sy, px, py

    def infer(self, cfg, in_infos):
        info = in_infos[0]
        bx, by = self._geom(cfg, info)[:2]
        return ShapeInfo(size=info.channels * bx * by, is_sequence=True)

    def apply(self, cfg, params, ins, ctx):
        info = ctx.in_infos[0]
        x = to_nhwc(ins[0].value, info.channels, info.height, info.width)
        bx, by, sx, sy, px, py = self._geom(cfg, info)
        cols = F.unfold(x.permute(0, 3, 1, 2), (by, bx), padding=(py, px),
                        stride=(sy, sx))        # [B, C*by*bx, oh*ow]
        seq = cols.transpose(1, 2)
        return Argument(value=seq, mask=seq.new_ones(seq.shape[:2]))


@register_layer("sub_nested_seq")
class SubNestedSequenceLayer(LayerImpl):
    """``SubNestedSequenceLayer.cpp``: from a nested sequence (a flat
    ``[B, T, D]`` with ``sub_starts_mask``), the sub-sequence the second
    input selects for each row, compacted to the front in its order (a
    stable sort of kept positions first)."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=in_infos[0].size, is_sequence=True)

    def apply(self, cfg, params, ins, ctx):
        a, sel = ins[0], ins[1]
        x, mask, starts = a.value, a.mask, a.sub_starts_mask
        if starts is None:
            raise ValueError("sub_nested_seq input must be a nested sequence")
        idx = sel.value.reshape(-1).long()
        sub_id = torch.cumsum(starts, dim=1) - 1
        keep = (sub_id == idx.unsqueeze(1)) & (mask > 0)
        T = x.shape[1]
        key = (~keep).long() * T + torch.arange(T, device=x.device)
        order = torch.argsort(key, dim=1, stable=True)
        out = torch.gather(x, 1, order.unsqueeze(-1).expand(-1, -1,
                                                            x.shape[-1]))
        new_mask = torch.gather(keep.to(torch.float32), 1, order)
        return Argument(value=out * new_mask.unsqueeze(-1), mask=new_mask)


@register_layer("get_output")
class GetOutputLayer(LayerImpl):
    """Reads a named auxiliary output of the previous layer (the
    reference's ``get_output_layer``, e.g. lstm_step's state)."""

    def infer(self, cfg, in_infos):
        return dataclasses.replace(in_infos[0], size=cfg.size
                                   or in_infos[0].size)

    def apply(self, cfg, params, ins, ctx):
        arg = cfg.attrs.get("arg_name", "state")
        return Argument(value=ins[0].state[arg], mask=ins[0].mask)


@register_layer("featmap_expand")
class FeatureMapExpandLayer(LayerImpl):
    """``FeatureMapExpandLayer.cpp``: the input repeated ``num_filters``
    times along the features, whole (the default) or element by element
    (``user_arg`` "as_col_vec")."""

    def infer(self, cfg, in_infos):
        info = in_infos[0]
        return ShapeInfo(size=info.size * cfg.attrs.get("num_filters", 1),
                         is_sequence=info.is_sequence)

    def apply(self, cfg, params, ins, ctx):
        n = cfg.attrs.get("num_filters", 1)
        x = ins[0].value
        if cfg.attrs.get("user_arg") == "as_col_vec":
            out = x.repeat_interleave(n, dim=-1)
        else:
            out = x.repeat((1,) * (x.dim() - 1) + (n,))
        return ins[0].with_value(out)


@register_layer("row_l2_norm")
class RowL2NormLayer(LayerImpl):
    """``RowL2NormLayer.cpp``: x / ||x||_2 per row."""

    def infer(self, cfg, in_infos):
        return in_infos[0]

    def apply(self, cfg, params, ins, ctx):
        x = ins[0].value
        norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True)) + 1e-12
        return ins[0].with_value(x / norm)


@register_layer("cos_vm")
class CosSimVecMatLayer(LayerImpl):
    """``CosSimVecMatLayer.cpp``: the cosine of input 0's row [B, D] with
    each of the ``size`` rows of input 1 [B, size*D]."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=cfg.size)

    def apply(self, cfg, params, ins, ctx):
        vec, mat = ins[0].value, ins[1].value
        rows = mat.reshape(mat.shape[0], cfg.size, vec.shape[-1])
        scale = cfg.attrs.get("cos_scale", 1.0)
        dot = torch.einsum("bd,bnd->bn", vec, rows)
        denom = (torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
                 * torch.linalg.vector_norm(rows, dim=-1) + 1e-12)
        return Argument(value=scale * dot / denom)


@register_layer("kmax_seq_score")
class KmaxSeqScoreLayer(LayerImpl):
    """``KmaxSeqScoreLayer.cpp``: the time indices of each sequence's
    ``beam_size`` best scores, best first; on ties the lower index first
    (``lax.top_k``'s order), by a stable descending sort."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=cfg.attrs.get("beam_size", 1))

    def apply(self, cfg, params, ins, ctx):
        k = cfg.attrs.get("beam_size", 1)
        scores = ins[0].value
        if scores.dim() == 3:
            scores = scores[..., 0]
        if ins[0].mask is not None:
            scores = torch.where(ins[0].mask > 0, scores,
                                 torch.full((), float("-inf"),
                                            dtype=scores.dtype,
                                            device=scores.device))
        idx = torch.sort(scores, dim=-1, descending=True, stable=True)[1]
        return Argument(value=idx[:, :k])


@register_layer("sum_to_one_norm")
class SumToOneNormLayer(LayerImpl):
    """``SumToOneNormLayer.cpp``: x / sum(x) per row."""

    def infer(self, cfg, in_infos):
        return in_infos[0]

    def apply(self, cfg, params, ins, ctx):
        x = ins[0].value
        return ins[0].with_value(x / (x.sum(dim=-1, keepdim=True) + 1e-12))


@register_layer("convex_comb")
class LinearCombLayer(LayerImpl):
    """``LinearChainCombLayer`` ("convex_comb"): the weights [B, m]
    combine the m rows of input 1 [B, m*size] into [B, size]."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=cfg.size)

    def apply(self, cfg, params, ins, ctx):
        w, v = ins[0].value, ins[1].value
        m = v.shape[-1] // cfg.size
        rows = v.reshape(v.shape[0], m, cfg.size)
        return Argument(value=torch.einsum("bm,bmd->bd", w[:, :m], rows))

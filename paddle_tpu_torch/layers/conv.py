"""Convolution layers: the port of ``paddle_tpu/layers/conv.py``.

The reference's conv family (``ExpandConvLayer``, ``CudnnConvLayer``,
``ExpandConvTransLayer``, depthwise), registered as "exconv"/"cudnn_conv"/
"exconvt". The JAX package computes them with ``lax.conv_general_dilated``
and ``lax.conv_transpose``, which XLA compiles: no Pallas kernel. Here they
are ``F.conv2d`` and ``F.conv_transpose2d`` (cuDNN on the card, with TF32
off where the caller turns it off, as the CLI does).

Layout: values between layers stay NHWC, as in the reference, so every
layer's output can be held against JAX's. A convolution runs on
``x.permute(0, 3, 1, 2)`` (a channels-last view, no copy) and permutes its
result back. Parameters keep the JAX shapes: conv weights HWIO ``(fsy, fs,
c / g, nf)``, permuted to OIHW at apply time. The reference's flat ``[B,
C*H*W]`` channel-major rows are accepted at any image layer and reshaped
once (``to_nhwc``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import (LayerImpl, ParamSpec, ShapeInfo,
                                            register_layer)


def to_nhwc(x: torch.Tensor, channels: int, height: int, width: int):
    """Accept [B, C*H*W] (reference channel-major rows) or [B,H,W,C]."""
    if x.dim() == 2:
        return x.reshape(x.shape[0], channels, height, width).permute(
            0, 2, 3, 1)
    return x


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def conv_transpose_grouped(x, w, *, strides, padding, groups: int = 1):
    """Grouped transposed conv of NHWC ``x``. ``w`` is gradient-of-conv HWIO
    ``(fsy, fs, nf // groups, c)``, the kernel of the forward conv nf -> c
    whose input gradient this computes; ``padding`` (py, px) is the forward
    conv's, so the output is ``(in - 1) * s + fs - 2 p`` (the JAX package
    reaches the same with ``lax.conv_transpose`` and padding fs - 1 - p).
    ``F.conv_transpose2d`` takes (c, nf / g, fsy, fs): input-channel block j
    maps to output block j, as the reference's grouped im2col loop."""
    c = x.shape[-1]
    if c % groups or w.shape[3] != c:
        raise ValueError(
            f"grouped conv-trans: {c} input channels with kernel "
            f"{tuple(w.shape)} over {groups} groups")
    y = F.conv_transpose2d(_nchw(x), w.permute(3, 2, 0, 1), stride=strides,
                           padding=padding, groups=groups)
    return _nhwc(y)


def _conv_geom(in_sz: int, filt: int, pad: int, stride: int) -> int:
    # reference formula, caffe-style (config_parser.cg_image_size)
    return (in_sz + 2 * pad - filt) // stride + 1


def derive_geom(in_info: ShapeInfo, channels=None):
    """(channels, height, width) of an input, deriving image geometry from
    the flat size when the producing layer carried none — the reference's
    config_parser inference: width = isqrt(pixels), height = pixels //
    width, exact factor required."""
    c = channels or in_info.channels
    if in_info.height is not None:
        return c or in_info.channels, in_info.height, in_info.width
    c = c or 1
    pixels = in_info.size // c
    w = math.isqrt(pixels)
    h = pixels // max(w, 1)
    if h * w * c != in_info.size:
        raise ValueError(
            f"cannot infer image geometry from size {in_info.size} with "
            f"{c} channels; set height/width on the data layer")
    return c, h, w


def _conv_spec(inp_extra: dict, in_info: ShapeInfo):
    # *_y keys may be present with value None: treated as absent
    fs = inp_extra["filter_size"]
    fsy = inp_extra.get("filter_size_y") or fs
    st = inp_extra.get("stride", 1)
    sty = inp_extra.get("stride_y") or st
    pad = inp_extra.get("padding", 0)
    pady = inp_extra.get("padding_y")
    pady = pad if pady is None else pady
    groups = inp_extra.get("groups", 1) or 1
    c = inp_extra.get("channels") or in_info.channels
    return fs, fsy, st, sty, pad, pady, groups, c


class _ConvBase(LayerImpl):
    """Shared params/apply of conv and conv-trans: one weight per input
    (summed outputs), an optional bias over the filters."""

    def _weight_shape(self, fs, fsy, c, nf, groups):
        raise NotImplementedError

    def _conv(self, x, w, fs, fsy, st, sty, pad, pady, groups):
        raise NotImplementedError

    def params(self, cfg, in_infos):
        nf = cfg.attrs["num_filters"]
        specs = {}
        for i, info in enumerate(in_infos):
            fs, fsy, _, _, _, _, groups, c = _conv_spec(cfg.inputs[i].extra,
                                                        info)
            c = derive_geom(info, c)[0]
            specs[f"w{i}"] = ParamSpec(
                shape=self._weight_shape(fs, fsy, c, nf, groups),
                wire_dims=())
        if cfg.bias:
            specs["wbias"] = ParamSpec(shape=(nf,), init="zeros",
                                       is_bias=True, wire_dims=(nf, 1))
        return specs

    def apply(self, cfg, params, ins, ctx):
        out = None
        for i, a in enumerate(ins):
            fs, fsy, st, sty, pad, pady, groups, c = _conv_spec(
                cfg.inputs[i].extra, ctx.in_infos[i])
            c, in_h, in_w = derive_geom(ctx.in_infos[i], c)
            x = to_nhwc(a.value, c, in_h, in_w)
            y = self._conv(x, params[f"w{i}"], fs, fsy, st, sty, pad, pady,
                           groups)
            out = y if out is None else out + y
        if "wbias" in params:
            out = out + params["wbias"]
        return Argument(value=out)


@register_layer("exconv", "cudnn_conv", "conv")
class ConvLayer(_ConvBase):
    def infer(self, cfg, in_infos):
        nf = cfg.attrs["num_filters"]
        fs, fsy, st, sty, pad, pady, _, c = _conv_spec(cfg.inputs[0].extra,
                                                       in_infos[0])
        _, in_h, in_w = derive_geom(in_infos[0], c)
        h = _conv_geom(in_h, fsy, pady, sty)
        w = _conv_geom(in_w, fs, pad, st)
        return ShapeInfo(size=nf * h * w, channels=nf, height=h, width=w)

    def _weight_shape(self, fs, fsy, c, nf, groups):
        return (fsy, fs, c // groups, nf)

    def _conv(self, x, w, fs, fsy, st, sty, pad, pady, groups):
        return _nhwc(F.conv2d(_nchw(x), w.permute(3, 2, 0, 1),
                              stride=(sty, st), padding=(pady, pad),
                              groups=groups))


@register_layer("exconvt", "cudnn_convt")
class ConvTransLayer(_ConvBase):
    """Transposed conv (``ExpandConvTransLayer.cpp``); output geometry is the
    conv-geometry inverse, as the reference computes in config_parser."""

    def infer(self, cfg, in_infos):
        nf = cfg.attrs["num_filters"]
        fs, fsy, st, sty, pad, pady, _, c = _conv_spec(cfg.inputs[0].extra,
                                                       in_infos[0])
        _, in_h, in_w = derive_geom(in_infos[0], c)
        h = (in_h - 1) * sty + fsy - 2 * pady
        w = (in_w - 1) * st + fs - 2 * pad
        return ShapeInfo(size=nf * h * w, channels=nf, height=h, width=w)

    def _weight_shape(self, fs, fsy, c, nf, groups):
        # gradient-of-conv layout: a conv from nf -> c
        return (fsy, fs, nf // groups, c)

    def _conv(self, x, w, fs, fsy, st, sty, pad, pady, groups):
        return conv_transpose_grouped(x, w, strides=(sty, st),
                                      padding=(pady, pad), groups=groups)

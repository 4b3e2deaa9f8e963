"""Spatial pooling layers: the port of ``paddle_tpu/layers/pool.py``
(``PoolLayer.cpp``, ``PoolProjectionLayer``, SPP).

The JAX package pools with ``lax.reduce_window`` (XLA, no Pallas kernel);
here with ``F.max_pool2d`` / ``F.avg_pool2d`` on an explicitly padded NCHW
view. Torch's own ``ceil_mode`` is not used: it drops a last window that
starts in the padding and caps the padding at k / 2, where the reference
pads bottom/right up to what its ceil-mode geometry needs. So the pads are
explicit: -inf for max, 0 for avg, and the avg divides each window's sum by
its count of real pixels (a ones map padded with 0, clamped at >= 1). SPP's
avg divides by the window's full area, padding included, as the reference
does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import LayerImpl, ShapeInfo, register_layer
from paddle_tpu_torch.layers.conv import derive_geom, to_nhwc


def _pool_geom(in_sz: int, filt: int, pad: int, stride: int) -> int:
    # reference uses caffe ceil mode for pool output (config_parser)
    return max(1, int(math.ceil((in_sz + 2 * pad - filt) / float(stride))) + 1)


def _spec(extra, info):
    fs = extra.get("size_x") or extra["filter_size"]
    fsy = extra.get("size_y", fs)
    st = extra.get("stride", 1)
    sty = extra.get("stride_y", st)
    pad = extra.get("padding", 0)
    pady = extra.get("padding_y", pad)
    c = extra.get("channels") or info.channels
    return fs, fsy, st, sty, pad, pady, c


def _window_sum(x, kernel, stride):
    """Sum over each window of NCHW ``x`` (no padding of its own)."""
    return F.avg_pool2d(x, kernel, stride, divisor_override=1)


@register_layer("pool", "cudnn_pool")
class PoolLayer(LayerImpl):
    def infer(self, cfg, in_infos):
        fs, fsy, st, sty, pad, pady, c = _spec(cfg.inputs[0].extra,
                                               in_infos[0])
        if in_infos[0].height is None:
            # flat input (e.g. pooling an fc output): derive square geometry
            # like the reference's config_parser does
            c, in_h, in_w = derive_geom(in_infos[0], c)
            in_infos = [dataclasses.replace(in_infos[0], channels=c,
                                            height=in_h, width=in_w)]
            cfg.inputs[0].extra.setdefault("channels", c)
        h = _pool_geom(in_infos[0].height, fsy, pady, sty)
        w = _pool_geom(in_infos[0].width, fs, pad, st)
        return ShapeInfo(size=c * h * w, channels=c, height=h, width=w)

    def apply(self, cfg, params, ins, ctx):
        info = ctx.in_infos[0]
        fs, fsy, st, sty, pad, pady, c = _spec(cfg.inputs[0].extra, info)
        if info.height is None:
            c, in_h, in_w = derive_geom(info, c)
            info = dataclasses.replace(info, channels=c, height=in_h,
                                       width=in_w)
        ptype = cfg.inputs[0].extra.get("pool_type", "max-projection")
        x = to_nhwc(ins[0].value, c, info.height, info.width)
        oh, ow = ctx.out_info.height, ctx.out_info.width
        # pad so that ceil-mode windows fit: right/bottom pad up to need
        need_h = (oh - 1) * sty + fsy - info.height
        need_w = (ow - 1) * st + fs - info.width
        pads = (pad, max(need_w - pad, 0), pady, max(need_h - pady, 0))
        xc = x.permute(0, 3, 1, 2)
        if "max" in ptype:
            y = F.max_pool2d(F.pad(xc, pads, value=-math.inf), (fsy, fs),
                             (sty, st))
        else:
            y = _window_sum(F.pad(xc, pads), (fsy, fs), (sty, st))
            # reference avg pool divides by window size excluding padding
            ones = xc.new_ones((1, 1, info.height, info.width))
            cnt = _window_sum(F.pad(ones, pads), (fsy, fs), (sty, st))
            y = y / torch.clamp_min(cnt, 1.0)
        return Argument(value=y.permute(0, 2, 3, 1))


@register_layer("spp")
class SppLayer(LayerImpl):
    """Spatial pyramid pooling (``SpatialPyramidPoolLayer.cpp``): concat of
    pyramid_height levels of adaptive max/avg pooling, flattened."""

    def _geom(self, cfg, info):
        c = cfg.attrs.get("channels") or info.channels
        if info.height is not None:
            return c, info.height, info.width
        return derive_geom(info, c)

    def infer(self, cfg, in_infos):
        c, _, _ = self._geom(cfg, in_infos[0])
        levels = cfg.attrs.get("pyramid_height", 3)
        bins = sum(4 ** l for l in range(levels))
        return ShapeInfo(size=c * bins)

    def apply(self, cfg, params, ins, ctx):
        c, h, w = self._geom(cfg, ctx.in_infos[0])
        xc = to_nhwc(ins[0].value, c, h, w).permute(0, 3, 1, 2)
        levels = cfg.attrs.get("pyramid_height", 3)
        ptype = cfg.attrs.get("pool_type", "max-projection")
        outs = []
        for l in range(levels):
            n = 2 ** l
            fh, fw = -(-h // n), -(-w // n)
            pads = (0, fw * n - w, 0, fh * n - h)
            if "max" in ptype:
                y = F.max_pool2d(F.pad(xc, pads, value=-math.inf), (fh, fw),
                                 (fh, fw))
            else:
                y = _window_sum(F.pad(xc, pads), (fh, fw),
                                (fh, fw)) / (fh * fw)
            outs.append(y.permute(0, 2, 3, 1).reshape(y.shape[0], -1))
        return Argument(value=torch.cat(outs, dim=-1))

"""Normalization layers: the port of ``paddle_tpu/layers/norm.py``.

``batch_norm`` (``BatchNormalizationLayer``/``CudnnBatchNormLayer``):
scale and shift per channel, batch statistics in training, moving
statistics at test. The moving mean and variance are two static entries of
the parameter dict (``w1``, ``w2``); a training apply records their EMA
update in ``ctx.state_updates`` under the parameters' names, and the train
step folds them in after the optimizer's update.

``norm`` (cmrnorm-projection): AlexNet-style local response normalization
across channel windows.

Plain tensor code: the JAX package computes both with ``jnp`` and
``lax.reduce_window`` (XLA, no Pallas kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import (LayerImpl, ParamSpec,
                                            register_layer)
from paddle_tpu_torch.layers.conv import to_nhwc


@register_layer("batch_norm", "cudnn_batch_norm", "batch_normalization")
class BatchNormLayer(LayerImpl):
    def infer(self, cfg, in_infos):
        return in_infos[0]

    def params(self, cfg, in_infos):
        c = in_infos[0].channels or in_infos[0].size
        return {
            "w0": ParamSpec(shape=(c,), init="const", initial_mean=1.0,
                            initial_std=0.0, wire_dims=()),
            "wbias": ParamSpec(shape=(c,), init="zeros", is_bias=True),
            "w1": ParamSpec(shape=(c,), init="zeros", is_static=True),
            # moving variance starts at 0 like the reference (the epsilon
            # in the denominator keeps the rsqrt finite)
            "w2": ParamSpec(shape=(c,), init="zeros", is_static=True),
        }

    def apply(self, cfg, params, ins, ctx):
        info = ctx.in_infos[0]
        eps = cfg.attrs.get("epsilon", 1e-5)
        momentum = cfg.attrs.get("moving_average_fraction", 0.9)
        use_global = cfg.attrs.get("use_global_stats", None)
        x = (to_nhwc(ins[0].value, info.channels, info.height, info.width)
             if info.channels is not None else ins[0].value)
        # every axis but the channel (a sequence's padded rows included)
        axes = tuple(range(x.dim() - 1))
        if use_global is None:
            use_global = not ctx.train
        if use_global:
            mean, var = params["w1"], params["w2"]
        else:
            mean = torch.mean(x, dim=axes)
            var = torch.mean(torch.square(x - mean), dim=axes)
        y = ((x - mean) * torch.rsqrt(var + eps) * params["w0"]
             + params["wbias"])
        if ctx.train and not use_global:
            ctx.state_updates[f"_{cfg.name}.w1"] = (
                momentum * params["w1"] + (1.0 - momentum) * mean)
            ctx.state_updates[f"_{cfg.name}.w2"] = (
                momentum * params["w2"] + (1.0 - momentum) * var)
        return Argument(value=y, mask=ins[0].mask)


@register_layer("norm", "cmrnorm-projection")
class CrossMapNormLayer(LayerImpl):
    """Local response normalization across a window of ``size`` channels:
    out = x * (1 + scale / size * sum_{window} x^2) ^ -pow, the window
    padded (size // 2, size - 1 - size // 2) (``CrossMapNormalOp.cpp``; the
    reference folds / size into the stored scale at config time)."""

    def infer(self, cfg, in_infos):
        return in_infos[0]

    def apply(self, cfg, params, ins, ctx):
        info = ctx.in_infos[0]
        extra = cfg.inputs[0].extra
        size = extra.get("size", 5)
        alpha = extra.get("scale", 1e-4)
        beta = extra.get("pow", 0.75)
        x = to_nhwc(ins[0].value, info.channels, info.height, info.width)
        half = size // 2
        sq = F.pad(torch.square(x), (half, size - 1 - half))
        acc = sq.unfold(-1, size, 1).sum(dim=-1)
        scale = torch.pow(1.0 + (alpha / size) * acc, -beta)
        return Argument(value=x * scale, mask=ins[0].mask)

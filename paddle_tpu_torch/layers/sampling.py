"""Sampled and hierarchical output layers: NCE, the hierarchical sigmoid
and the Gaussian sample (``NCELayer.cpp``, ``HierarchicalSigmoidLayer.cpp``;
the VAE's reparameterised sample). The port's counterpart of
``paddle_tpu/layers/sampling.py``: plain tensor code, differentiated by
autograd.

The random draws (nce's training negatives, ``sample_gaussian``'s ε) come
from a ``torch.Generator`` on the value's device, seeded by the layer's
seed (``Context.layer_seed``), each through one module-level helper
(``_nce_negatives``, ``_gaussian_eps``), as dropout's mask comes from
``core/network.py:_dropout_mask``. The same seed gives the same draw on a
device; a CUDA and a CPU generator with the same seed draw different
numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import (LayerImpl, ParamSpec, ShapeInfo,
                                            register_layer)


def _generator(ctx, name: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(ctx.layer_seed(name))
    return gen


def _nce_negatives(shape, num_classes: int, ctx, name: str,
                   device) -> torch.Tensor:
    """[B, K] int64 noise classes of layer ``name``'s training step, drawn
    uniformly from [0, num_classes)."""
    return torch.randint(0, num_classes, shape,
                         generator=_generator(ctx, name, device),
                         device=device)


def _gaussian_eps(shape, dtype, ctx, name: str, device) -> torch.Tensor:
    """Standard normal ε of layer ``name``'s training step."""
    return torch.randn(shape, generator=_generator(ctx, name, device),
                       dtype=dtype, device=device)


@register_layer("nce")
class NCELayer(LayerImpl):
    """Noise-contrastive estimation cost: per sample, the true class and
    ``num_neg_samples`` noise classes (uniform, drawn in training; strided
    through the classes at evaluation) scored by the NCE logistic loss
    with P_n = 1 / num_classes. Inputs (features, label[, weight])."""

    needs_rng = True

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=1)

    def params(self, cfg, in_infos):
        num_classes = cfg.attrs["num_classes"]
        specs = {"w0": ParamSpec(shape=(num_classes, in_infos[0].size))}
        if cfg.bias:
            specs["wbias"] = ParamSpec(shape=(num_classes,), init="zeros",
                                       is_bias=True)
        return specs

    def apply(self, cfg, params, ins, ctx):
        x = ins[0].value
        label = ins[1].value.reshape(-1).long()
        num_classes = cfg.attrs["num_classes"]
        K = cfg.attrs.get("num_neg_samples", 10)
        B = x.shape[0]
        if ctx.train:
            neg = _nce_negatives((B, K), num_classes, ctx, cfg.name,
                                 x.device).to(label.device)
        else:
            stride = (num_classes - 1) // max(K, 1) or 1
            neg = (label.unsqueeze(1) + 1 + torch.arange(
                K, device=label.device).unsqueeze(0) * stride) % num_classes
        ids = torch.cat([label.unsqueeze(1), neg], dim=1)   # [B, 1 + K]
        w = params["w0"][ids]                                # [B, 1 + K, D]
        logits = torch.einsum("bkd,bd->bk", w, x)
        if "wbias" in params:
            logits = logits + params["wbias"][ids]
        # uniform noise: log(K · P_n), in float32 as JAX computes it
        log_kpn = torch.log(torch.tensor(float(K)) / num_classes)
        delta = logits - log_kpn.to(logits.device)
        cost = -(F.logsigmoid(delta[:, 0])
                 + F.logsigmoid(-delta[:, 1:]).sum(dim=1))
        if len(ins) > 2:
            cost = cost * ins[2].value.reshape(-1)
        return Argument(value=cost.unsqueeze(1))


@register_layer("hsigmoid")
class HierarchicalSigmoidLayer(LayerImpl):
    """Hierarchical sigmoid over a complete binary tree of num_classes − 1
    internal nodes: the path to class c follows the bits of
    c + num_classes from the root; cost = −Σ log σ(sign · (w_node · x +
    b_node)). The inputs before the label are concatenated."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=1)

    def params(self, cfg, in_infos):
        num_classes = cfg.attrs["num_classes"]
        feat = sum(i.size for i in in_infos[:-1])
        specs = {"w0": ParamSpec(shape=(num_classes - 1, feat))}
        if cfg.bias:
            specs["wbias"] = ParamSpec(shape=(num_classes - 1,), init="zeros",
                                       is_bias=True)
        return specs

    def apply(self, cfg, params, ins, ctx):
        num_classes = cfg.attrs["num_classes"]
        x = torch.cat([a.value for a in ins[:-1]], dim=-1)
        label = ins[-1].value.reshape(-1).long()
        depth = max((num_classes - 1).bit_length(), 1)
        code = label + num_classes
        cost = x.new_zeros(label.shape)
        w, b = params["w0"], params.get("wbias")
        for d in range(depth, 0, -1):
            node = code >> d
            node_idx = torch.clamp(node - 1, 0, num_classes - 2)
            bit = (code >> (d - 1)) & 1       # 0 = left, 1 = right
            score = torch.einsum("bd,bd->b", w[node_idx], x)
            if b is not None:
                score = score + b[node_idx]
            sign = 1.0 - 2.0 * bit.to(x.dtype)
            step = -F.logsigmoid(sign * score)
            cost = cost + torch.where(node >= 1, step, torch.zeros_like(step))
        return Argument(value=cost.unsqueeze(1))


@register_layer("sample_gaussian")
class SampleGaussianLayer(LayerImpl):
    """The reparameterised Gaussian sample: inputs (mu, logvar) →
    mu + ε · exp(logvar / 2) in training, mu at evaluation."""

    needs_rng = True

    def infer(self, cfg, in_infos):
        return in_infos[0]

    def apply(self, cfg, params, ins, ctx):
        mu, logvar = ins[0].value, ins[1].value
        if not ctx.train:
            return ins[0].with_value(mu)
        eps = _gaussian_eps(mu.shape, mu.dtype, ctx, cfg.name, mu.device)
        return ins[0].with_value(mu + eps * torch.exp(0.5 * logvar))

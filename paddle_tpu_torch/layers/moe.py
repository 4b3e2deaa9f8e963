"""The ``moe`` layer type (``paddle_tpu/layers/moe.py``): a top-1
mixture-of-experts FFN over the feature dim whose parameters live in the
ordinary parameter table, computed by ``parallel/moe.py:moe_ffn``. Padded
positions claim no capacity slot, so the live tokens' outputs do not
depend on the padding; the capacity defaults to the token count."""

from __future__ import annotations

from typing import Dict

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import (LayerImpl, ParamSpec, ShapeInfo,
                                            register_layer)
from paddle_tpu_torch.parallel.moe import moe_ffn


@register_layer("moe")
class MoELayer(LayerImpl):
    """Top-1 MoE FFN; output size = input size. Tokens over an expert's
    capacity pass with a zero expert contribution."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=in_infos[0].size,
                         is_sequence=in_infos[0].is_sequence)

    def params(self, cfg, in_infos) -> Dict[str, ParamSpec]:
        d = in_infos[0].size
        e = int(cfg.attrs["num_experts"])
        h = int(cfg.attrs["expert_hidden"])
        return {
            "wg": ParamSpec(shape=(d, e)),
            "w1": ParamSpec(shape=(e, d, h)),
            "b1": ParamSpec(shape=(e, h), init="zeros", is_bias=True),
            "w2": ParamSpec(shape=(e, h, d)),
            "b2": ParamSpec(shape=(e, d), init="zeros", is_bias=True),
        }

    def apply(self, cfg, params, ins, ctx):
        a = ins[0]
        shape = a.value.shape
        flat = a.value.reshape(-1, shape[-1])
        cap = int(cfg.attrs.get("capacity") or flat.shape[0])
        live = a.mask.reshape(-1) if a.mask is not None else None
        y = moe_ffn(params, flat, cap, live=live)
        return Argument(value=y.reshape(shape), mask=a.mask)

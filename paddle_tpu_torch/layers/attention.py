"""The multi-head attention layer: the port of
``paddle_tpu/layers/attention.py`` (a capability-add over the reference,
whose only attention is the composite ``simple_attention``).

``multi_head_attention``: inputs (query[, key_value]); self-attention when
only the query is given. Heads live in one [in, S] projection per q/k/v
plus an output projection [S, S] and an optional bias, under JAX's names
(``_<layer>.wq``, ``.wk``, ``.wv``, ``.wo``, ``.wbias``); the
scaled-dot-product core is ``ops/attention.py:flash_attention`` (the CUDA
flash kernels on the card), with the kv mask taken from the key/value
Argument and optional causal masking. The projections stay
``torch.matmul``, as JAX leaves them to XLA.

``seq_parallel="ring"|"ulysses"`` shards the time axis over a sequence
mesh in JAX (``paddle_tpu/parallel/ring.py``). The port has no mesh yet,
so the layer always takes JAX's no-mesh branch: the same math, dense, on
one card.
"""

from __future__ import annotations

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import (LayerImpl, ParamSpec, ShapeInfo,
                                            register_layer)
from paddle_tpu_torch.ops.attention import flash_attention


@register_layer("multi_head_attention")
class MultiHeadAttentionLayer(LayerImpl):
    def infer(self, cfg, in_infos):
        size = cfg.size or in_infos[0].size
        assert size % int(cfg.attrs.get("num_heads", 1)) == 0, (
            "size must be divisible by num_heads")
        return ShapeInfo(size=size, is_sequence=True)

    def params(self, cfg, in_infos):
        size = cfg.size or in_infos[0].size
        q_in = in_infos[0].size
        kv_in = in_infos[-1].size  # == q_in for self-attention
        specs = {
            "wq": ParamSpec(shape=(q_in, size)),
            "wk": ParamSpec(shape=(kv_in, size)),
            "wv": ParamSpec(shape=(kv_in, size)),
            "wo": ParamSpec(shape=(size, size)),
        }
        if cfg.bias:
            specs["wbias"] = ParamSpec(shape=(size,), init="zeros",
                                       is_bias=True)
        return specs

    def apply(self, cfg, params, ins, ctx):
        q_arg = ins[0]
        kv_arg = ins[-1]
        size = ctx.out_info.size
        heads = int(cfg.attrs.get("num_heads", 1))
        causal = bool(cfg.attrs.get("causal", False))
        hd = size // heads

        def split(x):  # [B,T,S] -> [B,N,T,hd], a strided view
            B, T, _ = x.shape
            return x.reshape(B, T, heads, hd).transpose(1, 2)

        q = split(q_arg.value @ params["wq"])
        k = split(kv_arg.value @ params["wk"])
        v = split(kv_arg.value @ params["wv"])
        # no sequence mesh in the port: JAX's no-mesh branch, dense
        out = flash_attention(q, k, v, kv_arg.mask, causal=causal)
        B, N, T, _ = out.shape
        out = out.transpose(1, 2).reshape(B, T, size) @ params["wo"]
        if "wbias" in params:
            out = out + params["wbias"]
        if q_arg.mask is not None:
            out = out * q_arg.mask[..., None]
        return Argument(value=out, mask=q_arg.mask)

"""Recurrent layers: lstmemory (``LstmLayer.cpp``).

The port's counterpart of ``paddle_tpu/layers/recurrent.py:LstmLayer``.
The incoming projection supplies 4 gate blocks in order [input,
input_gate, forget_gate, output_gate]; the recurrent weight is [size,
4*size]; the bias parameter is 7*size = 4 gate biases + 3 peephole
diagonals (checkI/F/O). Default activations take the fused recurrence
(``ops/lstm.py``: the CUDA kernel on the card); other activations take an
inline step in plain torch. Padded steps hold the carried state.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import (LayerImpl, ParamSpec, ShapeInfo,
                                            register_layer)
from paddle_tpu_torch.layers.activations import apply_activation
from paddle_tpu_torch.ops.lstm import lstm_sequence


@register_layer("lstmemory")
class LstmLayer(LayerImpl):
    def infer(self, cfg, in_infos):
        if in_infos[0].size % 4:
            raise ValueError("lstmemory input must be 4*size")
        return ShapeInfo(size=in_infos[0].size // 4, is_sequence=True)

    def params(self, cfg, in_infos):
        size = in_infos[0].size // 4
        specs = {"w0": ParamSpec(shape=(size, 4 * size),
                                 wire_dims=(size, size, 4))}
        if cfg.bias:
            specs["wbias"] = ParamSpec(shape=(7 * size,), init="zeros",
                                       is_bias=True)
        return specs

    def apply(self, cfg, params, ins, ctx):
        a = ins[0]
        size = ctx.out_info.size
        act_in = cfg.attrs.get("active_type", "tanh") or "tanh"
        act_gate = cfg.attrs.get("active_gate_type", "sigmoid") or "tanh"
        act_state = cfg.attrs.get("active_state_type", "tanh") or "tanh"
        reverse = bool(cfg.attrs.get("reversed", False))
        w = params["w0"]
        if "wbias" in params:
            gate_bias, check_i, check_f, check_o = params["wbias"].split(
                [4 * size, size, size, size])
        else:
            gate_bias = a.value.new_zeros(4 * size)
            check_i = check_f = check_o = a.value.new_zeros(size)

        B = a.value.shape[0]
        xs = a.value.transpose(0, 1)   # [T, B, 4*size]
        mask = a.mask.transpose(0, 1)  # [T, B]
        carried = None if reverse else ctx.carried.get(cfg.name)
        if carried is None:
            z = a.value.new_zeros(B, size)
            carried = (z, z)
        h0, c0 = carried

        if (act_in, act_gate, act_state) == ("tanh", "sigmoid", "tanh"):
            ys, hT, cT = lstm_sequence(xs, mask, w, gate_bias, check_i,
                                       check_f, check_o, h0, c0,
                                       reverse=reverse)
            return Argument(value=ys.transpose(0, 1), mask=a.mask,
                            state=(hT, cT))

        # inline step for non-default activations (plain torch; the cell
        # kernels of paddle_tpu/kernels/rnn_cells.py are not ported yet)
        h, c = h0, c0
        ys = [None] * xs.shape[0]
        steps = range(xs.shape[0] - 1, -1, -1) if reverse \
            else range(xs.shape[0])
        for t in steps:
            gates = xs[t] + h @ w + gate_bias
            g_in, g_ig, g_fg, g_og = gates.chunk(4, dim=-1)
            g_in = apply_activation(act_in, g_in)
            g_ig = apply_activation(act_gate, g_ig + c * check_i)
            g_fg = apply_activation(act_gate, g_fg + c * check_f)
            state = g_in * g_ig + c * g_fg
            g_og = apply_activation(act_gate, g_og + state * check_o)
            out = g_og * apply_activation(act_state, state)
            m = mask[t].unsqueeze(-1)
            h = torch.where(m > 0, out, h)
            c = torch.where(m > 0, state, c)
            ys[t] = out * m
        value = (torch.stack(ys, dim=1) if ys
                 else a.value.new_zeros(B, 0, size))
        return Argument(value=value, mask=a.mask, state=(h, c))

"""Recurrent layers: lstmemory (``LstmLayer.cpp``), gated_recurrent
(``GruLayer.cpp``), the simple recurrence (``RecurrentLayer.cpp``), the
single steps gru_step (``GruStepLayer.cpp``) and lstm_step
(``LstmStepLayer.cpp``), and the 2-D LSTM mdlstmemory
(``MDLstmLayer.cpp``): the port of ``paddle_tpu/layers/recurrent.py``.

- LSTM: the incoming projection supplies 4 gate blocks in order [input,
  input_gate, forget_gate, output_gate]; the recurrent weight is [size,
  4*size]; the bias parameter is 7*size = 4 gate biases + 3 peephole
  diagonals (checkI/F/O).
- GRU: gate blocks [update z, reset r, candidate c]; one [size, 3*size]
  parameter holds the gate weight (its first 2*size columns) and the state
  weight (the last size columns); the bias is 3*size.

Default activations take the fused recurrences (``ops/lstm.py``,
``ops/gru.py``: the CUDA kernels on the card) and the fused GRU and LSTM
cells (``kernels/rnn_cells.py``); other activations take an inline step in
plain torch. Padded steps hold the carried state.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import (LayerImpl, ParamSpec, ShapeInfo,
                                            register_layer)
from paddle_tpu_torch.kernels.rnn_cells import (activation, gru_cell,
                                                gru_cell_infer, gru_math,
                                                lstm_cell, lstm_cell_infer,
                                                lstm_math)
from paddle_tpu_torch.layers.conv import to_nhwc
from paddle_tpu_torch.ops.gru import gru_sequence
from paddle_tpu_torch.ops.lstm import lstm_sequence
from paddle_tpu_torch.utils.precision import matmul


def _steps(T: int, reverse: bool):
    return range(T - 1, -1, -1) if reverse else range(T)


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
        # a carried state enters at the input's dtype, as the zeros it
        # stands for (the trainer keeps it in f32)
        h0, c0 = (s.to(a.value.dtype) for s in carried)

        if (act_in, act_gate, act_state) == ("tanh", "sigmoid", "tanh"):
            ys, hT, cT = lstm_sequence(xs, mask, w, gate_bias, check_i,
                                       check_f, check_o, h0, c0,
                                       reverse=reverse)
            return Argument(value=ys.transpose(0, 1), mask=a.mask,
                            state=(hT, cT))

        # inline step for non-default activations (plain torch)
        h, c = h0, c0
        ys = [None] * xs.shape[0]
        acts = [activation(a) for a in (act_in, act_gate, act_state)]
        for t in _steps(xs.shape[0], reverse):
            out, state = lstm_math(xs[t] + matmul(h, w) + gate_bias, c,
                                   check_i, check_f, check_o, *acts)
            m = mask[t].unsqueeze(-1)
            h = torch.where(m > 0, out, h)
            c = torch.where(m > 0, state, c)
            ys[t] = out * m
        value = (torch.stack(ys, dim=1) if ys
                 else a.value.new_zeros(B, 0, size))
        return Argument(value=value, mask=a.mask, state=(h, c))


@register_layer("gated_recurrent")
class GruLayer(LayerImpl):
    def infer(self, cfg, in_infos):
        if in_infos[0].size % 3:
            raise ValueError("gated_recurrent input must be 3*size")
        return ShapeInfo(size=in_infos[0].size // 3, is_sequence=True)

    def params(self, cfg, in_infos):
        size = in_infos[0].size // 3
        specs = {"w0": ParamSpec(shape=(size, 3 * size))}
        if cfg.bias:
            specs["wbias"] = ParamSpec(shape=(3 * size,), init="zeros",
                                       is_bias=True)
        return specs

    def apply(self, cfg, params, ins, ctx):
        a = ins[0]
        size = ctx.out_info.size
        act_in = cfg.attrs.get("active_type", "tanh")
        act_gate = cfg.attrs.get("active_gate_type", "sigmoid")
        reverse = bool(cfg.attrs.get("reversed", False))
        w_gate = params["w0"][:, :2 * size]   # [size, 2*size] for z, r
        w_state = params["w0"][:, 2 * size:]  # [size, size] for candidate
        bias = (params["wbias"] if "wbias" in params
                else a.value.new_zeros(3 * size))
        B = a.value.shape[0]
        xs = a.value.transpose(0, 1)   # [T, B, 3*size]
        mask = a.mask.transpose(0, 1)  # [T, B]
        carried = None if reverse else ctx.carried.get(cfg.name)
        h = (carried.to(a.value.dtype) if carried is not None
             else a.value.new_zeros(B, size))

        if act_in in ("tanh", "") and act_gate == "sigmoid":
            ys, hT = gru_sequence(xs, mask, w_gate, w_state, bias, h,
                                  reverse=reverse)
            return Argument(value=ys.transpose(0, 1), mask=a.mask, state=hT)

        # inline step for non-default activations
        ys = [None] * xs.shape[0]
        act_in, act_gate = activation(act_in), activation(act_gate)
        for t in _steps(xs.shape[0], reverse):
            out = gru_math(xs[t] + bias, h, w_gate, w_state, act_in,
                           act_gate)
            m = mask[t].unsqueeze(-1)
            h = torch.where(m > 0, out, h)
            ys[t] = out * m
        value = (torch.stack(ys, dim=1) if ys
                 else a.value.new_zeros(B, 0, size))
        return Argument(value=value, mask=a.mask, state=h)


@register_layer("recurrent")
class SimpleRecurrentLayer(LayerImpl):
    """The Elman recurrence out_t = act(x_t + out_{t-1} W + b)
    (``RecurrentLayer.cpp``): the activation (``active_type``) runs inside
    the step loop, so the layer's own ``act`` is linear. No kernel: the
    JAX package runs it as a ``lax.scan``, the port as this loop of plain
    torch ops. h0 is the carried state (``prev_batch_state``) of a forward
    layer, zeros otherwise."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=in_infos[0].size, is_sequence=True)

    def params(self, cfg, in_infos):
        size = in_infos[0].size
        specs = {"w0": ParamSpec(shape=(size, size))}
        if cfg.bias:
            specs["wbias"] = ParamSpec(shape=(size,), init="zeros",
                                       is_bias=True)
        return specs

    def apply(self, cfg, params, ins, ctx):
        a = ins[0]
        act = activation(cfg.attrs.get("active_type", cfg.act or "tanh"))
        reverse = bool(cfg.attrs.get("reversed", False))
        w = params["w0"]
        B, T, D = a.value.shape
        b = params.get("wbias", 0.0)
        xs = a.value.transpose(0, 1)
        mask = a.mask.transpose(0, 1)
        carried = None if reverse else ctx.carried.get(cfg.name)
        h = (carried.to(a.value.dtype) if carried is not None
             else a.value.new_zeros(B, D))
        ys = [None] * T
        for t in _steps(T, reverse):
            out = act(xs[t] + matmul(h, w) + b)
            m = mask[t].unsqueeze(-1)
            h = torch.where(m > 0, out, h)
            ys[t] = out * m
        value = torch.stack(ys, dim=1) if ys else a.value.new_zeros(B, 0, D)
        return Argument(value=value, mask=a.mask, state=h)


@register_layer("gru_step")
class GruStepLayer(LayerImpl):
    """Single GRU step for use inside recurrent groups: inputs = (gate
    projection x [B, 3*size], previous output [B, size]); the recurrent
    weight lives here. Training runs ``gru_cell`` (differentiable), the
    no-grad forward ``gru_cell_infer``."""

    def infer(self, cfg, in_infos):
        if in_infos[0].size % 3:
            raise ValueError("gru_step input must be 3*size")
        return ShapeInfo(size=in_infos[0].size // 3)

    def params(self, cfg, in_infos):
        size = in_infos[0].size // 3
        specs = {"w0": ParamSpec(shape=(size, 3 * size))}
        if cfg.bias:
            specs["wbias"] = ParamSpec(shape=(3 * size,), init="zeros",
                                       is_bias=True)
        return specs

    def apply(self, cfg, params, ins, ctx):
        x, h = ins[0].value, ins[1].value
        size = ctx.out_info.size
        if "wbias" in params:
            x = x + params["wbias"]
        cell = gru_cell if ctx.train else gru_cell_infer
        return Argument(value=cell(
            x, h, params["w0"][:, :2 * size], params["w0"][:, 2 * size:],
            cfg.attrs.get("active_type", "tanh"),
            cfg.attrs.get("active_gate_type", "sigmoid")))


@register_layer("lstm_step")
class LstmStepLayer(LayerImpl):
    """Single LSTM step for use inside recurrent groups: inputs = (the
    combined gate input [B, 4*size], whose recurrent projection is an fc
    over the output memory, and the previous cell state [B, size]).
    Outputs the hidden value; the new cell state is ``state["state"]``,
    read by ``get_output(arg_name="state")``. Training runs ``lstm_cell``
    (differentiable), the no-grad forward ``lstm_cell_infer``."""

    def infer(self, cfg, in_infos):
        if in_infos[0].size % 4:
            raise ValueError("lstm_step input must be 4*size")
        return ShapeInfo(size=in_infos[0].size // 4)

    def params(self, cfg, in_infos):
        size = in_infos[0].size // 4
        if cfg.bias:
            # the reference lstm_step bias is ONLY the three peephole
            # vectors (create_bias_parameter(bias, size * 3)); gate biases
            # belong to the input projection layer
            return {"wbias": ParamSpec(shape=(3 * size,), init="zeros",
                                       is_bias=True)}
        return {}

    def apply(self, cfg, params, ins, ctx):
        gates, c_prev = ins[0].value, ins[1].value
        size = ctx.out_info.size
        if "wbias" in params:
            check_i, check_f, check_o = params["wbias"].split(size)
        else:
            check_i = check_f = check_o = gates.new_zeros(size)
        cell = lstm_cell if ctx.train else lstm_cell_infer
        out, state = cell(gates, c_prev, check_i, check_f, check_o,
                          cfg.attrs.get("active_type", "tanh"),
                          cfg.attrs.get("active_gate_type", "sigmoid"),
                          cfg.attrs.get("active_state_type", "tanh"))
        return Argument(value=out, state={"state": state})


@register_layer("mdlstmemory")
class MDLstmLayer(LayerImpl):
    """The 2-D LSTM (``MDLstmLayer.cpp``): cell (i, j) sees its neighbours
    (i-1, j) and (i, j-1), with one forget gate per direction. The input
    is an image of gate projections, 5*size channels (in, ig, fg_h, fg_w,
    og). Rows in an outer loop, columns in an inner one, as the JAX
    package's nested scans."""

    def infer(self, cfg, in_infos):
        info = in_infos[0]
        if info.channels % 5:
            raise ValueError("mdlstmemory input must have 5*size channels")
        size = info.channels // 5
        return ShapeInfo(size=size * info.height * info.width, channels=size,
                         height=info.height, width=info.width)

    def params(self, cfg, in_infos):
        size = in_infos[0].channels // 5
        specs = {"w0": ParamSpec(shape=(2, size, 5 * size))}
        if cfg.bias:
            specs["wbias"] = ParamSpec(shape=(5 * size,), init="zeros",
                                       is_bias=True)
        return specs

    def apply(self, cfg, params, ins, ctx):
        info = ctx.in_infos[0]
        x = to_nhwc(ins[0].value, info.channels, info.height, info.width)
        size = ctx.out_info.channels
        w_h, w_w = params["w0"][0], params["w0"][1]
        bias = params.get("wbias")
        act_in = activation(cfg.attrs.get("active_type", "tanh"))
        act_gate = activation(cfg.attrs.get("active_gate_type", "sigmoid"))
        act_state = activation(cfg.attrs.get("active_state_type", "tanh"))
        B, H, W, _ = x.shape
        z = x.new_zeros(B, size)
        h_up, c_up = [z] * W, [z] * W
        rows = []
        for i in range(H):
            h_left = c_left = z
            h_row, c_row = [], []
            for j in range(W):
                gates = x[:, i, j] + h_up[j] @ w_h + h_left @ w_w
                if bias is not None:
                    gates = gates + bias
                g_in, g_ig, g_fh, g_fw, g_og = gates.chunk(5, dim=-1)
                c_left = (act_in(g_in) * act_gate(g_ig)
                          + c_up[j] * act_gate(g_fh)
                          + c_left * act_gate(g_fw))
                h_left = act_gate(g_og) * act_state(c_left)
                h_row.append(h_left)
                c_row.append(c_left)
            h_up, c_up = h_row, c_row
            rows.append(torch.stack(h_row, dim=1))
        return Argument(value=torch.stack(rows, dim=1))  # [B, H, W, size]

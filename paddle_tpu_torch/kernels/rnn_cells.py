"""Fused LSTM and GRU cells: one recurrent step in a kernel.

The port's counterpart of ``paddle_tpu/kernels/rnn_cells.py``.

- LSTM: ``_lstm_cell_kernel`` via ``_lstm_pallas``, one step on
  pre-projected gates [B, 4H] with peepholes; the training entry
  ``lstm_cell`` (backward: the vjp of the plain math) and the no-grad
  entry ``lstm_cell_infer``. The step layer ``lstm_step`` is their caller.
  The kernel is ``lstm_cell_forward`` of ``csrc/lstm_cell.cu``, one launch
  per step; ``lstm_math`` is ``_lstm_math`` verbatim and
  ``lstm_cell_plain`` its default-activation form (``_lstm_ref_default``).
- GRU: ``_gru_cell_kernel`` via ``_gru_pallas``, the training entry
  ``gru_cell`` whose backward is the vjp of the plain math, and the no-grad
  entry ``gru_cell_infer``. The step layer ``gru_step`` of a recurrent
  group is its caller. The kernel is ``gru_cell_forward`` of
  ``csrc/gru_seq.cu``: the sequence kernel's two phases with T = 1 and no
  mask (two launches per step).

Routing. In the JAX package the Pallas cell runs only under
``PADDLE_TPU_FUSED_RNN`` (off by default); its contract
(``rnn_cells.py:14-16``) makes the fused and the inline spelling the same
math, so the switch changes no result. The port has no such switch and
routes by device alone: with the default activations (tanh, sigmoid) a
CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
``gru_math``; other activations always run ``gru_math``.

``lstm_cell`` and ``gru_cell`` are differentiable: ``LstmCellFunction``'s
and ``GruCellFunction``'s forward is the kernel, their backward recomputes
the plain math under autograd from the saved inputs, as
``_lstm_fused_bwd`` and ``_gru_fused_bwd`` take the vjp of
``_lstm_ref_default`` and ``_gru_ref_default`` (a one-step cell is cheap to
recompute; JAX has no backward kernel here, so the port adds none).
``lstm_cell_infer`` and ``gru_cell_infer`` launch the kernel with no
autograd node. Each entry's ``.launches`` counts the calls that launched
its kernel; the GRU entries' ``.step_launches`` count device launches.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops import build
from paddle_tpu_torch.ops.build import check_weight
from paddle_tpu_torch.ops.gru import gru_step

_DEFAULT_IN = ("tanh", "", None)
_DEFAULT_GATE = ("sigmoid", "", None)
_DEFAULT_STATE = ("tanh", "", None)


def activation(name):
    """The activation ``name`` as a function ("" and None read tanh, as
    the JAX layers resolve them)."""
    # the layer plane imports this module; resolve activations lazily
    from paddle_tpu_torch.layers.activations import apply_activation
    return lambda x: apply_activation(name or "tanh", x)


# ------------------------------------------------------------------- LSTM
def lstm_math(gates, c_prev, check_i, check_f, check_o, act_in, act_gate,
              act_state):
    """The inline ``LstmLayer``/``LstmStepLayer`` step, verbatim (``gates``
    already hold x_t + h @ w + gate bias); returns (out, state)."""
    g_in, g_ig, g_fg, g_og = gates.chunk(4, dim=-1)
    g_in = act_in(g_in)
    g_ig = act_gate(g_ig + c_prev * check_i)
    g_fg = act_gate(g_fg + c_prev * check_f)
    state = g_in * g_ig + c_prev * g_fg
    g_og = act_gate(g_og + state * check_o)
    return g_og * act_state(state), state


def lstm_cell_plain(gates, c_prev, check_i, check_f, check_o):
    """``lstm_math`` with the default activations: the plain version of
    the kernel (JAX ``_lstm_ref_default``)."""
    return lstm_math(gates, c_prev, check_i, check_f, check_o,
                     activation("tanh"), activation("sigmoid"),
                     activation("tanh"))


def _lstm_launch(kernel, gates, c_prev, check_i, check_f, check_o):
    """One kernel step: (h, c), both [B, H]."""
    dev = build.cuda_device(kernel, gates)
    B, H = c_prev.shape
    build.check_tensors(kernel, dev, gates=(gates, (B, 4 * H)),
                        c_prev=(c_prev, (B, H)), check_i=(check_i, (H,)),
                        check_f=(check_f, (H,)), check_o=(check_o, (H,)))
    h = torch.empty((B, H), dtype=torch.float32, device=dev)
    c = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("lstm_cell", "lstm_cell_forward", 7, 2)(
            gates.data_ptr(), c_prev.data_ptr(), check_i.data_ptr(),
            check_f.data_ptr(), check_o.data_ptr(), h.data_ptr(),
            c.data_ptr(), B, H, stream)
    build.raise_on(err, kernel)
    return h, c


class LstmCellFunction(torch.autograd.Function):
    """The kernel forward with ``_lstm_fused_bwd``'s backward: the vjp of
    the plain math at the saved inputs."""

    @staticmethod
    def forward(ctx, gates, c_prev, check_i, check_f, check_o):
        h, c = _lstm_launch("lstm_cell", gates, c_prev, check_i, check_f,
                            check_o)
        lstm_cell.launches += 1
        ctx.save_for_backward(gates, c_prev, check_i, check_f, check_o)
        return h, c

    @staticmethod
    def backward(ctx, dh, dc):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            h, c = lstm_cell_plain(*leaves)
            return torch.autograd.grad((h, c), leaves, (dh, dc))


def _lstm_default(act_input, act_gate, act_state):
    return (act_input in _DEFAULT_IN and act_gate in _DEFAULT_GATE
            and act_state in _DEFAULT_STATE)


def _lstm_args(gates, c_prev, check_i, check_f, check_o):
    return tuple(t.contiguous() for t in (gates, c_prev, check_i, check_f,
                                          check_o))


def lstm_cell(gates, c_prev, check_i, check_f, check_o, act_input="tanh",
              act_gate="sigmoid", act_state="tanh"):
    """One LSTM step on pre-projected gates ``[B, 4H]`` with the peephole
    vectors ``[H]``; returns ``(out, state)``, both ``[B, H]``.
    Differentiable."""
    if not _lstm_default(act_input, act_gate, act_state):
        return lstm_math(gates, c_prev, check_i, check_f, check_o,
                         activation(act_input), activation(act_gate),
                         activation(act_state))
    if gates.device.type == "cpu":
        return lstm_cell_plain(gates, c_prev, check_i, check_f, check_o)
    return LstmCellFunction.apply(*_lstm_args(gates, c_prev, check_i,
                                              check_f, check_o))


lstm_cell.launches = 0


def lstm_cell_infer(gates, c_prev, check_i, check_f, check_o,
                    act_input="tanh", act_gate="sigmoid", act_state="tanh"):
    """``lstm_cell`` for the no-grad path (``train=False``, a beam
    search's step): the kernel alone, with no autograd node (JAX
    ``lstm_cell_infer``)."""
    if not _lstm_default(act_input, act_gate, act_state):
        return lstm_math(gates, c_prev, check_i, check_f, check_o,
                         activation(act_input), activation(act_gate),
                         activation(act_state))
    if gates.device.type == "cpu":
        return lstm_cell_plain(gates, c_prev, check_i, check_f, check_o)
    out = _lstm_launch("lstm_cell_infer", *_lstm_args(
        gates, c_prev, check_i, check_f, check_o))
    lstm_cell_infer.launches += 1
    return out


lstm_cell_infer.launches = 0


# -------------------------------------------------------------------- GRU
def gru_math(x, h, w_gate, w_state, act_in, act_gate):
    """The inline ``GruLayer``/``GruStepLayer`` step, verbatim (``x``
    already holds the input projection plus bias, ``[B, 3H]``)."""
    size = h.shape[-1]
    zr = x[:, :2 * size] + h @ w_gate
    z = act_gate(zr[:, :size])
    r = act_gate(zr[:, size:])
    c = act_in(x[:, 2 * size:] + (r * h) @ w_state)
    return h - z * h + z * c


def gru_cell_plain(x, h, w_gate, w_state):
    """``gru_math`` with the default activations: the plain version of the
    kernel (JAX ``_gru_ref_default``)."""
    return gru_step(x, h, w_gate, w_state)[3]


def _launch(kernel, x, h, w_gate, w_state):
    """One kernel step: the new hidden state [B, H]."""
    dev = build.cuda_device(kernel, x)
    B, H = h.shape
    build.check_tensors(kernel, dev, x=(x, (B, 3 * H)), h=(h, (B, H)))
    ldg = check_weight(kernel, dev, "w_gate", w_gate, (H, 2 * H))
    lds = check_weight(kernel, dev, "w_state", w_state, (H, H))
    gates = torch.empty((B, 3 * H), dtype=torch.float32, device=dev)
    rh = torch.empty((B, H), dtype=torch.float32, device=dev)
    out = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("gru_seq", "gru_cell_forward", 7, 4)(
            x.data_ptr(), h.data_ptr(), w_gate.data_ptr(),
            w_state.data_ptr(), gates.data_ptr(), rh.data_ptr(),
            out.data_ptr(), ldg, lds, B, H, stream)
    build.raise_on(err, kernel)
    return out


class GruCellFunction(torch.autograd.Function):
    """The kernel forward with ``_gru_fused_bwd``'s backward: the vjp of
    the plain math at the saved inputs."""

    @staticmethod
    def forward(ctx, x, h, w_gate, w_state):
        out = _launch("gru_cell", x, h, w_gate, w_state)
        gru_cell.launches += 1
        gru_cell.step_launches += 2
        ctx.save_for_backward(x, h, w_gate, w_state)
        return out

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            out = gru_cell_plain(*leaves)
            return torch.autograd.grad(out, leaves, dout)


def _default(act_input, act_gate):
    return act_input in _DEFAULT_IN and act_gate in _DEFAULT_GATE


def gru_cell(x, h, w_gate, w_state, act_input="tanh", act_gate="sigmoid"):
    """One GRU step: ``x`` [B, 3H] (projection + bias pre-added), ``h``
    [B, H], ``w_gate`` [H, 2H], ``w_state`` [H, H] (column slices of one
    matrix are fine); returns the new hidden [B, H]. Differentiable."""
    if not _default(act_input, act_gate):
        return gru_math(x, h, w_gate, w_state, activation(act_input),
                        activation(act_gate))
    if x.device.type == "cpu":
        return gru_cell_plain(x, h, w_gate, w_state)
    return GruCellFunction.apply(x.contiguous(), h.contiguous(), w_gate,
                                 w_state)


gru_cell.launches = 0
gru_cell.step_launches = 0


def gru_cell_infer(x, h, w_gate, w_state, act_input="tanh",
                   act_gate="sigmoid"):
    """``gru_cell`` for the no-grad path (``train=False``): the kernel's
    primal alone, with no autograd node (JAX ``gru_cell_infer``)."""
    if not _default(act_input, act_gate):
        return gru_math(x, h, w_gate, w_state, activation(act_input),
                        activation(act_gate))
    if x.device.type == "cpu":
        return gru_cell_plain(x, h, w_gate, w_state)
    out = _launch("gru_cell_infer", x.contiguous(), h.contiguous(), w_gate,
                  w_state)
    gru_cell_infer.launches += 1
    gru_cell_infer.step_launches += 2
    return out


gru_cell_infer.launches = 0
gru_cell_infer.step_launches = 0

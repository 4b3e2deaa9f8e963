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
  group is its caller. Two routes, by shape (``gru_cell_plan``), never by
  failure: the cluster route, one launch a step of
  ``gru_cell_cluster_forward`` (``csrc/gru_cell.cu``: clusters of blocks
  that exchange r * h through distributed shared memory), and the
  two-launch route, ``gru_cell_forward`` of ``csrc/gru_seq.cu`` (the
  sequence kernel's two phases with T = 1 and no mask), where H % 4 != 0,
  the block's shared memory would not fit, or the weights or h do not
  lie on 16 bytes. ``two_launch=True`` forces the second.

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
its kernel; the GRU entries' ``.step_launches`` count device launches (1 a
call on the cluster route, 2 on the other).

Mixed precision. Under ``--compute_dtype bfloat16`` a cell inside a
recurrent group meets JAX's promotion: seq2seq's decoder steps an f32
state (booted from an f32 layer) with an f32 input and bf16 weights, and
the reference's inline math (its default; ``PADDLE_TPU_FUSED_RNN`` off)
computes f32 (``h @ w`` of f32 by bf16 is f32). The plain versions
promote as JAX does (``utils/precision.py:matmul``; torch promotes the
elementwise mix). On the card an f32 state takes the f32 kernel on the
widened operands: widening bf16 to f32 is exact, and the promoted math is
the f32 function of the widened values. The group widens a cell's bf16
weights once a forward (``layers/group.py``); what is still bf16 at a
call (x, or weights outside a group) is widened there, one cast launch
each, counted in each entry's ``.widen_casts``. A cell whose state itself
is bf16 runs the inline bf16 math on the CPU, as the reference does, and
raises on the card: its all-bf16 kernel form is still to port.

The launch path runs once per decoder step from a Python loop, so it is
lean (``build.check_cell``: every check in one pass, the messages of the
per-tensor checks on failure; ``build.call``: PyTorch's current stream,
a device guard only off the current device) and the cluster route
allocates only its output.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from paddle_tpu_torch.ops import build
from paddle_tpu_torch.ops.build import H100_SMS, SMEM_BYTES
from paddle_tpu_torch.ops.gru import gru_step
from paddle_tpu_torch.utils.precision import matmul, widen

_DEFAULT_IN = ("tanh", "", None)
_DEFAULT_GATE = ("sigmoid", "", None)
_DEFAULT_STATE = ("tanh", "", None)


def _promoted(kernel, fn, state, *ts):
    """The operands of a card launch: with an f32 ``state`` every bf16
    operand widened (exact; counted in ``fn.widen_casts``), so that the
    f32 kernel computes JAX's promoted math; a bf16 state raises."""
    if state.dtype != torch.float32:
        raise ValueError(
            f"{kernel}: a {state.dtype} cell state has no kernel form on the "
            "card (the all-bf16 cell is still to port: ROADMAP Queue 2); "
            "an f32 state with bf16 operands takes the f32 kernel")
    out, casts = widen(ts)
    fn.widen_casts += casts
    return out


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
    B, H = c_prev.shape
    idx, _ = build.check_cell(kernel, (
        ("gates", gates, (B, 4 * H)), ("c_prev", c_prev, (B, H)),
        ("check_i", check_i, (H,)), ("check_f", check_f, (H,)),
        ("check_o", check_o, (H,))))
    h = torch.empty_like(c_prev)
    c = torch.empty_like(c_prev)
    err = build.call(build.bind("lstm_cell", "lstm_cell_forward", 7, 2), idx,
                     gates.data_ptr(), c_prev.data_ptr(), check_i.data_ptr(),
                     check_f.data_ptr(), check_o.data_ptr(), h.data_ptr(),
                     c.data_ptr(), B, H)
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
    return LstmCellFunction.apply(*_lstm_args(*_promoted(
        "lstm_cell", lstm_cell, c_prev, gates, c_prev, check_i, check_f,
        check_o)))


lstm_cell.launches = 0
lstm_cell.widen_casts = 0


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
    out = _lstm_launch("lstm_cell_infer", *_lstm_args(*_promoted(
        "lstm_cell_infer", lstm_cell_infer, c_prev, gates, c_prev, check_i,
        check_f, check_o)))
    lstm_cell_infer.launches += 1
    return out


lstm_cell_infer.launches = 0
lstm_cell_infer.widen_casts = 0


# -------------------------------------------------------------------- GRU
def gru_math(x, h, w_gate, w_state, act_in, act_gate):
    """The inline ``GruLayer``/``GruStepLayer`` step, verbatim (``x``
    already holds the input projection plus bias, ``[B, 3H]``)."""
    size = h.shape[-1]
    zr = x[:, :2 * size] + matmul(h, w_gate)
    z = act_gate(zr[:, :size])
    r = act_gate(zr[:, size:])
    c = act_in(x[:, 2 * size:] + matmul(r * h, w_state))
    return h - z * h + z * c


def gru_cell_plain(x, h, w_gate, w_state):
    """``gru_math`` with the default activations: the plain version of the
    kernel (JAX ``_gru_ref_default``)."""
    return gru_step(x, h, w_gate, w_state)[3]


# the cluster route's constants (csrc/gru_cell.cu: kThreads, kMaxRows) and
# the cluster size the plan takes (16, non-portable, or 8)
CELL_THREADS = 256
CELL_MAX_ROWS = 16
CELL_CLUSTER = 16
CLUSTER, TWO_LAUNCH = "cluster", "two_launch"


def _cdiv(a, b):
    return -(-a // b)


def _cell_slices(nc, K):
    """K slices of a product over nc columns (``cell_slices``)."""
    return min(CELL_THREADS // (nc // 4), K // 4)


def cell_smem(H, units, rows) -> int:
    """Shared-memory bytes of a cluster block (``cell_smem_floats`` in the
    kernel): the Wg slice (2 units H floats; the products' K-slice
    partials reuse it), the Ws slice, the tile of h (then of r * h) and
    z, h, r * h of the block's own units."""
    region = max(2 * units * H,
                 _cell_slices(2 * units, H) * rows * 2 * units,
                 _cell_slices(units, H) * rows * units)
    return 4 * (region + units * H + rows * H + 3 * rows * units)


def gru_cell_plan(B, H, sms=H100_SMS, slots=None, cluster=CELL_CLUSTER):
    """The cluster route's plan for a [B, H] cell on a card of ``sms`` SMs
    that places ``slots`` clusters at once (cudaOccupancyMaxActiveClusters,
    which the H100 gives as 7 for 16 blocks of this kernel; sms // cluster
    where not given). ``route`` is CLUSTER where H % 4 == 0 and a block of
    one row fits 232,448 bytes (so H <= 528 at cluster 16), else
    TWO_LAUNCH; ``cluster`` blocks (at most the ``cluster`` asked) of
    ``units`` = 4 ceil(H / 4 cluster) units (the last slice may be
    shorter), ``rows`` a tile: ceil(B / slots), so that the ``clusters`` =
    ceil(B / rows) fill the card without exceeding it, at most
    CELL_MAX_ROWS and what fits; ``blocks`` and ``smem`` bytes. At the
    paths' H = 512 only cluster 16 fits; where 8 fits too (H = 256) the
    two measured within 2 % of each other on the H100 (PERF.md)."""
    plan = dict(route=TWO_LAUNCH)
    if B < 1 or H < 4 or H % 4:
        return plan
    units = 4 * _cdiv(H, 4 * cluster)
    size = _cdiv(H, units)  # every block holds at least one unit
    fits = [r for r in range(1, CELL_MAX_ROWS + 1)
            if cell_smem(H, units, r) <= SMEM_BYTES]
    if not fits:
        return plan
    slots = max(1, sms // size if slots is None else slots)
    rows = min(_cdiv(B, slots), fits[-1])
    clusters = _cdiv(B, rows)
    return dict(route=CLUSTER, cluster=size, units=units, rows=rows,
                clusters=clusters, blocks=size * clusters,
                smem=cell_smem(H, units, rows), slots=slots)


def gru_cell_route(B, H, sms=H100_SMS) -> str:
    """CLUSTER or TWO_LAUNCH for a [B, H] cell (``gru_cell_plan``)."""
    return gru_cell_plan(B, H, sms)["route"]


def _cell_lib_fn(entry, restype, n_int):
    fn = getattr(build.load("gru_cell"), entry)
    fn.argtypes = [ctypes.c_int] * n_int
    fn.restype = restype
    return fn


def gru_cell_smem_of_kernel(H, cluster, rows) -> int:
    """The kernel's own count of a cluster block's shared-memory bytes
    (card only: it loads the library), to hold ``cell_smem`` against."""
    return _cell_lib_fn("gru_cell_smem", ctypes.c_longlong, 3)(
        H, cluster, rows)


def gru_cell_max_clusters(H, cluster, rows) -> int:
    """cudaOccupancyMaxActiveClusters of the cell kernel at this plan on
    the current card (negative: a CUDA error, or -4 for a plan the kernel
    does not take)."""
    return _cell_lib_fn("gru_cell_max_clusters", ctypes.c_int, 3)(
        H, cluster, rows)


@functools.lru_cache(maxsize=1024)
def _card_plan(B, H, idx):
    """``gru_cell_plan`` for card ``idx``: its SMs and the clusters it
    places at once (asked once per shape and card)."""
    plan = gru_cell_plan(B, H, build._sms_of(idx))
    if plan["route"] == CLUSTER:
        with torch.cuda.device(idx):
            slots = gru_cell_max_clusters(H, plan["cluster"], 1)
        if slots > 0:
            plan = gru_cell_plan(B, H, build._sms_of(idx), slots)
    return plan


_CLUSTER_ERRORS = {
    -1: "the block's shared memory exceeds the card's opt-in limit",
    -2: "the card cannot place one cluster of these blocks "
        "(cudaOccupancyMaxActiveClusters is 0)",
    -4: "the kernel does not take this plan (H, strides % 4, cluster "
        "size or rows)",
}


def _raise_cluster(err, kernel, plan):
    if err in _CLUSTER_ERRORS:
        raise RuntimeError(f"{kernel}: cluster launch refused: "
                           f"{_CLUSTER_ERRORS[err]} (plan {plan})")
    build.raise_on(err, kernel)


def _gru_launch(kernel, x, h, w_gate, w_state, two_launch=False):
    """One kernel step: (the new hidden state [B, H], device launches).
    The cluster route where the plan has it and h and the weights lie on
    16 bytes with row strides % 4 == 0 (the kernel's 16-byte copies)."""
    B, H = h.shape
    idx, (ldg, lds) = build.check_cell(
        kernel, (("x", x, (B, 3 * H)), ("h", h, (B, H))),
        (("w_gate", w_gate, (H, 2 * H)), ("w_state", w_state, (H, H))))
    out = torch.empty_like(h)
    ptrs = (x.data_ptr(), h.data_ptr(), w_gate.data_ptr(),
            w_state.data_ptr(), out.data_ptr())
    plan = None if two_launch else _card_plan(B, H, idx)
    if (plan is not None and plan["route"] == CLUSTER
            and not (ptrs[1] | ptrs[2] | ptrs[3]) & 15
            and not (ldg | lds) & 3):
        err = build.call(
            build.bind("gru_cell", "gru_cell_cluster_forward", 5, 6), idx,
            *ptrs, ldg, lds, B, H, plan["cluster"], plan["rows"])
        _raise_cluster(err, kernel, plan)
        return out, 1
    gates = torch.empty((B, 3 * H), dtype=torch.float32, device=x.device)
    rh = torch.empty_like(h)
    err = build.call(build.bind("gru_seq", "gru_cell_forward", 7, 4), idx,
                     *ptrs[:4], gates.data_ptr(), rh.data_ptr(), ptrs[4],
                     ldg, lds, B, H)
    build.raise_on(err, kernel)
    return out, 2


class GruCellFunction(torch.autograd.Function):
    """The kernel forward with ``_gru_fused_bwd``'s backward: the vjp of
    the plain math at the saved inputs."""

    @staticmethod
    def forward(ctx, x, h, w_gate, w_state, two_launch):
        out, steps = _gru_launch("gru_cell", x, h, w_gate, w_state,
                                 two_launch)
        gru_cell.launches += 1
        gru_cell.step_launches += steps
        ctx.save_for_backward(x, h, w_gate, w_state)
        return out

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            out = gru_cell_plain(*leaves)
            return (*torch.autograd.grad(out, leaves, dout), None)


def _default(act_input, act_gate):
    return act_input in _DEFAULT_IN and act_gate in _DEFAULT_GATE


def gru_cell(x, h, w_gate, w_state, act_input="tanh", act_gate="sigmoid",
             two_launch=False):
    """One GRU step: ``x`` [B, 3H] (projection + bias pre-added), ``h``
    [B, H], ``w_gate`` [H, 2H], ``w_state`` [H, H] (column slices of one
    matrix are fine); returns the new hidden [B, H]. Differentiable.
    ``two_launch=True`` forces the two-launch route on the card."""
    if not _default(act_input, act_gate):
        return gru_math(x, h, w_gate, w_state, activation(act_input),
                        activation(act_gate))
    if x.device.type == "cpu":
        return gru_cell_plain(x, h, w_gate, w_state)
    x, h, w_gate, w_state = _promoted("gru_cell", gru_cell, h, x, h, w_gate,
                                      w_state)
    return GruCellFunction.apply(x.contiguous(), h.contiguous(), w_gate,
                                 w_state, two_launch)


gru_cell.launches = 0
gru_cell.step_launches = 0
gru_cell.widen_casts = 0


def gru_cell_infer(x, h, w_gate, w_state, act_input="tanh",
                   act_gate="sigmoid", two_launch=False):
    """``gru_cell`` for the no-grad path (``train=False``): the kernel's
    primal alone, with no autograd node (JAX ``gru_cell_infer``)."""
    if not _default(act_input, act_gate):
        return gru_math(x, h, w_gate, w_state, activation(act_input),
                        activation(act_gate))
    if x.device.type == "cpu":
        return gru_cell_plain(x, h, w_gate, w_state)
    x, h, w_gate, w_state = _promoted("gru_cell_infer", gru_cell_infer, h, x,
                                      h, w_gate, w_state)
    out, steps = _gru_launch("gru_cell_infer", x.contiguous(),
                             h.contiguous(), w_gate, w_state, two_launch)
    gru_cell_infer.launches += 1
    gru_cell_infer.step_launches += steps
    return out


gru_cell_infer.launches = 0
gru_cell_infer.step_launches = 0
gru_cell_infer.widen_casts = 0

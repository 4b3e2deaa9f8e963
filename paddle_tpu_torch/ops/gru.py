"""Fused GRU sequence recurrence: the CUDA kernels and their plain versions.

The port's counterpart of ``paddle_tpu/ops/gru.py``. On the TPU the whole
masked recurrence is one Pallas kernel (``_gru_kernel``) in a primal form
for inference and a residual form for training; the backward
(``_bwd_rule``) is a reverse-time ``lax.scan``. Here the forward is the
hand-written CUDA kernel pair of ``csrc/gru_seq.cu`` (two launches per
step: the reset gate of every unit must exist before the candidate
product), whose source note gives the design and the bound on the H100.
The input projection ``x @ W_in`` stays outside, in the ``fc`` layer.

Three kernel wrappers, each counting the calls that launched its kernels
(``.launches``) and the device launches (``.step_launches``, two per
step), and choosing by device: on a CUDA tensor it launches the kernel
(or raises), on a CPU tensor it runs its plain PyTorch version, which the
CPU tests hold against the JAX package.

- ``gru_seq``: the primal forward (ys, hT); plain version
  ``gru_sequence_plain``.
- ``gru_seq_train``: the residual forward (ys, hs, gates); plain version
  ``gru_sequence_residual_plain``.
- ``gru_bwd_step``: one reverse step of the backward's chain (two
  elementwise kernels, a product after each); plain version
  ``gru_bwd_step_plain``.

The recurrent weights are ``w_gate`` [H, 2H] and ``w_state`` [H, H]. The
layers pass the two column slices of one [H, 3H] parameter, which are not
contiguous: the kernels take each weight's row stride, and the wrappers
refuse a weight whose columns are not contiguous.

``gru_sequence`` takes the primal kernel when no gradient is wanted and
otherwise ``GruFunction``, whose backward (``gru_backward``) transcribes
``_bwd_rule``: one ``gru_bwd_step`` per reverse step, and ``dWg`` and
``dWs`` as one product each over T*B rows after the loop. f32 only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.ops import build

Pair = Tuple[torch.Tensor, torch.Tensor]


def gru_step(x_t, h, w_gate, w_state):
    """One GRU step on the projected input ``x_t`` [B, 3H] (bias folded):
    (z, r, c, h_new), spelled as ``paddle_tpu/ops/gru.py:gru_sequence_ref``
    (``h - z*h + z*c``)."""
    H = h.shape[-1]
    zr = x_t[:, :2 * H] + h @ w_gate
    z = torch.sigmoid(zr[:, :H])
    r = torch.sigmoid(zr[:, H:])
    c = torch.tanh(x_t[:, 2 * H:] + (r * h) @ w_state)
    return z, r, c, h - z * h + z * c


def gru_sequence_plain(xs_b, mask, w_gate, w_state, h0) -> Pair:
    """Plain PyTorch loop over time. xs_b [T,B,3H] holds the projected
    inputs with the gate bias folded in, mask [T,B] f32, w_gate [H,2H],
    w_state [H,H], h0 [B,H]. Padded steps hold h and emit ``h_new * m``.
    Returns (ys [T,B,H], hT)."""
    h = h0
    ys = []
    for t in range(xs_b.shape[0]):
        *_, h_new = gru_step(xs_b[t], h, w_gate, w_state)
        m = mask[t].unsqueeze(-1)
        h = torch.where(m > 0, h_new, h)
        ys.append(h_new * m)
    if not ys:
        return xs_b.new_zeros(0, *h0.shape), h0
    return torch.stack(ys), h


def gru_sequence_residual_plain(xs_b, mask, w_gate, w_state, h0):
    """The residual form of ``gru_sequence_plain`` (JAX ``_gru_pallas(...,
    with_residuals=True)``): (ys, hs [T,B,H], gates [T,B,3H]) with the
    guarded state chain hs and gates = [z | r | c]."""
    h = h0
    ys, hs, gates = [], [], []
    for t in range(xs_b.shape[0]):
        z, r, c, h_new = gru_step(xs_b[t], h, w_gate, w_state)
        m = mask[t].unsqueeze(-1)
        h = torch.where(m > 0, h_new, h)
        ys.append(h_new * m)
        hs.append(h)
        gates.append(torch.cat([z, r, c], dim=-1))
    return torch.stack(ys), torch.stack(hs), torch.stack(gates)


def check_weight(kernel, device, name, w, shape):
    """A float32 CUDA matrix on ``device`` of ``shape`` whose columns are
    contiguous (a column slice of a wider matrix is fine: the kernels take
    its row stride). Returns that row stride."""
    if w.dtype != torch.float32 or not w.is_cuda:
        raise ValueError(f"{kernel}: {name} must be a float32 CUDA tensor, "
                         f"got {w.dtype} on {w.device}")
    if tuple(w.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(w.shape)}, "
                         f"expected {tuple(shape)}")
    if w.device != device:
        raise ValueError(f"{kernel}: {name} is on {w.device}, expected "
                         f"{device}")
    if w.stride(1) != 1 or w.stride(0) < w.shape[1]:
        raise ValueError(f"{kernel}: {name} must have contiguous columns "
                         f"(strides {tuple(w.stride())}); a column slice of "
                         "a row-major matrix is fine, a transpose is not")
    return w.stride(0)


def _seq_args(kernel, xs_b, mask, w_gate, w_state, h0):
    """Checks the sequence operands; returns (device, T, B, H, ldg, lds)."""
    dev = build.cuda_device(kernel, xs_b)
    T, B, H3 = xs_b.shape
    H = H3 // 3
    build.check_tensors(kernel, dev, xs=(xs_b, (T, B, 3 * H)),
                        mask=(mask, (T, B)), h0=(h0, (B, H)))
    ldg = check_weight(kernel, dev, "w_gate", w_gate, (H, 2 * H))
    lds = check_weight(kernel, dev, "w_state", w_state, (H, H))
    return dev, T, B, H, ldg, lds


def gru_seq(xs_b, mask, w_gate, w_state, h0) -> Pair:
    """The primal kernel's wrapper; same arguments and results as
    ``gru_sequence_plain``. ``gru_seq.launches`` counts the calls that
    launched the kernels; each call issues two device launches per
    timestep (``gru_seq.step_launches``)."""
    args = (xs_b, mask, w_gate, w_state, h0)
    if xs_b.device.type == "cpu":
        return gru_sequence_plain(*args)
    dev, T, B, H, ldg, lds = _seq_args("gru_seq", *args)
    h = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    h[0].copy_(h0)
    gates = torch.empty((B, 3 * H), dtype=torch.float32, device=dev)
    rh = torch.empty((B, H), dtype=torch.float32, device=dev)
    ys = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("gru_seq", "gru_seq_forward", 8, 5)(
            xs_b.data_ptr(), mask.data_ptr(), w_gate.data_ptr(),
            w_state.data_ptr(), h.data_ptr(), gates.data_ptr(),
            rh.data_ptr(), ys.data_ptr(), ldg, lds, T, B, H, stream)
    build.raise_on(err, "gru_seq")
    gru_seq.launches += 1
    gru_seq.step_launches += 2 * T
    return ys, h[T % 2]


gru_seq.launches = 0
gru_seq.step_launches = 0


def gru_seq_train(xs_b, mask, w_gate, w_state, h0):
    """The residual kernel's wrapper; same arguments and results as
    ``gru_sequence_residual_plain``. Counts as ``gru_seq``."""
    args = (xs_b, mask, w_gate, w_state, h0)
    if xs_b.device.type == "cpu":
        return gru_sequence_residual_plain(*args)
    dev, T, B, H, ldg, lds = _seq_args("gru_seq_train", *args)
    ys, hs = (torch.empty((T, B, H), dtype=torch.float32, device=dev)
              for _ in range(2))
    gates = torch.empty((T, B, 3 * H), dtype=torch.float32, device=dev)
    rh = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("gru_seq", "gru_seq_forward_train", 9, 5)(
            xs_b.data_ptr(), mask.data_ptr(), w_gate.data_ptr(),
            w_state.data_ptr(), h0.data_ptr(), ys.data_ptr(), hs.data_ptr(),
            gates.data_ptr(), rh.data_ptr(), ldg, lds, T, B, H, stream)
    build.raise_on(err, "gru_seq_train")
    gru_seq_train.launches += 1
    gru_seq_train.step_launches += 2 * T
    return ys, hs, gates


gru_seq_train.launches = 0
gru_seq_train.step_launches = 0


def gru_bwd_step_plain(dy_t, m_t, gates_t, h_pv, w_gate, w_state, dh, drh,
                       dxs_t):
    """One reverse step of ``_bwd_rule`` (``paddle_tpu/ops/gru.py:141-161``)
    in plain PyTorch, with the arguments and in-place contract of
    ``gru_bwd_step``: dh holds the carry of step t on entry and dh_prev on
    return; dxs_t [B, 3H] receives [da_z | da_r | da_c]; drh [B, H] is
    scratch (it ends holding da_c @ Ws^T)."""
    H = dh.shape[-1]
    m = m_t.unsqueeze(-1)
    z, r, c = gates_t.split(H, dim=-1)
    dh_new = m * (dh + dy_t)
    dz = dh_new * (c - h_pv)
    da_c = (dh_new * z) * (1 - c * c)
    torch.matmul(da_c, w_state.t(), out=drh)
    dr = drh * h_pv
    da_z = dz * z * (1 - z)
    da_r = dr * r * (1 - r)
    dxs_t.copy_(torch.cat([da_z, da_r, da_c], dim=-1))
    dh.copy_((1 - m) * dh + dh_new * (1 - z) + drh * r
             + dxs_t[:, :2 * H] @ w_gate.t())


def gru_bwd_step(dy_t, m_t, gates_t, h_pv, w_gate, w_state, dh, drh, dxs_t):
    """The backward step kernels' wrapper; the arguments and the in-place
    contract of ``gru_bwd_step_plain``. Two kernel launches with a product
    after each (``drh = da_c @ Ws^T``, then ``dh += da_zr @ Wg^T``; cuBLAS,
    as JAX leaves them to XLA). ``gru_bwd_step.launches`` counts calls,
    ``.step_launches`` the kernel launches."""
    args = (dy_t, m_t, gates_t, h_pv, w_gate, w_state, dh, drh, dxs_t)
    if dh.device.type == "cpu":
        return gru_bwd_step_plain(*args)
    dev = build.cuda_device("gru_bwd_step", dh)
    B, H = dh.shape
    bh = (B, H)
    build.check_tensors(
        "gru_bwd_step", dev, dy=(dy_t, bh), mask=(m_t, (B,)),
        gates=(gates_t, (B, 3 * H)), h_pv=(h_pv, bh), dh=(dh, bh),
        drh=(drh, bh), dxs=(dxs_t, (B, 3 * H)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("gru_seq", "gru_bwd_gate", 6, 2)(
            dy_t.data_ptr(), m_t.data_ptr(), gates_t.data_ptr(),
            h_pv.data_ptr(), dh.data_ptr(), dxs_t.data_ptr(), B, H, stream)
        build.raise_on(err, "gru_bwd_step")
        torch.matmul(dxs_t[:, 2 * H:], w_state.t(), out=drh)
        err = build.bind("gru_seq", "gru_bwd_reset", 5, 2)(
            drh.data_ptr(), gates_t.data_ptr(), h_pv.data_ptr(),
            dh.data_ptr(), dxs_t.data_ptr(), B, H, stream)
        build.raise_on(err, "gru_bwd_step")
    dh.addmm_(dxs_t[:, :2 * H], w_gate.t())
    gru_bwd_step.launches += 1
    gru_bwd_step.step_launches += 2


gru_bwd_step.launches = 0
gru_bwd_step.step_launches = 0


def gru_backward(mask, w_gate, w_state, h0, hs, gates, dys, dhT, step=None):
    """``_bwd_rule`` (``paddle_tpu/ops/gru.py:135-166``) over the residuals
    of ``gru_seq_train``: returns (dxs, dWg, dWs, dh0). The per-step chain
    goes through ``step``, by default ``gru_bwd_step`` (the kernels on the
    card, the plain version on the CPU; the card checks pass
    ``gru_bwd_step_plain`` for the plain backward); the weight gradients
    are one product each over T*B rows after the loop, where JAX sums
    them per step."""
    step = step or gru_bwd_step
    T, B, H = hs.shape
    dys = dys.contiguous()
    dxs = torch.empty((T, B, 3 * H), dtype=hs.dtype, device=hs.device)
    dh = dhT.contiguous().clone()
    drh = torch.empty_like(dh)
    h_prev = torch.cat([h0[None], hs[:-1]], dim=0)
    for t in range(T - 1, -1, -1):
        step(dys[t], mask[t], gates[t], h_prev[t], w_gate, w_state, dh, drh,
             dxs[t])
    rows = T * B
    dWg = h_prev.reshape(rows, H).t() @ dxs[..., :2 * H].reshape(rows, 2 * H)
    r_h = gates[..., H:2 * H] * h_prev
    dWs = r_h.reshape(rows, H).t() @ dxs[..., 2 * H:].reshape(rows, H)
    return dxs, dWg, dWs, dh


class GruFunction(torch.autograd.Function):
    """The custom gradient of the fused recurrence (JAX ``_gru_core`` with
    ``_fwd_rule`` / ``_bwd_rule``): the residual forward kernel saves
    (hs, gates), the backward replays them in reverse time."""

    @staticmethod
    def forward(ctx, xs_b, mask, w_gate, w_state, h0):
        ys, hs, gates = gru_seq_train(xs_b, mask, w_gate, w_state, h0)
        ctx.save_for_backward(mask, w_gate, w_state, h0, hs, gates)
        return ys, hs[-1].clone()

    @staticmethod
    def backward(ctx, dys, dhT):
        dxs, dWg, dWs, dh0 = gru_backward(*ctx.saved_tensors, dys, dhT)
        return dxs, None, dWg, dWs, dh0


def gru_sequence(xs, mask, w_gate, w_state, bias, h0, reverse=False) -> Pair:
    """Fused GRU over a padded [T,B,3H] gate-projection sequence, the
    counterpart of ``paddle_tpu/ops/gru.py:gru_sequence``. ``reverse=True``
    runs back to front (flip in, flip out: outputs stay in input time
    order and hT is the state after time 0). Differentiable: with grad
    enabled and an input that requires it, the residual kernel and
    ``GruFunction``'s backward; otherwise the lean primal kernel. The
    weights may be column slices of one [H, 3H] matrix. Returns
    (ys [T,B,H], hT)."""
    if reverse:
        ys, hT = gru_sequence(xs.flip(0), mask.flip(0), w_gate, w_state, bias,
                              h0)
        return ys.flip(0), hT
    xs_b = (xs + bias).contiguous()  # fold the bias in once
    args = (xs_b, mask.contiguous(), w_gate, w_state, h0.contiguous())
    if xs.shape[0] and torch.is_grad_enabled() and any(
            a.requires_grad for a in args):
        return GruFunction.apply(*args)
    return gru_seq(*args)

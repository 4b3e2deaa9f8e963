"""Fused LSTM sequence recurrence: the CUDA kernels and their plain versions.

The port's counterpart of ``paddle_tpu/ops/lstm.py``. On the TPU the whole
masked recurrence is one Pallas kernel (``_lstm_kernel``, and
``_lstm_kernel_tiled`` for big hidden sizes), in a primal form for
inference and a residual form for training; the backward (``_bwd_rule``)
is a reverse-time ``lax.scan``. Here they are the hand-written CUDA
kernels of ``csrc/lstm_seq.cu``, whose source note gives their design and
their bound on the H100. The input projection ``x @ W_in`` stays outside,
in the ``fc`` layer, exactly as in the JAX package.

Three kernel wrappers, each counting the calls that launched its kernel
(``.launches``) and choosing by device: on a CUDA tensor it launches the
kernel (or raises), on a CPU tensor it runs its plain PyTorch version,
which the CPU tests hold against the JAX package.

- ``lstm_seq``: the primal forward (ys, hT, cT); plain version
  ``lstm_sequence_plain``.
- ``lstm_seq_train``: the residual forward (ys, hs, cs, gates); plain
  version ``lstm_sequence_residual_plain``.
- ``lstm_bwd_step``: one reverse step of the backward's elementwise
  chain; plain version ``lstm_bwd_step_plain``.

``lstm_sequence`` takes the primal kernel when no gradient is wanted and
otherwise ``LstmFunction``, whose backward (``lstm_backward``) is a
transcription of ``_bwd_rule``: one ``lstm_bwd_step`` per step, the
recurrent product ``dgates_t @ W^T`` between steps, and ``dW`` and the
peephole gradients as one product and three sums after the loop. f32
only; bf16 is later work.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.ops import build

Tensors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# every BASELINE.md rnn-table (batch, hidden) pair, as in
# paddle_tpu/ops/lstm.py:BENCH_SHAPES
BENCH_SHAPES = [(64, 256), (64, 512), (64, 1280), (128, 256), (128, 1280),
                (256, 256), (256, 1280), (512, 512)]


def _cell(x_t, h, c, w, check_i, check_f, check_o):
    """One step of the peephole cell: (i, ig, fg, og, c_new, h_new)."""
    a_i, a_ig, a_fg, a_og = (x_t + h @ w).chunk(4, dim=-1)
    i = torch.tanh(a_i)
    ig = torch.sigmoid(a_ig + c * check_i)
    fg = torch.sigmoid(a_fg + c * check_f)
    c_new = i * ig + c * fg
    og = torch.sigmoid(a_og + c_new * check_o)
    return i, ig, fg, og, c_new, og * torch.tanh(c_new)


def lstm_sequence_plain(xs_b, mask, w, check_i, check_f, check_o, h0,
                        c0) -> Tensors:
    """Plain PyTorch loop over time. xs_b [T,B,4H] holds the pre-projected
    inputs with the gate bias folded in, mask [T,B] f32, w [H,4H], the
    peepholes [H], h0/c0 [B,H]. Returns (ys [T,B,H], hT, cT)."""
    h, c = h0, c0
    ys = []
    for t in range(xs_b.shape[0]):
        *_, c_new, h_new = _cell(xs_b[t], h, c, w, check_i, check_f,
                                 check_o)
        m = mask[t].unsqueeze(-1)
        h = torch.where(m > 0, h_new, h)
        c = torch.where(m > 0, c_new, c)
        ys.append(h_new * m)
    if not ys:
        return xs_b.new_zeros(0, *h0.shape), h0, c0
    return torch.stack(ys), h, c


def lstm_sequence_residual_plain(xs_b, mask, w, check_i, check_f, check_o,
                                 h0, c0):
    """The residual form of ``lstm_sequence_plain`` (JAX ``_lstm_pallas(...,
    with_residuals=True)``): (ys, hs, cs [T,B,H], gates [T,B,4H]) with the
    guarded state chains hs, cs and the activated gates [i|ig|fg|og]."""
    h, c = h0, c0
    ys, hs, cs, gates = [], [], [], []
    for t in range(xs_b.shape[0]):
        i, ig, fg, og, c_new, h_new = _cell(xs_b[t], h, c, w, check_i,
                                            check_f, check_o)
        m = mask[t].unsqueeze(-1)
        h = torch.where(m > 0, h_new, h)
        c = torch.where(m > 0, c_new, c)
        ys.append(h_new * m)
        hs.append(h)
        cs.append(c)
        gates.append(torch.cat([i, ig, fg, og], dim=-1))
    return (torch.stack(ys), torch.stack(hs), torch.stack(cs),
            torch.stack(gates))


def lstm_bwd_step_plain(dy_t, m_t, gates_t, c_new, c_prev, check_i,
                        check_f, check_o, dhw, dh, dc, dgates_t):
    """One reverse step of ``_bwd_rule`` (``paddle_tpu/ops/lstm.py:366-389``)
    in plain PyTorch, with the arguments and in-place contract of
    ``lstm_bwd_step``: dh holds (1 - m_{t+1}) dh_{t+1} and dhw holds
    dgates_{t+1} @ W^T on entry; dh, dc and dgates_t are written."""
    H = dh.shape[-1]
    m = m_t.unsqueeze(-1)
    i, ig, fg, og = (gates_t[:, k * H:(k + 1) * H] for k in range(4))
    dh_in = dh + dhw
    dh_new = m * (dh_in + dy_t)
    dc_new = m * dc
    tc = torch.tanh(c_new)
    da_og = (dh_new * tc) * og * (1 - og)
    dc_tot = dc_new + dh_new * og * (1 - tc * tc) + da_og * check_o
    da_i = dc_tot * ig * (1 - i * i)
    da_ig = (dc_tot * i) * ig * (1 - ig)
    da_fg = (dc_tot * c_prev) * fg * (1 - fg)
    dc.copy_((1 - m) * dc + dc_tot * fg + da_ig * check_i + da_fg * check_f)
    dh.copy_((1 - m) * dh_in)
    dgates_t.copy_(torch.cat([da_i, da_ig, da_fg, da_og], dim=-1))


def _seq_shapes(xs_b, mask, w, check_i, check_f, check_o, h0, c0):
    T, B, H4 = xs_b.shape
    H = H4 // 4
    return dict(xs=(xs_b, (T, B, 4 * H)), mask=(mask, (T, B)),
                w=(w, (H, 4 * H)), check_i=(check_i, (H,)),
                check_f=(check_f, (H,)), check_o=(check_o, (H,)),
                h0=(h0, (B, H)), c0=(c0, (B, H)))


def lstm_seq(xs_b, mask, w, check_i, check_f, check_o, h0, c0) -> Tensors:
    """The primal kernel's wrapper; same arguments and results as
    ``lstm_sequence_plain``. ``lstm_seq.launches`` counts the calls that
    launched the kernel; each call issues one device launch per timestep
    (``lstm_seq.step_launches``)."""
    args = (xs_b, mask, w, check_i, check_f, check_o, h0, c0)
    if xs_b.device.type == "cpu":
        return lstm_sequence_plain(*args)
    dev = build.cuda_device("lstm_seq", xs_b)
    build.check_tensors("lstm_seq", dev, **_seq_shapes(*args))
    T, B, H4 = xs_b.shape
    H = H4 // 4
    h = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    h[0].copy_(h0)
    c = c0.clone()
    ys = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("lstm_seq", "lstm_seq_forward", 9, 3)(
            xs_b.data_ptr(), mask.data_ptr(), w.data_ptr(),
            check_i.data_ptr(), check_f.data_ptr(), check_o.data_ptr(),
            h.data_ptr(), c.data_ptr(), ys.data_ptr(), T, B, H, stream)
    build.raise_on(err, "lstm_seq")
    lstm_seq.launches += 1
    lstm_seq.step_launches += T
    return ys, h[T % 2], c


lstm_seq.launches = 0
lstm_seq.step_launches = 0


def lstm_seq_train(xs_b, mask, w, check_i, check_f, check_o, h0, c0):
    """The residual kernel's wrapper; same arguments and results as
    ``lstm_sequence_residual_plain``. Counts as ``lstm_seq``: one launch
    per timestep (``step_launches``)."""
    args = (xs_b, mask, w, check_i, check_f, check_o, h0, c0)
    if xs_b.device.type == "cpu":
        return lstm_sequence_residual_plain(*args)
    dev = build.cuda_device("lstm_seq_train", xs_b)
    build.check_tensors("lstm_seq_train", dev, **_seq_shapes(*args))
    T, B, H4 = xs_b.shape
    H = H4 // 4
    ys, hs, cs = (torch.empty((T, B, H), dtype=torch.float32, device=dev)
                  for _ in range(3))
    gates = torch.empty((T, B, 4 * H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("lstm_seq", "lstm_seq_forward_train", 12, 3)(
            xs_b.data_ptr(), mask.data_ptr(), w.data_ptr(),
            check_i.data_ptr(), check_f.data_ptr(), check_o.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), ys.data_ptr(), hs.data_ptr(),
            cs.data_ptr(), gates.data_ptr(), T, B, H, stream)
    build.raise_on(err, "lstm_seq_train")
    lstm_seq_train.launches += 1
    lstm_seq_train.step_launches += T
    return ys, hs, cs, gates


lstm_seq_train.launches = 0
lstm_seq_train.step_launches = 0


def lstm_bwd_step(dy_t, m_t, gates_t, c_new, c_prev, check_i, check_f,
                  check_o, dhw, dh, dc, dgates_t):
    """The backward step kernel's wrapper; the arguments and the in-place
    contract of ``lstm_bwd_step_plain`` (dh, dc and dgates_t are written).
    One device launch per call."""
    args = (dy_t, m_t, gates_t, c_new, c_prev, check_i, check_f, check_o,
            dhw, dh, dc, dgates_t)
    if dh.device.type == "cpu":
        return lstm_bwd_step_plain(*args)
    dev = build.cuda_device("lstm_bwd_step", dh)
    B, H = dh.shape
    bh = (B, H)
    build.check_tensors(
        "lstm_bwd_step", dev, dy=(dy_t, bh), mask=(m_t, (B,)),
        gates=(gates_t, (B, 4 * H)), c_new=(c_new, bh), c_prev=(c_prev, bh),
        check_i=(check_i, (H,)), check_f=(check_f, (H,)),
        check_o=(check_o, (H,)), dhw=(dhw, bh), dh=(dh, bh), dc=(dc, bh),
        dgates=(dgates_t, (B, 4 * H)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("lstm_seq", "lstm_bwd_step", 12, 2)(
            *(a.data_ptr() for a in args), B, H, stream)
    build.raise_on(err, "lstm_bwd_step")
    lstm_bwd_step.launches += 1


lstm_bwd_step.launches = 0


def lstm_backward(mask, w, check_i, check_f, check_o, h0, c0, hs, cs, gates,
                  dys, dhT, dcT, step=None):
    """``_bwd_rule`` (``paddle_tpu/ops/lstm.py:358-396``) over the
    residuals of ``lstm_seq_train``: returns (dxs, dW, dpI, dpF, dpO, dh0,
    dc0). The per-step chain goes through ``step``, by default
    ``lstm_bwd_step`` (the kernel on the card, its plain version on the
    CPU; the card checks pass ``lstm_bwd_step_plain`` for the plain
    backward); the products and sums around it are PyTorch's, as JAX
    leaves them to XLA."""
    step = step or lstm_bwd_step
    T, B, H = hs.shape
    dys = dys.contiguous()
    dxs = torch.empty((T, B, 4 * H), dtype=hs.dtype, device=hs.device)
    dh, dc = dhT.contiguous().clone(), dcT.contiguous().clone()
    dhw = torch.zeros_like(dh)
    w_t = w.t()
    for t in range(T - 1, -1, -1):
        step(dys[t], mask[t], gates[t], cs[t], cs[t - 1] if t > 0 else c0,
             check_i, check_f, check_o, dhw, dh, dc, dxs[t])
        torch.matmul(dxs[t], w_t, out=dhw)
    dh0 = dh + dhw
    h_prev = torch.cat([h0[None], hs[:-1]], dim=0)
    c_prev = torch.cat([c0[None], cs[:-1]], dim=0)
    dW = h_prev.reshape(T * B, H).t() @ dxs.reshape(T * B, 4 * H)
    dpI = (dxs[..., H:2 * H] * c_prev).sum(dim=(0, 1))
    dpF = (dxs[..., 2 * H:3 * H] * c_prev).sum(dim=(0, 1))
    dpO = (dxs[..., 3 * H:] * cs).sum(dim=(0, 1))
    return dxs, dW, dpI, dpF, dpO, dh0, dc


class LstmFunction(torch.autograd.Function):
    """The custom gradient of the fused recurrence (JAX ``_lstm_core`` with
    ``_fwd_rule`` / ``_bwd_rule``): the residual forward kernel saves
    (hs, cs, gates), the backward replays them in reverse time."""

    @staticmethod
    def forward(ctx, xs_b, mask, w, check_i, check_f, check_o, h0, c0):
        ys, hs, cs, gates = lstm_seq_train(xs_b, mask, w, check_i, check_f,
                                           check_o, h0, c0)
        ctx.save_for_backward(mask, w, check_i, check_f, check_o, h0, c0,
                              hs, cs, gates)
        return ys, hs[-1].clone(), cs[-1].clone()

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        dxs, dW, dpI, dpF, dpO, dh0, dc0 = lstm_backward(
            *ctx.saved_tensors, dys, dhT, dcT)
        return dxs, None, dW, dpI, dpF, dpO, dh0, dc0


def lstm_sequence(xs, mask, w, gate_bias, check_i, check_f, check_o, h0, c0,
                  reverse=False) -> Tensors:
    """Fused LSTM over a padded [T,B,4H] gate-projection sequence, the
    counterpart of ``paddle_tpu/ops/lstm.py:lstm_sequence``.
    ``reverse=True`` runs back to front (flip in, flip out; outputs stay
    in input time order). Differentiable: with grad enabled and an input
    that requires it, the residual kernel and ``LstmFunction``'s backward;
    otherwise the lean primal kernel. Returns (ys [T,B,H], hT, cT)."""
    if reverse:
        ys, hT, cT = lstm_sequence(xs.flip(0), mask.flip(0), w, gate_bias,
                                   check_i, check_f, check_o, h0, c0)
        return ys.flip(0), hT, cT
    xs_b = (xs + gate_bias).contiguous()  # fold the bias in once
    args = (xs_b, mask.contiguous(), w.contiguous(), check_i.contiguous(),
            check_f.contiguous(), check_o.contiguous(), h0.contiguous(),
            c0.contiguous())
    if xs.shape[0] and torch.is_grad_enabled() and any(
            a.requires_grad for a in args):
        return LstmFunction.apply(*args)
    return lstm_seq(*args)

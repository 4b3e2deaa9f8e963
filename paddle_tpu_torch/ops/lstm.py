"""Fused LSTM sequence recurrence: the CUDA kernel and its plain version.

The port's counterpart of ``paddle_tpu/ops/lstm.py``. On the TPU the whole
masked recurrence is one Pallas kernel (``_lstm_kernel``, and
``_lstm_kernel_tiled`` for big hidden sizes); here it is the hand-written
CUDA kernel ``csrc/lstm_seq.cu``, whose source note gives its design and
its bound on the H100. The input projection ``x @ W_in`` stays outside, in
the ``fc`` layer, exactly as in the JAX package.

``lstm_seq`` is the kernel's wrapper: on a CUDA tensor it launches the
kernel (or raises), on a CPU tensor it runs ``lstm_sequence_plain``, the
plain PyTorch loop over time that the CPU tests hold against the JAX
package. Forward only, f32: training residuals, gradients and bf16 are
later work.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from paddle_tpu_torch.ops import build

Tensors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# every BASELINE.md rnn-table (batch, hidden) pair, as in
# paddle_tpu/ops/lstm.py:BENCH_SHAPES
BENCH_SHAPES = [(64, 256), (64, 512), (64, 1280), (128, 256), (128, 1280),
                (256, 256), (256, 1280), (512, 512)]


def lstm_sequence_plain(xs_b, mask, w, check_i, check_f, check_o, h0,
                        c0) -> Tensors:
    """Plain PyTorch loop over time. xs_b [T,B,4H] holds the pre-projected
    inputs with the gate bias folded in, mask [T,B] f32, w [H,4H], the
    peepholes [H], h0/c0 [B,H]. Returns (ys [T,B,H], hT, cT)."""
    h, c = h0, c0
    ys = []
    for t in range(xs_b.shape[0]):
        gates = xs_b[t] + h @ w
        a_i, a_ig, a_fg, a_og = gates.chunk(4, dim=-1)
        i = torch.tanh(a_i)
        ig = torch.sigmoid(a_ig + c * check_i)
        fg = torch.sigmoid(a_fg + c * check_f)
        c_new = i * ig + c * fg
        og = torch.sigmoid(a_og + c_new * check_o)
        h_new = og * torch.tanh(c_new)
        m = mask[t].unsqueeze(-1)
        h = torch.where(m > 0, h_new, h)
        c = torch.where(m > 0, c_new, c)
        ys.append(h_new * m)
    if not ys:
        return xs_b.new_zeros(0, *h0.shape), h0, c0
    return torch.stack(ys), h, c


def _check(name, t, shape):
    if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
        raise ValueError(f"lstm_seq: {name} must be a contiguous float32 "
                         f"CUDA tensor, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"lstm_seq: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _lib():
    lib = build.load("lstm_seq")
    fn = lib.lstm_seq_forward
    # every pointer as c_void_p: an undeclared argument would pass as a
    # 32-bit int and cut the pointer
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lstm_seq(xs_b, mask, w, check_i, check_f, check_o, h0, c0) -> Tensors:
    """The kernel's wrapper; same arguments and results as
    ``lstm_sequence_plain``. ``lstm_seq.launches`` counts the calls that
    launched the kernel; each call issues one device launch per timestep
    (``lstm_seq.step_launches``)."""
    if xs_b.device.type == "cpu":
        return lstm_sequence_plain(xs_b, mask, w, check_i, check_f,
                                   check_o, h0, c0)
    if not xs_b.is_cuda:
        raise ValueError(f"lstm_seq: no kernel for device {xs_b.device}")
    T, B, H4 = xs_b.shape
    H = H4 // 4
    for name, t, shape in (("xs", xs_b, (T, B, 4 * H)), ("mask", mask, (T, B)),
                           ("w", w, (H, 4 * H)), ("check_i", check_i, (H,)),
                           ("check_f", check_f, (H,)),
                           ("check_o", check_o, (H,)), ("h0", h0, (B, H)),
                           ("c0", c0, (B, H))):
        _check(name, t, shape)
        if t.device != xs_b.device:
            raise ValueError(f"lstm_seq: {name} is on {t.device}, xs on "
                             f"{xs_b.device}")
    fn = _lib()
    h = torch.empty((2, B, H), dtype=torch.float32, device=xs_b.device)
    h[0].copy_(h0)
    c = c0.clone()
    ys = torch.empty((T, B, H), dtype=torch.float32, device=xs_b.device)
    with torch.cuda.device(xs_b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xs_b.data_ptr(), mask.data_ptr(), w.data_ptr(),
                 check_i.data_ptr(), check_f.data_ptr(), check_o.data_ptr(),
                 h.data_ptr(), c.data_ptr(), ys.data_ptr(), T, B, H, stream)
    if err != 0:
        raise RuntimeError(f"lstm_seq: kernel launch failed with CUDA "
                           f"error {err}")
    lstm_seq.launches += 1
    lstm_seq.step_launches += T
    return ys, h[T % 2], c


lstm_seq.launches = 0
lstm_seq.step_launches = 0


def lstm_sequence(xs, mask, w, gate_bias, check_i, check_f, check_o, h0, c0,
                  reverse=False) -> Tensors:
    """Fused LSTM over a padded [T,B,4H] gate-projection sequence, the
    counterpart of ``paddle_tpu/ops/lstm.py:lstm_sequence``.
    ``reverse=True`` runs back to front (flip in, flip out; outputs stay
    in input time order). Returns (ys [T,B,H], hT, cT)."""
    if reverse:
        ys, hT, cT = lstm_sequence(xs.flip(0), mask.flip(0), w, gate_bias,
                                   check_i, check_f, check_o, h0, c0)
        return ys.flip(0), hT, cT
    xs_b = (xs + gate_bias).contiguous()  # fold the bias in once
    return lstm_seq(xs_b, mask.contiguous(), w.contiguous(),
                    check_i.contiguous(), check_f.contiguous(),
                    check_o.contiguous(), h0.contiguous(), c0.contiguous())

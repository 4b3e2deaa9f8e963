"""CTC: the CUDA kernels of the alpha and beta recursions and their plain
versions.

The port's counterpart of ``paddle_tpu/ops/ctc.py``. On the TPU the alpha
recursion is one Pallas kernel (``_ctc_kernel``, one grid step per frame,
alpha [B, S] carried in VMEM, S padded to 128 lanes) and the backward
(``_ctc_bwd``: the beta recursion and the state posterior) is a reverse
``lax.scan``. Here both are hand-written CUDA kernels of ``csrc/ctc.cu``,
one launch each for the whole time loop (its source note gives the design
and the bound on the H100). S is not padded: the TPU's padded states have
emit = NEG and ``valid_s`` = 0, so they change nothing that is returned.

The operands are the JAX package's: ``emit`` [B,T,S] the log-probabilities
gathered at the blank-interleaved extended labels (the gather stays outside,
in ``layers/chain.py:ctc_loss``), ``in_mask`` [B,T], ``valid_s`` and
``can_skip`` [B,S] as floats, ``ext_lens`` [B] = 2 L + 1.

Two kernel wrappers, each counting the calls that launched its kernel
(``.launches``) and choosing by device: on a CUDA tensor it launches the
kernel (or raises), on a CPU tensor it runs its plain PyTorch version,
which the CPU tests hold against the JAX package.

- ``ctc_alpha_fwd``: every alpha [B,T,S] and the log-likelihood [B];
  plain version ``ctc_forward_plain``.
- ``ctc_bwd``: d ll / d emit [B,T,S] weighted by the cotangent ``g`` [B];
  plain version ``ctc_bwd_plain``.

``ctc_ll`` takes ``ctc_alpha_fwd`` alone when no gradient is wanted and
otherwise ``CtcFunction``, whose backward is ``ctc_bwd``. f32 only.

NEG is finite (-1e30), as in JAX: an infeasible row (too few frames for
its transcript) gets ll of about -1e30 and finite gradients, not -inf and
nan, and the kernels give the plain versions' numbers there too.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops import build

NEG = -1e30  # paddle_tpu/ops/common.py:NEG, the finite -inf of log space
# the kernels' largest extended label length S = 2 L + 1 (csrc/ctc.cu:
# kMaxStates: 512 threads of 16 states each)
MAX_STATES = 8192


# ---------------------------------------------------------------- plain
def _lse3(a, b, c):
    """log(e^a + e^b + e^c), spelled as ``paddle_tpu/ops/ctc.py:_lse3``:
    all-NEG columns stay NEG (plus log 3), never nan."""
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp_min(m, NEG)
    return m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                              + torch.exp(c - m_safe))


def _down(x, k):
    """x[s - k] along the state axis, NEG where s < k."""
    return F.pad(x, (k, 0), value=NEG)[:, :x.shape[1]]


def _up(x, k):
    """x[s + k] along the state axis, NEG where s + k >= S."""
    return F.pad(x, (0, k), value=NEG)[:, k:]


def _step(alpha, emit_t, can_skip, valid_s):
    """One frame of the alpha recursion (``ops/ctc.py:_step``)."""
    a2 = torch.where(can_skip > 0, _down(alpha, 2), NEG)
    nxt = _lse3(alpha, _down(alpha, 1), a2) + emit_t
    return torch.where(valid_s > 0, nxt, NEG)


def _final_ll(alpha, ext_lens):
    """log(alpha[L-1] + alpha[L-2]) (``ops/ctc.py:_final_ll``); an empty
    transcript (``ext_lens`` = 1) counts the blank path only."""
    ext_lens = ext_lens.long()
    last = torch.gather(alpha, 1, torch.clamp_min(ext_lens - 1, 0)[:, None])
    last2 = torch.gather(alpha, 1,
                         torch.clamp_min(ext_lens - 2, 0)[:, None])
    last, last2 = last[:, 0], last2[:, 0]
    last2 = torch.where(ext_lens >= 2, last2, NEG)
    m = torch.maximum(last, last2)
    return m + torch.log(torch.exp(last - m) + torch.exp(last2 - m))


def ctc_alphas_plain(emit, in_mask, valid_s, can_skip) -> torch.Tensor:
    """The alpha recursion of ``_ctc_alphas_pallas``: alpha_0 = emit_0 on
    the valid states s <= 1 (frame 0's mask is not read), then one
    ``_step`` per frame, frozen where ``in_mask`` is 0. Returns alphas
    [B,T,S]."""
    S = emit.shape[2]
    s_idx = torch.arange(S, device=emit.device)[None, :]
    alpha = torch.where((s_idx <= 1) & (valid_s > 0), emit[:, 0], NEG)
    alphas = [alpha]
    for t in range(1, emit.shape[1]):
        nxt = _step(alpha, emit[:, t], can_skip, valid_s)
        alpha = torch.where(in_mask[:, t, None] > 0, nxt, alpha)
        alphas.append(alpha)
    return torch.stack(alphas, dim=1)


def ctc_forward_plain(emit, in_mask, valid_s, can_skip, ext_lens
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alphas [B,T,S], ll [B]): the forward the kernel computes."""
    alphas = ctc_alphas_plain(emit, in_mask, valid_s, can_skip)
    return alphas, _final_ll(alphas[:, -1], ext_lens)


def ctc_bwd_plain(emit, in_mask, valid_s, can_skip, ext_lens, alphas, ll,
                  g) -> torch.Tensor:
    """The backward of ``paddle_tpu/ops/ctc.py:_ctc_bwd`` in plain PyTorch:
    the beta recursion (suffix scores without the frame's own emission;
    frozen where frame t+1 is padding), then d ll / d emit_t[s] =
    exp(min(alpha_t + beta_t - ll, 30)) times ``g`` [B] and ``in_mask``.
    Returns demit [B,T,S]."""
    B, T, S = emit.shape
    ext_lens = ext_lens.long()
    s_idx = torch.arange(S, device=emit.device)[None, :]
    beta = torch.where(
        (s_idx == torch.clamp_min(ext_lens - 1, 0)[:, None])
        | ((s_idx == torch.clamp_min(ext_lens - 2, 0)[:, None])
           & (ext_lens[:, None] >= 2)), 0.0, NEG)
    # can_skip[s] gates the jump s-2 -> s; from state s the jump to s+2
    # is allowed iff can_skip[s+2]
    skip_fwd = _up(torch.where(can_skip > 0, 0.0, NEG), 2)
    betas = [beta]
    for t in range(T - 2, -1, -1):
        y = beta + emit[:, t + 1]
        prev = _lse3(y, _up(y, 1), _up(y, 2) + skip_fwd)
        prev = torch.where(valid_s > 0, prev, NEG)
        beta = torch.where(in_mask[:, t + 1, None] > 0, prev, beta)
        betas.append(beta)
    betas = torch.stack(betas[::-1], dim=1)
    post = torch.exp(torch.clamp_max(alphas + betas - ll[:, None, None],
                                     30.0))
    return g[:, None, None] * post * in_mask[:, :, None]


# -------------------------------------------------------------- kernels
def _check(kernel, emit, in_mask, valid_s, can_skip, ext_lens):
    """The operands' device, types and shapes; returns (device, B, T, S)."""
    dev = build.cuda_device(kernel, emit)
    if emit.dim() != 3:
        raise ValueError(f"{kernel}: emit must be [B, T, S], got "
                         f"{tuple(emit.shape)}")
    B, T, S = emit.shape
    if T < 1 or S < 1 or S > MAX_STATES:
        raise ValueError(
            f"{kernel}: T={T}, S={S}: the kernels take T >= 1 and 1 <= S <= "
            f"{MAX_STATES} extended label states (S = 2 L + 1; 512 threads "
            "of 16 states each hold one sequence's alphas)")
    build.check_tensors(kernel, dev, emit=(emit, (B, T, S)),
                        in_mask=(in_mask, (B, T)),
                        valid_s=(valid_s, (B, S)),
                        can_skip=(can_skip, (B, S)))
    if ext_lens.dtype != torch.int32 or ext_lens.device != dev \
            or not ext_lens.is_contiguous() or tuple(ext_lens.shape) != (B,):
        raise ValueError(f"{kernel}: ext_lens must be a contiguous int32 "
                         f"[{B}] tensor on {dev}, got {ext_lens.dtype} "
                         f"{tuple(ext_lens.shape)} on {ext_lens.device}")
    return dev, B, T, S


def ctc_alpha_fwd(emit, in_mask, valid_s, can_skip, ext_lens):
    """The forward kernel's wrapper; same arguments and results as
    ``ctc_forward_plain``. ``ctc_alpha_fwd.launches`` counts the calls
    that launched it."""
    if emit.device.type == "cpu":
        return ctc_forward_plain(emit, in_mask, valid_s, can_skip, ext_lens)
    dev, B, T, S = _check("ctc_alpha_fwd", emit, in_mask, valid_s, can_skip,
                          ext_lens)
    alphas = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    ll = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("ctc", "ctc_alpha_fwd", 7, 3)(
            emit.data_ptr(), in_mask.data_ptr(), valid_s.data_ptr(),
            can_skip.data_ptr(), ext_lens.data_ptr(), alphas.data_ptr(),
            ll.data_ptr(), B, T, S, stream)
    build.raise_on(err, "ctc_alpha_fwd")
    ctc_alpha_fwd.launches += 1
    return alphas, ll


ctc_alpha_fwd.launches = 0


def ctc_bwd(emit, in_mask, valid_s, can_skip, ext_lens, alphas, ll, g):
    """The backward kernel's wrapper; same arguments and result as
    ``ctc_bwd_plain``. Each (b, t, s) of demit is written once: no
    atomics, two runs give the same bits."""
    if emit.device.type == "cpu":
        return ctc_bwd_plain(emit, in_mask, valid_s, can_skip, ext_lens,
                             alphas, ll, g)
    dev, B, T, S = _check("ctc_bwd", emit, in_mask, valid_s, can_skip,
                          ext_lens)
    build.check_tensors("ctc_bwd", dev, alphas=(alphas, (B, T, S)),
                        ll=(ll, (B,)), g=(g, (B,)))
    demit = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("ctc", "ctc_bwd", 9, 3)(
            emit.data_ptr(), in_mask.data_ptr(), valid_s.data_ptr(),
            can_skip.data_ptr(), ext_lens.data_ptr(), alphas.data_ptr(),
            ll.data_ptr(), g.data_ptr(), demit.data_ptr(), B, T, S, stream)
    build.raise_on(err, "ctc_bwd")
    ctc_bwd.launches += 1
    return demit


ctc_bwd.launches = 0


# ------------------------------------------------------------- autograd
class CtcFunction(torch.autograd.Function):
    """The custom gradient of the CTC log-likelihood (JAX ``_ctc_core``
    with ``_ctc_fwd`` / ``_ctc_bwd``): the forward kernel saves the alphas
    and ll, the backward kernel runs the beta recursion and writes the
    state posteriors. Only ``emit`` gets a gradient."""

    @staticmethod
    def forward(ctx, emit, in_mask, valid_s, can_skip, ext_lens):
        alphas, ll = ctc_alpha_fwd(emit, in_mask, valid_s, can_skip,
                                   ext_lens)
        ctx.save_for_backward(emit, in_mask, valid_s, can_skip, ext_lens,
                              alphas, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        demit = ctc_bwd(*ctx.saved_tensors, g.contiguous())
        return demit, None, None, None, None


def ctc_ll(emit, in_mask, valid_s, can_skip, ext_lens) -> torch.Tensor:
    """Log-likelihood [B] of the CTC paths, the counterpart of
    ``paddle_tpu/ops/ctc.py:ctc_ll``: emit [B,T,S] gathered log-probs,
    in_mask [B,T], valid_s / can_skip [B,S] floats, ext_lens [B] ints.
    Differentiable in emit through ``CtcFunction``; without a gradient,
    the forward kernel alone."""
    args = tuple(t.contiguous() for t in (emit, in_mask, valid_s, can_skip))
    args += (ext_lens.to(torch.int32).contiguous(),)
    if torch.is_grad_enabled() and emit.requires_grad:
        return CtcFunction.apply(*args)
    return ctc_alpha_fwd(*args)[1]

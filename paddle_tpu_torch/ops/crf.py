"""Linear-chain CRF: the CUDA kernels and their plain versions.

The port's counterpart of ``paddle_tpu/ops/crf.py``. On the TPU the alpha
recursion is one Pallas kernel (``_crf_kernel``) over the class axis padded
to 128 lanes, and the backward (``_crf_bwd``) and the Viterbi decode
(``paddle_tpu/layers/chain.py:crf_decode``) are ``lax.scan``s. Here all
three are hand-written CUDA kernels of ``csrc/crf.cu``, one launch each
for the whole time loop (its source note gives the design and the bound
on the H100). The class axis is not padded: the TPU's padded classes are
exact zeros of the exp-space product, so leaving them out gives the same
numbers.

Three kernel wrappers, each counting the calls that launched its kernel
(``.launches``) and choosing by device: on a CUDA tensor it launches the
kernel (or raises), on a CPU tensor it runs its plain PyTorch version,
which the CPU tests hold against the JAX package.

- ``crf_alpha_fwd``: every alpha [B,T,C] and log Z [B]; plain version
  ``crf_forward_plain``.
- ``crf_bwd``: the analytic backward (dx, dtrans, da, db); plain version
  ``crf_bwd_plain``.
- ``crf_viterbi``: the best path [B,T] (int32) and its score [B]; plain
  version ``crf_viterbi_plain``.

``crf_log_z`` takes ``crf_alpha_fwd`` alone when no gradient is wanted and
otherwise ``CrfFunction``, whose backward is ``crf_bwd``. f32 only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops import build

# the kernels' largest class count (csrc/crf.cu: kMaxClasses, 8 classes
# per lane; above C = 97 the backward's matrices, above C = 239 the
# forward's and the Viterbi's, stay in global memory)
MAX_CLASSES = 256


# ---------------------------------------------------------------- plain
def _step(alpha, trans_shift, tm, x_t):
    """One max-shifted exp-space alpha update (``ops/crf.py:_step``)."""
    m = alpha.max(dim=-1, keepdim=True).values
    s = torch.exp(alpha - m) @ trans_shift
    return torch.log(torch.clamp_min(s, 1e-37)) + m + tm + x_t


def _log_sum_exp(v):
    m = v.max(dim=-1, keepdim=True).values
    return m[:, 0] + torch.log(torch.exp(v - m).sum(dim=-1))


def crf_forward_plain(x, mask, trans, a, b) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Plain PyTorch loop, spelled as ``paddle_tpu/ops/crf.py:
    crf_log_z_ref``. x [B,T,C], mask [B,T] f32, trans [C,C], a, b [C].
    Returns (alphas [B,T,C] with alpha_0 = a + x_0 and alpha frozen on
    padded steps, log Z [B])."""
    tm = trans.max()
    trans_shift = torch.exp(trans - tm)
    alpha = a[None, :] + x[:, 0]
    alphas = [alpha]
    for t in range(1, x.shape[1]):
        nxt = _step(alpha, trans_shift, tm, x[:, t])
        alpha = torch.where(mask[:, t, None] > 0, nxt, alpha)
        alphas.append(alpha)
    return torch.stack(alphas, dim=1), _log_sum_exp(alpha + b[None, :])


def crf_log_z_plain(x, mask, trans, a, b) -> torch.Tensor:
    """log Z [B] (``crf_log_z_ref``)."""
    return crf_forward_plain(x, mask, trans, a, b)[1]


def crf_bwd_plain(x, mask, trans, b, alphas, log_z, g):
    """The analytic backward of ``paddle_tpu/ops/crf.py:_crf_bwd`` in plain
    PyTorch: the marginals of log Z weighted by ``g`` [B] (d loss / d log
    Z). Returns (dx [B,T,C], dtrans [C,C], da [C], db [C])."""
    B, T, C = x.shape
    tm = trans.max()
    trans_shift = torch.exp(trans - tm)  # [prev, next]
    # beta_{T-1} = b; beta_{t-1}[i] = logsumexp_j(trans[i,j] + x_t[j] +
    # beta_t[j]), frozen where step t is padding
    beta = b[None, :].expand(B, C)
    betas = [beta]
    for t in range(T - 1, 0, -1):
        y = x[:, t] + beta
        m = y.max(dim=-1, keepdim=True).values
        prev = torch.log(torch.clamp_min(
            torch.exp(y - m) @ trans_shift.T, 1e-37)) + m + tm
        beta = torch.where(mask[:, t, None] > 0, prev, beta)
        betas.append(beta)
    betas = torch.stack(betas[::-1], dim=1)  # [B,T,C], betas[:, t]
    q = torch.exp(alphas + betas - log_z[:, None, None])
    q = q * mask[:, :, None]
    dx = g[:, None, None] * q
    # pairwise marginals exp(alpha_{t-1}[i] + trans[i,j] + x_t[j] +
    # beta_t[j] - log Z), exponentiated summed (never factorised, so
    # forbidden transitions at -1e4 cannot overflow)
    dtrans = torch.zeros_like(trans)
    r_next = x[:, 1:] + betas[:, 1:]
    pair_m = mask[:, 1:] * mask[:, :-1]
    for t in range(T - 1):
        s = (alphas[:, t, :, None] + trans[None] + r_next[:, t, None, :]
             - log_z[:, None, None])
        p = torch.exp(torch.clamp_max(s, 30.0)) * (pair_m[:, t]
                                                   * g)[:, None, None]
        dtrans = dtrans + p.sum(dim=0)
    da = (g[:, None] * q[:, 0]).sum(dim=0)
    q_end = torch.exp(alphas[:, -1] + b[None, :] - log_z[:, None])
    db = (g[:, None] * q_end).sum(dim=0)
    return dx, dtrans, da, db


def crf_viterbi_plain(x, mask, trans, a, b):
    """Viterbi decode spelled as ``paddle_tpu/layers/chain.py:crf_decode``
    (scores ``alpha_i + trans_ij``, max over i, then ``+ x_j``; ties take
    the first index). Returns (path [B,T] int32, score [B])."""
    B, T, C = x.shape
    alpha = a[None, :] + x[:, 0]
    ident = torch.arange(C, device=x.device)[None, :].expand(B, C)
    ptrs = []
    for t in range(1, T):
        scores = alpha[:, :, None] + trans[None]  # [B, prev, next]
        best = scores.max(dim=1).values
        best_prev = scores.argmax(dim=1)  # the first index among maxima
        live = mask[:, t, None] > 0
        alpha = torch.where(live, best + x[:, t], alpha)
        ptrs.append(torch.where(live, best_prev, ident))
    final = alpha + b[None, :]
    score, state = final.max(dim=1).values, final.argmax(dim=1)
    path = [state]
    for ptr in reversed(ptrs):
        state = ptr.gather(1, state[:, None])[:, 0]
        path.append(state)
    return torch.stack(path[::-1], dim=1).to(torch.int32), score


# -------------------------------------------------------------- kernels
def _check(kernel, x, mask, trans, **vectors):
    """The operands' device, types and shapes; returns (device, B, T, C)."""
    dev = build.cuda_device(kernel, x)
    B, T, C = x.shape
    if T < 1 or C < 1 or C > MAX_CLASSES:
        raise ValueError(
            f"{kernel}: T={T}, C={C}: the kernels take T >= 1 and "
            f"1 <= C <= {MAX_CLASSES} classes (a warp per sequence, at most "
            "8 classes per lane)")
    build.check_tensors(kernel, dev, x=(x, (B, T, C)), mask=(mask, (B, T)),
                        trans=(trans, (C, C)),
                        **{k: (v, (C,)) for k, v in vectors.items()})
    return dev, B, T, C


@functools.lru_cache(maxsize=None)
def _work_floats(kernel: int, C: int) -> int:
    """Floats of scratch the forward (``kernel`` 0) or the backward (1)
    needs at C: 2 C^2 + 1 where its matrices outgrow shared memory, else 0
    (``csrc/crf.cu:crf_work_floats``)."""
    fn = build.load("crf").crf_work_floats
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(kernel, C)


def _work(dev, kernel, C, in_global) -> Optional[torch.Tensor]:
    """Scratch of the kernels' global-memory path (max(trans), exp(trans -
    max) and its transpose), or None: the kernel then keeps its matrices
    in shared memory. ``in_global`` takes the global path at any C."""
    n = 2 * C * C + 1 if in_global else _work_floats(kernel, C)
    return torch.empty((n,), dtype=torch.float32, device=dev) if n else None


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def crf_alpha_fwd(x, mask, trans, a, b, *, in_global=False):
    """The forward kernel's wrapper; same arguments and results as
    ``crf_forward_plain``. ``crf_alpha_fwd.launches`` counts the calls
    that launched it. ``in_global`` keeps the [C, C] matrices in global
    memory even where they fit a block (the same bits; chip_smoke.py times
    both paths)."""
    if x.device.type == "cpu":
        return crf_forward_plain(x, mask, trans, a, b)
    dev, B, T, C = _check("crf_alpha_fwd", x, mask, trans, a=a, b=b)
    alphas = torch.empty((B, T, C), dtype=torch.float32, device=dev)
    log_z = torch.empty((B,), dtype=torch.float32, device=dev)
    work = _work(dev, 0, C, in_global)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("crf", "crf_alpha_fwd", 8, 3)(
            x.data_ptr(), mask.data_ptr(), trans.data_ptr(), a.data_ptr(),
            b.data_ptr(), _ptr(work), alphas.data_ptr(),
            log_z.data_ptr(), B, T, C, stream)
    build.raise_on(err, "crf_alpha_fwd")
    crf_alpha_fwd.launches += 1
    return alphas, log_z


crf_alpha_fwd.launches = 0


def crf_bwd(x, mask, trans, b, alphas, log_z, g, *, in_global=False):
    """The backward kernel's wrapper; same arguments and results as
    ``crf_bwd_plain``. The kernel writes per-sequence partials of dtrans,
    da and db; their sum over the batch is a deterministic reduction after
    it (no float atomics). ``in_global`` as for ``crf_alpha_fwd``."""
    if x.device.type == "cpu":
        return crf_bwd_plain(x, mask, trans, b, alphas, log_z, g)
    dev, B, T, C = _check("crf_bwd", x, mask, trans, b=b)
    build.check_tensors("crf_bwd", dev, alphas=(alphas, (B, T, C)),
                        log_z=(log_z, (B,)), g=(g, (B,)))
    dx = torch.empty((B, T, C), dtype=torch.float32, device=dev)
    dtrans = torch.empty((B, C, C), dtype=torch.float32, device=dev)
    da, db = (torch.empty((B, C), dtype=torch.float32, device=dev)
              for _ in range(2))
    work = _work(dev, 1, C, in_global)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("crf", "crf_bwd", 12, 3)(
            x.data_ptr(), mask.data_ptr(), trans.data_ptr(), b.data_ptr(),
            alphas.data_ptr(), log_z.data_ptr(), g.data_ptr(),
            _ptr(work), dx.data_ptr(), dtrans.data_ptr(),
            da.data_ptr(), db.data_ptr(), B, T, C, stream)
    build.raise_on(err, "crf_bwd")
    crf_bwd.launches += 1
    return dx, dtrans.sum(dim=0), da.sum(dim=0), db.sum(dim=0)


crf_bwd.launches = 0


def crf_viterbi(x, mask, trans, a, b):
    """The Viterbi kernel's wrapper; same arguments and results as
    ``crf_viterbi_plain``: the path is identical, not merely close."""
    if x.device.type == "cpu":
        return crf_viterbi_plain(x, mask, trans, a, b)
    dev, B, T, C = _check("crf_viterbi", x, mask, trans, a=a, b=b)
    ptr = torch.empty((B, T, C), dtype=torch.int32, device=dev)
    path = torch.empty((B, T), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("crf", "crf_viterbi", 8, 3)(
            x.data_ptr(), mask.data_ptr(), trans.data_ptr(), a.data_ptr(),
            b.data_ptr(), ptr.data_ptr(), path.data_ptr(), score.data_ptr(),
            B, T, C, stream)
    build.raise_on(err, "crf_viterbi")
    crf_viterbi.launches += 1
    return path, score


crf_viterbi.launches = 0


# ------------------------------------------------------------- autograd
class CrfFunction(torch.autograd.Function):
    """The custom gradient of log Z (JAX ``_crf_core`` with ``_crf_fwd`` /
    ``_crf_bwd``): the forward kernel saves the alphas and log Z, the
    backward kernel computes the marginals from them. mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, x, mask, trans, a, b):
        alphas, log_z = crf_alpha_fwd(x, mask, trans, a, b)
        ctx.save_for_backward(x, mask, trans, b, alphas, log_z)
        return log_z

    @staticmethod
    def backward(ctx, g):
        dx, dtrans, da, db = crf_bwd(*ctx.saved_tensors, g.contiguous())
        return dx, None, dtrans, da, db


def crf_log_z(x, mask, trans, a, b) -> torch.Tensor:
    """log Z [B] for a batch of linear-chain CRFs, the counterpart of
    ``paddle_tpu/ops/crf.py:crf_log_z``. Differentiable in x, trans, a and
    b through ``CrfFunction``; without a gradient, the forward kernel
    alone."""
    args = tuple(t.contiguous() for t in (x, mask, trans, a, b))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return CrfFunction.apply(*args)
    return crf_alpha_fwd(*args)[1]

"""CTC: the CUDA kernels of the alpha and beta recursions and their plain
versions.

The port's counterpart of ``paddle_tpu/ops/ctc.py``. On the TPU the alpha
recursion is one Pallas kernel (``_ctc_kernel``, one grid step per frame,
alpha [B, S] carried in VMEM, S padded to 128 lanes) and the backward
(``_ctc_bwd``: the beta recursion and the state posterior) is a reverse
``lax.scan``. Here both recursions run in hand-written CUDA kernels of
``csrc/ctc.cu``, one launch for the whole time loop (its source note gives
the design and the bound on the H100). S is not padded: the TPU's padded
states have emit = NEG and ``valid_s`` = 0, so they change nothing that is
returned.

Two operand forms, one chain code in the kernels:

- gathered, the JAX package's operands: ``emit`` [B,T,S] the log-probs
  gathered at the blank-interleaved extended labels, ``in_mask`` [B,T],
  ``valid_s`` and ``can_skip`` [B,S] as floats, ``ext_lens`` [B] = 2 L + 1.
  ``ctc_ll`` (the counterpart of JAX's ``ctc_ll``) takes them;
- fused, the layer's own: ``log_probs`` [B,T,C], ``labels`` [B,L] (int32 or
  int64, as fed), ``in_mask`` [B,T], ``label_mask`` [B,L], ``blank``. The
  kernels derive the extended labels, ``valid_s`` and ``can_skip`` per
  sequence and read ``log_probs[b, t, ext[s]]``; the backward writes
  d ll / d log_probs [B,T,C], so no [B,T,S] gather or scatter remains.
  ``ctc_ll_from_log_probs`` takes them (``layers/chain.py:ctc_loss``).

Kernel wrappers, each counting the calls that launched its kernel
(``.launches``) and choosing by device: on a CUDA tensor it launches the
kernel (or raises), on a CPU tensor it runs its plain PyTorch version,
which the CPU tests hold against the JAX package.

- ``ctc_alpha_fwd``: every alpha [B,T,S] and the log-likelihood [B] from
  the gathered operands; plain version ``ctc_forward_plain``.
- ``ctc_bwd``: d ll / d emit [B,T,S] weighted by the cotangent ``g`` [B]
  (the beta chain from the saved alphas); plain ``ctc_bwd_plain``.
- ``ctc_fused_fwd``: ll [B] from the log-probs; with ``grad=True`` also the
  alphas and, on blocks of the same launch, the betas [B,T,S]; plain
  ``ctc_fused_forward_plain``.
- ``ctc_fused_bwd``: d ll / d log_probs [B,T,C] weighted by ``g`` from the
  alphas, betas and ll, a parallel pass with no chain; plain
  ``ctc_fused_bwd_plain``.

The fused form takes any S and C (``ctc_plan`` gives the routes): up to
``MAX_STATES`` states the chains run a state a lane (more above 1024),
beyond it the wide chains (a block of 1024 threads a chain, the frames in
scratch rows); the posterior pass stages frames in shared memory where
the class offsets fit (4 (C + 1) + 8 S bytes at one frame), and beyond it
ranks each sequence's states by class into a list in scratch, so C takes
no shared memory. The gathered form takes any S too: the lanes up to
``MAX_STATES``, above it the gathered twin of the wide chains (the alpha
chain keeps its frame in the alphas it writes, the beta chain two rows of
scratch a chain).

The kernels compute the plain versions' arithmetic operation for operation
(``lse3_kernel`` spells their shortened log-sum-exp, which gives
``_lse3``'s bits), so they give the plain versions' bits on the card. f32
only. NEG is finite (-1e30), as in JAX: an infeasible row (too few frames
for its transcript) gets ll of about -1e30 and finite gradients, not -inf
and nan, and the kernels give the plain versions' numbers there too.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops import build

NEG = -1e30  # paddle_tpu/ops/common.py:NEG, the finite -inf of log space

# csrc/ctc.cu: a chain's lane owns at most 16 states, a block at most 32
# warps (the lane route of both forms; the wide chains above);
# the staged posterior pass of the fused form stages at most 8 frames a
# block of 256 threads; the wide chains are blocks of 1024 threads
MAX_STATES = 32 * 32 * 16
RING = 32  # frames in flight between two warps of a chain
GRAD_THREADS = 256
GRAD_FRAMES = 8
WIDE_THREADS = 1024


# ----------------------------------------------------------------- plan
def _per_lane(S: int) -> int:
    p = 1
    while p < 16 and S > 32 * 32 * p:
        p *= 2
    return p


def _grad_smem(S: int, C: int, frames: int) -> int:
    return 4 * (C + 1) + 4 * S + 4 * max(frames * S, GRAD_THREADS)


def ctc_plan(S: int, C: int = 0) -> dict:
    """The fused kernels' routes and layout at S states and C classes, by
    the formulas of ``csrc/ctc.cu`` (``ctc_smem``; a card test holds the
    two equal). ``fwd``: ``lanes`` up to ``MAX_STATES`` (``per_lane``
    states a lane, ``warps`` of a chain's block, ``smem_chain`` its
    dynamic shared memory: per warp ``RING`` slots of two 64-bit words, a
    sink word a lane, the epilogue's two values, a progress counter a
    warp), ``wide`` above (a block of ``WIDE_THREADS`` a chain, no dynamic
    shared memory, ``scratch_floats`` 2 S a chain). ``bwd``: ``staged``
    where the class offsets, the class-sorted states and one frame fit a
    block (``frames`` a block stages, ``smem_grad`` its bytes), else
    ``sorted`` (the states ranked by class into ``order_ints`` S a
    sequence, a block a frame, no dynamic shared memory). Any S >= 1."""
    if S < 1:
        raise ValueError(f"ctc_plan: S={S} states: the kernels take S >= 1")
    frames = next((f for f in range(GRAD_FRAMES, 0, -1)
                   if _grad_smem(S, C, f) <= build.SMEM_BYTES), 0)
    plan = dict(frames=frames,
                smem_grad=_grad_smem(S, C, frames) if frames else 0,
                bwd="staged" if frames else "sorted",
                order_ints=0 if frames else S)
    if S <= MAX_STATES:
        P = _per_lane(S)
        W = -(-S // (32 * P))
        plan.update(fwd="lanes", per_lane=P, warps=W, threads=32 * W,
                    smem_chain=16 * RING * W + 8 * 32 + 8 + 4 * W,
                    scratch_floats=0)
    else:
        plan.update(fwd="wide", threads=WIDE_THREADS, smem_chain=0,
                    scratch_floats=2 * S)
    return plan


def ctc_smem_of_kernel(which: str, S: int, C: int = 0) -> int:
    """The dynamic shared memory the kernels ``which`` (``chain`` or
    ``grad``) request at S states and C classes, by their own count (card
    only: it loads the library), to hold ``ctc_plan`` against."""
    fn = build.load("ctc").ctc_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn(("chain", "grad").index(which), S, C)


# ---------------------------------------------------------------- plain
def _lse3(a, b, c):
    """log(e^a + e^b + e^c), spelled as ``paddle_tpu/ops/ctc.py:_lse3``:
    all-NEG columns stay NEG (plus log 3), never nan."""
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp_min(m, NEG)
    return m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                              + torch.exp(c - m_safe))


def lse3_kernel(a, b, c):
    """``_lse3`` as the kernels spell it (``csrc/ctc.cu:lse3``): the largest
    term's exp is 1 exactly (0 below NEG, where it is exp(<= -2^76)), so
    two exps, and the three terms added in the order a, b, c. Gives
    ``_lse3``'s bits."""
    m = torch.maximum(torch.maximum(a, b), c)
    ms = torch.clamp_min(m, NEG)
    one = (m >= NEG).to(a.dtype)
    a_max = (a >= b) & (a >= c)
    c_max = ~a_max & (c > b)
    ep = torch.exp(torch.where(a_max, b, a) - ms)
    eq = torch.exp(torch.where(c_max, b, c) - ms)
    return ms + torch.log((ep + torch.where(c_max, eq, one))
                          + torch.where(c_max, one, eq))


def _down(x, k):
    """x[s - k] along the state axis, NEG where s < k."""
    return F.pad(x, (k, 0), value=NEG)[:, :x.shape[1]]


def _up(x, k):
    """x[s + k] along the state axis, NEG where s + k >= S."""
    return F.pad(x, (0, k), value=NEG)[:, k:]


def _step(alpha, emit_t, can_skip, valid_s, lse3=_lse3):
    """One frame of the alpha recursion (``ops/ctc.py:_step``)."""
    a2 = torch.where(can_skip > 0, _down(alpha, 2), NEG)
    nxt = lse3(alpha, _down(alpha, 1), a2) + emit_t
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


def ctc_alphas_plain(emit, in_mask, valid_s, can_skip, lse3=_lse3
                     ) -> torch.Tensor:
    """The alpha recursion of ``_ctc_alphas_pallas``: alpha_0 = emit_0 on
    the valid states s <= 1 (frame 0's mask is not read), then one
    ``_step`` per frame, frozen where ``in_mask`` is 0. Returns alphas
    [B,T,S]. ``lse3``: the log-sum-exp's spelling."""
    S = emit.shape[2]
    s_idx = torch.arange(S, device=emit.device)[None, :]
    alpha = torch.where((s_idx <= 1) & (valid_s > 0), emit[:, 0], NEG)
    alphas = [alpha]
    for t in range(1, emit.shape[1]):
        nxt = _step(alpha, emit[:, t], can_skip, valid_s, lse3)
        alpha = torch.where(in_mask[:, t, None] > 0, nxt, alpha)
        alphas.append(alpha)
    return torch.stack(alphas, dim=1)


def ctc_forward_plain(emit, in_mask, valid_s, can_skip, ext_lens,
                      lse3=_lse3) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alphas [B,T,S], ll [B]): the forward the kernel computes."""
    alphas = ctc_alphas_plain(emit, in_mask, valid_s, can_skip, lse3)
    return alphas, _final_ll(alphas[:, -1], ext_lens)


def ctc_betas_plain(emit, in_mask, valid_s, can_skip, ext_lens, lse3=_lse3
                    ) -> torch.Tensor:
    """The beta recursion of ``paddle_tpu/ops/ctc.py:_ctc_bwd`` (suffix
    scores without the frame's own emission; frozen where frame t+1 is
    padding). Returns betas [B,T,S]."""
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
        prev = lse3(y, _up(y, 1), _up(y, 2) + skip_fwd)
        prev = torch.where(valid_s > 0, prev, NEG)
        beta = torch.where(in_mask[:, t + 1, None] > 0, prev, beta)
        betas.append(beta)
    return torch.stack(betas[::-1], dim=1)


def ctc_posterior_plain(alphas, betas, ll, g, in_mask) -> torch.Tensor:
    """d ll / d emit_t[s] = exp(min(alpha_t + beta_t - ll, 30)) times
    ``g`` [B] and ``in_mask`` (``_ctc_bwd``'s last lines): [B,T,S]."""
    post = torch.exp(torch.clamp_max(alphas + betas - ll[:, None, None],
                                     30.0))
    return g[:, None, None] * post * in_mask[:, :, None]


def ctc_bwd_plain(emit, in_mask, valid_s, can_skip, ext_lens, alphas, ll,
                  g, lse3=_lse3) -> torch.Tensor:
    """The backward of ``paddle_tpu/ops/ctc.py:_ctc_bwd`` in plain PyTorch:
    the beta recursion, then the posterior. Returns demit [B,T,S]."""
    betas = ctc_betas_plain(emit, in_mask, valid_s, can_skip, ext_lens,
                            lse3)
    return ctc_posterior_plain(alphas, betas, ll, g, in_mask)


def extended_labels(labels, label_mask, blank):
    """The blank-interleaved extended labels of ``paddle_tpu/layers/
    chain.py:ctc_loss``: ext [B, S] = [blank, l1, blank, l2, ..., blank]
    (S = 2 L + 1, long), ext_lens [B] = 2 L_b + 1 (int32, L_b the sum of
    ``label_mask``), valid_s [B, S] (s < ext_lens) and can_skip [B, S] (the
    jump from s-2 to s: ext[s] is no blank and differs from ext[s-2]),
    both bool."""
    B, S = labels.shape[0], 2 * labels.shape[1] + 1
    dev = labels.device
    ext = torch.full((B, S), int(blank), dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    ext_lens = 2 * label_mask.sum(dim=1).to(torch.int32) + 1
    valid_s = torch.arange(S, device=dev)[None, :] < ext_lens[:, None]
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long,
                                   device=dev), ext], dim=1)[:, :S]
    can_skip = (ext != blank) & (ext != ext_m2)
    return ext, ext_lens, valid_s, can_skip


def _fused_operands(log_probs, labels, label_mask, blank):
    """The gathered operands of the fused form: (emit [B,T,S], valid_s,
    can_skip, ext_lens, ext), ext blank past each transcript (a padded
    label slot is never read: whatever it holds, the result is a zero's)."""
    ext, ext_lens, valid_s, can_skip = extended_labels(labels, label_mask,
                                                       blank)
    ext = torch.where(valid_s, ext, int(blank))
    B, T, _ = log_probs.shape
    emit = torch.gather(log_probs, 2,
                        ext[:, None, :].expand(B, T, ext.shape[1]))
    dt = log_probs.dtype
    return emit, valid_s.to(dt), can_skip.to(dt), ext_lens, ext


def ctc_fused_forward_plain(log_probs, labels, in_mask, label_mask, blank
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(alphas, betas [B,T,S], ll [B]) from the log-probs: what
    ``ctc_fused_fwd(..., grad=True)`` computes."""
    emit, valid_s, can_skip, ext_lens, _ = _fused_operands(
        log_probs, labels, label_mask, blank)
    in_mask = in_mask.to(log_probs.dtype)
    alphas, ll = ctc_forward_plain(emit, in_mask, valid_s, can_skip,
                                   ext_lens)
    betas = ctc_betas_plain(emit, in_mask, valid_s, can_skip, ext_lens)
    return alphas, betas, ll


def class_sums_plain(demit, ext, num_classes) -> torch.Tensor:
    """d [B,T,C]: for each (b, t, c) the sum of demit over the states s
    with ext[b, s] = c, added in ascending s from 0, as the posterior
    pass of ``csrc/ctc.cu`` adds them (and autograd's scatter-add on the
    CPU): one state at a time."""
    B, T, S = demit.shape
    out = demit.new_zeros((B, T, num_classes))
    for s in range(S):
        out.scatter_add_(2, ext[:, None, s:s + 1].expand(B, T, 1),
                         demit[:, :, s:s + 1])
    return out


def ctc_fused_bwd_plain(labels, in_mask, label_mask, blank, num_classes,
                        alphas, betas, ll, g) -> torch.Tensor:
    """d ll / d log_probs [B,T,C] times ``g`` and ``in_mask``: the
    posteriors summed per class (``class_sums_plain``); what
    ``ctc_fused_bwd`` computes."""
    ext, _, valid_s, _ = extended_labels(labels, label_mask, blank)
    ext = torch.where(valid_s, ext, int(blank))
    demit = ctc_posterior_plain(alphas, betas, ll, g,
                                in_mask.to(alphas.dtype))
    return class_sums_plain(demit, ext, num_classes)


def chain_floor_plain(T, P, beta=False) -> torch.Tensor:
    """What ``ctc_chain_floor`` computes: T frames of the chain's step over
    32 P states (x_i = -i / 2, emissions -3 - i / (32 P), odd states jump),
    then each lane's sum of its P states: [32]."""
    n = 32 * P
    i = torch.arange(n, dtype=torch.float32)[None, :]
    x = -0.5 * i
    e = -3.0 - i * (1.0 / n)
    gate = (i.long() % 2 == 1).float()
    valid = torch.ones_like(x)
    for _ in range(T):
        if beta:
            u = x + e
            x = torch.where(valid > 0, _lse3(
                u, _down(u, 1), torch.where(gate > 0, _down(u, 2), NEG)),
                NEG)
        else:
            x = _step(x, e, gate, valid)
    return x.view(32, P).sum(dim=1)


# -------------------------------------------------------------- kernels
def _check_gathered(kernel, emit, in_mask, valid_s, can_skip, ext_lens,
                    more=()):
    """Every check of the gathered operands (and ``more``: (name, tensor,
    shape)) in one pass (``build.check_cell``; the per-tensor messages on
    failure). Returns (the card's index, B, T, S)."""
    if emit.dim() != 3:
        raise ValueError(f"{kernel}: emit must be [B, T, S], got "
                         f"{tuple(emit.shape)}")
    B, T, S = emit.shape
    if T < 1 or S < 1:
        raise ValueError(
            f"{kernel}: T={T}, S={S}: the kernels take T >= 1 and S >= 1 "
            "extended label states (S = 2 L + 1)")
    idx, _ = build.check_cell(kernel, (
        ("emit", emit, (B, T, S)), ("in_mask", in_mask, (B, T)),
        ("valid_s", valid_s, (B, S)), ("can_skip", can_skip, (B, S)))
        + tuple(more))
    if ext_lens.dtype is not torch.int32 or ext_lens.get_device() != idx \
            or not ext_lens.is_contiguous() or ext_lens.shape != (B,):
        raise ValueError(f"{kernel}: ext_lens must be a contiguous int32 "
                         f"[{B}] tensor on cuda:{idx}, got {ext_lens.dtype} "
                         f"{tuple(ext_lens.shape)} on {ext_lens.device}")
    return idx, B, T, S


def ctc_alpha_fwd(emit, in_mask, valid_s, can_skip, ext_lens):
    """The forward kernel's wrapper, the gathered form; same arguments and
    results as ``ctc_forward_plain``. ``ctc_alpha_fwd.launches`` counts
    the calls that launched it."""
    if emit.device.type == "cpu":
        return ctc_forward_plain(emit, in_mask, valid_s, can_skip, ext_lens)
    idx, B, T, S = _check_gathered("ctc_alpha_fwd", emit, in_mask, valid_s,
                                   can_skip, ext_lens)
    alphas = emit.new_empty((B, T, S))
    ll = emit.new_empty((B,))
    err = build.call(build.bind("ctc", "ctc_alpha_fwd", 7, 3), idx,
                     emit.data_ptr(), in_mask.data_ptr(), valid_s.data_ptr(),
                     can_skip.data_ptr(), ext_lens.data_ptr(),
                     alphas.data_ptr(), ll.data_ptr(), B, T, S)
    build.raise_on(err, "ctc_alpha_fwd")
    ctc_alpha_fwd.launches += 1
    return alphas, ll


ctc_alpha_fwd.launches = 0


def ctc_bwd(emit, in_mask, valid_s, can_skip, ext_lens, alphas, ll, g):
    """The backward kernel's wrapper, the gathered form (the beta chain
    from the saved alphas and ll); same arguments and result as
    ``ctc_bwd_plain``. Each (b, t, s) of demit is written once: no
    atomics, two runs give the same bits."""
    if emit.device.type == "cpu":
        return ctc_bwd_plain(emit, in_mask, valid_s, can_skip, ext_lens,
                             alphas, ll, g)
    B = emit.shape[0]
    idx, B, T, S = _check_gathered(
        "ctc_bwd", emit, in_mask, valid_s, can_skip, ext_lens,
        (("alphas", alphas, emit.shape), ("ll", ll, (B,)), ("g", g, (B,))))
    demit = emit.new_empty((B, T, S))
    # the wide route's frame rows: 2 S floats a chain
    scratch = emit.new_empty((B, 2 * S)) if S > MAX_STATES and B else None
    err = build.call(build.bind("ctc", "ctc_bwd", 10, 3), idx,
                     emit.data_ptr(), in_mask.data_ptr(), valid_s.data_ptr(),
                     can_skip.data_ptr(), ext_lens.data_ptr(),
                     alphas.data_ptr(), ll.data_ptr(), g.data_ptr(),
                     demit.data_ptr(),
                     None if scratch is None else scratch.data_ptr(),
                     B, T, S)
    build.raise_on(err, "ctc_bwd")
    ctc_bwd.launches += 1
    return demit


ctc_bwd.launches = 0


def _check_fused(kernel, labels, in_mask, label_mask, blank, C,
                 tensors=()):
    """Every check of the fused operands in one pass: ``tensors`` (name,
    tensor, shape) and the masks contiguous float32 on one card, labels
    [B,L] contiguous int32 or int64 there, 0 <= blank < C. Any S and C.
    Returns (the card's index, B, T, L)."""
    if labels.dim() != 2 or in_mask.dim() != 2:
        raise ValueError(f"{kernel}: labels and in_mask must be [B, L] and "
                         f"[B, T], got {tuple(labels.shape)} and "
                         f"{tuple(in_mask.shape)}")
    (B, L), T = labels.shape, in_mask.shape[1]
    if T < 1 or C < 1 or not 0 <= blank < C:
        raise ValueError(
            f"{kernel}: T={T}, C={C}, blank={blank}: the kernels take "
            f"T >= 1 and 0 <= blank < C")
    idx, _ = build.check_cell(kernel, tuple(tensors) + (
        ("in_mask", in_mask, (B, T)), ("label_mask", label_mask, (B, L))))
    if labels.dtype not in (torch.int32, torch.int64) \
            or labels.get_device() != idx or not labels.is_contiguous():
        raise ValueError(f"{kernel}: labels must be a contiguous int32 or "
                         f"int64 tensor on cuda:{idx}, got {labels.dtype} "
                         f"on {labels.device}")
    return idx, B, T, L


def ctc_fused_fwd(log_probs, labels, in_mask, label_mask, blank, grad=False,
                  negate=False):
    """The fused forward kernel's wrapper: ll [B] from log_probs [B,T,C],
    labels [B,L] (int32 or int64), in_mask [B,T], label_mask [B,L] (f32);
    with ``grad`` (ll, alphas, betas), the beta chains on blocks of the
    same launch; with ``negate`` -ll in place of ll (the loss). Plain
    version ``ctc_fused_forward_plain``."""
    if log_probs.device.type == "cpu":
        alphas, betas, ll = ctc_fused_forward_plain(log_probs, labels,
                                                    in_mask, label_mask,
                                                    blank)
        ll = -ll if negate else ll
        return (ll, alphas, betas) if grad else ll
    if log_probs.dim() != 3:
        raise ValueError(f"ctc_fused_fwd: log_probs must be [B, T, C], got "
                         f"{tuple(log_probs.shape)}")
    B, T, C = log_probs.shape
    idx, B, T, L = _check_fused("ctc_fused_fwd", labels, in_mask,
                                label_mask, blank, C,
                                (("log_probs", log_probs, (B, T, C)),))
    S = 2 * L + 1
    ll = log_probs.new_empty((B,))
    alphas = betas = None
    if grad:
        alphas = log_probs.new_empty((B, T, S))
        betas = log_probs.new_empty((B, T, S))
    # the wide route's frame rows: 2 S floats a chain
    scratch = (log_probs.new_empty(((2 if grad else 1) * B, 2 * S))
               if S > MAX_STATES and B else None)
    err = build.call(
        build.bind("ctc", "ctc_fused_fwd", 8, 7), idx, log_probs.data_ptr(),
        labels.data_ptr(), in_mask.data_ptr(), label_mask.data_ptr(),
        None if alphas is None else alphas.data_ptr(),
        None if betas is None else betas.data_ptr(), ll.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, T, L, C,
        int(blank), int(labels.dtype is torch.int64), int(negate))
    build.raise_on(err, "ctc_fused_fwd")
    ctc_fused_fwd.launches += 1
    return (ll, alphas, betas) if grad else ll


ctc_fused_fwd.launches = 0


def ctc_fused_bwd(labels, in_mask, label_mask, blank, num_classes, alphas,
                  betas, ll, g, negate=False):
    """The posterior pass's wrapper: d ll / d log_probs [B,T,C] times ``g``
    [B] and ``in_mask``, from the fused forward's alphas, betas and ll
    (with ``negate``: the forward's -ll, and g the cotangent of -ll). g
    may be a strided view (an expanded one too). Each (b, t, c) is one sum
    in a fixed order: two runs give the same bits. Plain version
    ``ctc_fused_bwd_plain``."""
    if alphas.device.type == "cpu":
        if negate:
            ll, g = -ll, -g
        return ctc_fused_bwd_plain(labels, in_mask, label_mask, blank,
                                   num_classes, alphas, betas, ll, g)
    B, T, S = alphas.shape
    idx, B, T, L = _check_fused(
        "ctc_fused_bwd", labels, in_mask, label_mask, blank, num_classes,
        (("alphas", alphas, (B, T, 2 * labels.shape[-1] + 1)),
         ("betas", betas, (B, T, S)), ("ll", ll, (B,))))
    if g.dtype is not torch.float32 or g.get_device() != idx \
            or g.shape != (B,):
        raise ValueError(f"ctc_fused_bwd: g must be a float32 [{B}] tensor "
                         f"on cuda:{idx}, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")
    dlp = alphas.new_empty((B, T, num_classes))
    # the sorted route's class-ranked states: S ints a sequence
    order = (torch.empty((B, S), dtype=torch.int32, device=alphas.device)
             if ctc_plan(S, num_classes)["bwd"] == "sorted" else None)
    err = build.call(
        build.bind("ctc", "ctc_fused_bwd", 9, 8), idx, labels.data_ptr(),
        in_mask.data_ptr(), label_mask.data_ptr(), alphas.data_ptr(),
        betas.data_ptr(), ll.data_ptr(), g.data_ptr(), dlp.data_ptr(),
        None if order is None else order.data_ptr(), B, T, L, num_classes,
        int(blank), int(labels.dtype is torch.int64), int(negate),
        g.stride(0))
    build.raise_on(err, "ctc_fused_bwd")
    ctc_fused_bwd.launches += 1
    return dlp


ctc_fused_bwd.launches = 0


def ctc_chain_floor(T: int, P: int, beta: bool = False,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """The chain-floor microkernel (card only): one warp runs T frames of
    the chain's step at P states a lane (1, 2, 4, 8 or 16), with the lane
    exchange and no global memory: its time over T is a frame's least
    latency, the unit of the chain bound. Returns [32], the result of
    ``chain_floor_plain``."""
    out = torch.empty(32, device=device or "cuda")
    err = build.call(build.bind("ctc", "ctc_chain_floor", 1, 3),
                     out.get_device(), out.data_ptr(), T, P, int(beta))
    build.raise_on(err, "ctc_chain_floor")
    return out


# ------------------------------------------------------------- autograd
class CtcFunction(torch.autograd.Function):
    """The custom gradient of the CTC log-likelihood (JAX ``_ctc_core``
    with ``_ctc_fwd`` / ``_ctc_bwd``), the gathered form: the forward
    kernel saves the alphas and ll, the backward kernel runs the beta
    recursion and writes the state posteriors. Only ``emit`` gets a
    gradient."""

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


class CtcFusedFunction(torch.autograd.Function):
    """The custom gradient of the CTC log-likelihood (or, with
    ``negate``, the loss -ll) from the log-probs: the forward runs both
    chains in one launch and saves the alphas, betas and its output; the
    backward is the posterior pass, which writes the gradient into the
    log-probs. Only ``log_probs`` gets a gradient."""

    @staticmethod
    def forward(ctx, log_probs, labels, in_mask, label_mask, blank, negate):
        ll, alphas, betas = ctc_fused_fwd(log_probs, labels, in_mask,
                                          label_mask, blank, grad=True,
                                          negate=negate)
        ctx.save_for_backward(labels, in_mask, label_mask, alphas, betas,
                              ll)
        ctx.blank, ctx.num_classes, ctx.negate = (blank, log_probs.shape[2],
                                                  negate)
        return ll

    @staticmethod
    def backward(ctx, g):
        labels, in_mask, label_mask, alphas, betas, ll = ctx.saved_tensors
        dlp = ctc_fused_bwd(labels, in_mask, label_mask, ctx.blank,
                            ctx.num_classes, alphas, betas, ll, g,
                            ctx.negate)
        return dlp, None, None, None, None, None


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


def ctc_ll_from_log_probs(log_probs, labels, in_mask, label_mask, blank,
                          negate=False) -> torch.Tensor:
    """Log-likelihood [B] of the CTC paths (with ``negate`` the loss -ll)
    from log_probs [B,T,C], labels [B,L] ints (no blanks), in_mask [B,T],
    label_mask [B,L] and the blank id: ``layers/chain.py:ctc_loss``'s
    operands. On the card the fused kernels (``CtcFusedFunction`` when
    log_probs wants a gradient, else the alpha chains alone; the sign is
    taken in them); on the CPU the plain composition (``extended_labels``,
    the gather, ``ctc_ll``, autograd's scatter). Labels past a
    transcript's length are never read."""
    dt = log_probs.dtype
    in_mask, label_mask = in_mask.to(dt), label_mask.to(dt)
    if log_probs.device.type == "cpu":
        emit, valid_s, can_skip, ext_lens, _ = _fused_operands(
            log_probs, labels, label_mask, blank)
        ll = ctc_ll(emit, in_mask, valid_s, can_skip, ext_lens)
        return -ll if negate else ll
    if labels.dtype not in (torch.int32, torch.int64):
        labels = labels.long()
    args = (log_probs.contiguous(), labels.contiguous(),
            in_mask.contiguous(), label_mask.contiguous(), int(blank))
    if torch.is_grad_enabled() and log_probs.requires_grad:
        return CtcFusedFunction.apply(*args, bool(negate))
    return ctc_fused_fwd(*args, negate=bool(negate))

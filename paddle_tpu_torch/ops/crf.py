"""Linear-chain CRF: the CUDA kernels and their plain versions.

The port's counterpart of ``paddle_tpu/ops/crf.py``. On the TPU the alpha
recursion is one Pallas kernel (``_crf_kernel``) over the class axis padded
to 128 lanes, and the backward (``_crf_bwd``) and the Viterbi decode
(``paddle_tpu/layers/chain.py:crf_decode``) are ``lax.scan``s. Here all
three are hand-written CUDA kernels of ``csrc/crf.cu`` (its source note
gives the design and the bound on the H100). The class axis is not padded:
the TPU's padded classes are exact zeros of the exp-space product, so
leaving them out gives the same numbers.

Three kernel wrappers, each counting the calls that launched its kernels
(``.launches``) and choosing by device: on a CUDA tensor it launches the
kernels (or raises), on a CPU tensor it runs its plain PyTorch version,
which the CPU tests hold against the JAX package.

- ``crf_alpha_fwd``: every alpha [B,T,C] and log Z [B], any C, one
  launch: up to 32 classes a warp a sequence, above a block a sequence
  (the beta chain's step on the transposed matrix); plain version
  ``crf_forward_plain``.
- ``crf_bwd``: the analytic backward (dx, dtrans, da, db), any C, two
  launches: up to 32 classes one block a sequence (a chain warp hands each
  step's betas to worker warps that sum the pairwise marginals) and the
  fixed-order sum over the batch; above, the beta chain and then the
  parallel marginal pass, which also sums over the batch; plain version
  ``crf_bwd_plain``.
- ``crf_viterbi``: the best path [B,T] (int32) and its score [B], any C,
  one launch, its back-pointers in shared memory; plain version
  ``crf_viterbi_plain``.

``crf_plan`` gives each kernel's variant and shared memory at (T, C) by the
formulas of ``csrc/crf.cu`` (held equal on the card through
``plan_of_kernel``). ``crf_log_z`` takes ``crf_alpha_fwd`` alone when no
gradient is wanted and otherwise ``CrfFunction``, whose backward is
``crf_bwd``.

bfloat16 (``--compute_dtype bfloat16``: the linear-CRF tagger hands its
bf16 emissions to the CRF; the layer casts the mask to x's dtype, as
JAX's does). The reference's kernel is dtype-generic: at bf16 its alphas
live in bf16 (``_crf_kernel``'s scratch), exp(alpha - m) is computed in
bf16, the product with exp(trans - tm) (itself bf16) is summed in f32 and
rounded, and ``log(max(s, 1e-37)) + m + tm + x_t`` rounds at each
operation; log Z's epilogue rounds each operation, its sum once. The
backward (``_crf_bwd``) and the Viterbi (``crf_decode``) are scans whose
every operation rounds to bf16. The plain versions keep those rounding
points for bf16 operands (computing in f32 and rounding after each
operation, ``_rounder``), with two departures, both the kernels'
arithmetic: the marginal sums (dtrans, da, db) add in f32 and round once
(JAX adds each step's sum into a bf16 accumulator), and the products sum
in f32 in their own order. On the card the C <= 32 kernels have a bf16
form with the same rounding points (``csrc/crf.cu``, templated on the
storage type; counted in ``.bf16_launches``); a bf16 call with C > 32
(the block forms) raises: those forms are still to port.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops import build
from paddle_tpu_torch.ops.lstm import _rounder

# csrc/crf.cu's plan constants
WARPS = 4               # sequences a warp-variant block (C <= 32)
BLOCK_THREADS = 1024    # a block variant's most threads
TILE_BYTES = 4 * 8 * 32 * 33   # the transpose tiles of 8 warps
MARG_THREADS = 256      # the marginal pass: a tile's dtrans entries
MARG_SMEM = 16 * 256    # its list of 256 pairs (offset, weight, log Z)
TARGET_BLOCKS = 264     # marginal blocks wanted: two an SM
MIN_PAIRS = 32          # pairs a chunk at least
RING = 32               # betas in flight from the chain warp to the workers


# ----------------------------------------------------------------- plan
def _block_parts(C: int) -> int:
    """Lanes a row (the beta chain) or column (the Viterbi) of a block
    variant: 2 up to C = 512, 1 above."""
    return 2 if C <= 512 else 1


def _block_threads(C: int, K: int) -> int:
    return 32 * -(-min(C * K, BLOCK_THREADS) // 32)


def _e_stride(C: int, K: int) -> int:
    """exp(trans - max)'s row stride in shared memory: = K mod 32, so that
    the K parts of 32 / K rows fall in 32 banks."""
    return C + (K - C) % 32


def _t_stride(C: int, K: int) -> int:
    """trans's row stride in shared memory: = 32 / K mod 32 (the K parts of
    32 / K columns in 32 banks)."""
    return C + (32 // K - C) % 32


def _beta_plan(C: int) -> dict:
    if C <= 32:  # the one-launch kernel: E, the ring of betas, progress
        return dict(variant="warp", threads=256, parts=1, ld=C | 1,
                    matrix_in_smem=True, giant=False,
                    smem=4 * (C * (C | 1) + 2 * RING * 32 + 64 + 8))
    K = _block_parts(C)
    red, vec, mat = 4 * 32, 16 * C, 4 * C * _e_stride(C, K)
    if red + vec + mat <= build.SMEM_BYTES:
        return dict(variant="block", threads=_block_threads(C, K), parts=K,
                    ld=_e_stride(C, K), matrix_in_smem=True, giant=False,
                    smem=red + vec + mat)
    # E read from L2: 4 lanes a row up to C = 256, more loads in flight
    K = 4 if C <= 256 else K
    giant = red + vec + TILE_BYTES > build.SMEM_BYTES
    return dict(variant="block", threads=_block_threads(C, K), parts=K, ld=0,
                matrix_in_smem=False, giant=giant,
                smem=red + (0 if giant else vec) + TILE_BYTES)


def _viterbi_plan(T: int, C: int) -> dict:
    bp_bytes = 1 if C <= 256 else (2 if C <= 65536 else 4)
    bp = T * C * bp_bytes  # a sequence's back-pointers
    if C <= 32:  # trans's columns in registers
        base = 4 * WARPS * 64
        in_smem = base + WARPS * bp <= build.SMEM_BYTES
        plan = dict(variant="warp", threads=32 * WARPS, parts=1, ld=C,
                    matrix_in_smem=True, bp_in_smem=in_smem, giant=False,
                    smem=base + (WARPS * bp if in_smem else 0))
    else:
        K = _block_parts(C)
        red, vec, mat = 4 * 64, 16 * C, 4 * C * _t_stride(C, K)
        giant = red + vec > build.SMEM_BYTES
        used = red + (0 if giant else vec)
        mat_in = used + mat <= build.SMEM_BYTES
        used += mat if mat_in else 0
        bp_in = used + bp <= build.SMEM_BYTES
        used += bp if bp_in else 0
        plan = dict(variant="block", threads=_block_threads(C, K), parts=K,
                    ld=_t_stride(C, K) if mat_in else 0,
                    matrix_in_smem=mat_in, bp_in_smem=bp_in, giant=giant,
                    smem=used)
    stride = (8 * C if plan["giant"] else 0) + (0 if plan["bp_in_smem"]
                                                else bp)
    return dict(plan, bp_bytes=bp_bytes, scratch_per_row=-(-stride // 16) * 16)


def _fwd_plan(C: int, in_global: bool = False) -> dict:
    """The forward (``csrc/crf.cu:alpha_plan``): C <= 32 a warp a sequence,
    E in shared memory at row stride C; above, a block a sequence, K lanes
    a column, E at a column stride = 32 / K mod 32 where it fits beside the
    vectors alpha and p: K = 4 where that fits (C <= 232), else 2 (C <=
    239); else each block's copy of E in scratch read from L2 (4 lanes a
    column up to C = 256); ``in_global`` forces the copy at the shared
    path's K (the same bits). ``scratch_floats_per_row``: a sequence's
    scratch in the block variant."""
    if C <= 32:
        return dict(variant="warp", threads=32 * WARPS, parts=1,
                    ld=0 if in_global else C, matrix_in_smem=not in_global,
                    giant=False, scratch_floats_per_row=0,
                    smem=4 * (32 * WARPS + 32 + (0 if in_global else C * C)))
    red, vec = 4 * 32, 8 * C
    mat = lambda K: 4 * C * _t_stride(C, K)  # noqa: E731
    K = 4 if C <= 256 and red + vec + mat(4) <= build.SMEM_BYTES \
        else _block_parts(C)
    if red + vec + mat(K) <= build.SMEM_BYTES:  # E fits beside the vectors
        on_chip = not in_global
        return dict(variant="block", threads=_block_threads(C, K), parts=K,
                    ld=_t_stride(C, K) if on_chip else 0,
                    matrix_in_smem=on_chip, giant=False,
                    scratch_floats_per_row=0 if on_chip else C * C,
                    smem=red + vec + (mat(K) if on_chip else 0))
    K = 4 if C <= 256 else _block_parts(C)
    giant = red + vec > build.SMEM_BYTES
    return dict(variant="block", threads=_block_threads(C, K), parts=K, ld=0,
                matrix_in_smem=False, giant=giant,
                scratch_floats_per_row=C * C + (2 * C if giant else 0),
                smem=red + (0 if giant else vec))


@functools.lru_cache(maxsize=None)
def fwd_work_floats(B: int, C: int, in_global: bool = False) -> int:
    """Floats of ``crf_alpha_fwd``'s scratch (``csrc/crf.cu:
    fwd_work_floats``): each block's copy of E where it is not in shared
    memory (ceil(B / ``WARPS``) blocks at C <= 32, B above), then each
    sequence's alpha and p [2, C] where the vectors outgrow shared
    memory. 0 at the tagger's shapes."""
    plan = _fwd_plan(C, in_global)
    blocks = B if plan["variant"] == "block" else -(-B // WARPS)
    return ((0 if plan["matrix_in_smem"] else blocks * C * C)
            + (2 * B * C if plan["giant"] else 0))


def crf_plan(T: int, C: int) -> dict:
    """The kernels' layout at T steps and C classes, by the formulas of
    ``csrc/crf.cu`` (``alpha_plan``, ``beta_plan``, ``viterbi_plan``): for
    the forward (``fwd``), the backward's beta chain (``bwd``) and the
    Viterbi (``viterbi``), the ``variant`` (``warp``: C <= 32, a warp a
    sequence, ``WARPS`` a block; ``block``: a block a sequence, ``parts``
    lanes a row or column), its ``threads``, whether its [C, C] matrix
    sits in shared memory (``matrix_in_smem``, at row stride ``ld``; else
    global: the forward and the backward a copy a sequence, the Viterbi
    trans itself), whether its per-class vectors outgrow shared memory
    (``giant``) and its dynamic shared memory ``smem``. The forward adds
    ``scratch_floats_per_row``; the Viterbi ``bp_in_smem`` (its T x C
    back-pointers; else spilled to scratch), ``bp_bytes`` and
    ``scratch_per_row`` (bytes of scratch a sequence). ``floor``: the
    chain floors' threads (each runs its chain's block) and shared
    memory."""
    if T < 1 or C < 1:
        raise ValueError(f"crf_plan: T={T}, C={C}: the kernels take T >= 1 "
                         "and C >= 1")
    Cw = max(C, 32)
    fwd, bwd, vit = _fwd_plan(C), _beta_plan(C), _viterbi_plan(T, C)
    return dict(fwd=fwd, bwd=bwd, viterbi=vit, floor=dict(
        beta_threads=32 if C <= 32 else bwd["threads"],
        viterbi_threads=32 if C <= 32 else vit["threads"],
        alpha_threads=32 if C <= 32 else fwd["threads"],
        smem=4 * (32 + 2 * C + 2 * Cw) + 2 * 16 * C))


def crf_marginal_plan(B: int, T: int, C: int) -> dict:
    """The marginal pass's grid: tiles of ``ti`` x ``tj`` dtrans entries
    (``tj`` = min(C, 32), ``MARG_THREADS`` threads, one an entry),
    ``chunks`` of ``chunk_len``
    consecutive (b, t) pairs (b-major, t < T - 1): enough blocks to fill the
    card (``TARGET_BLOCKS``) with at least ``MIN_PAIRS`` pairs a chunk."""
    tj = min(C, 32)
    ti = MARG_THREADS // tj
    tiles_i, tiles_j = -(-C // ti), -(-C // tj)
    pairs = B * (T - 1)
    chunks = max(1, min(-(-pairs // MIN_PAIRS),
                        -(-TARGET_BLOCKS // (tiles_i * tiles_j))))
    return dict(ti=ti, tj=tj, tiles=tiles_i * tiles_j, tiles_j=tiles_j,
                chunks=chunks, chunk_len=-(-pairs // chunks))


@functools.lru_cache(maxsize=None)
def bwd_work_floats(B: int, T: int, C: int) -> int:
    """Floats of ``crf_bwd``'s scratch. C <= 32: each sequence's partial
    dtrans [B,C,C] and end terms [B,2,C]. Above: the betas [B,T,C], the end
    terms [B,2,C] (each sequence's da and db), each sequence's transposed
    exp(trans - max) [C,C] where it outgrows shared memory, each sequence's
    vectors [2,C] (``giant``), the chunks' partial dtrans [chunks,C,C] and a
    counter a tile."""
    plan = _beta_plan(C)
    if plan["variant"] == "warp":  # each sequence's partial and end terms
        return B * C * C + B * 2 * C
    m = crf_marginal_plan(B, T, C)
    return (B * T * C + B * 2 * C
            + (B * C * C if not plan["matrix_in_smem"] else 0)
            + (B * 2 * C if plan["giant"] else 0)
            + m["chunks"] * C * C + m["tiles"])


def plan_of_kernel(kernel: int, B: int, T: int, C: int, field: int) -> int:
    """``csrc/crf.cu:crf_plan_query`` (card only: it loads the library), to
    hold ``crf_plan``, ``crf_marginal_plan`` and the scratch sizes
    against."""
    fn = build.load("crf").crf_plan_query
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn(kernel, B, T, C, field)


# ---------------------------------------------------------------- plain
_TINY = 1e-37  # the exp-space sum's floor (``jnp.maximum(s, 1e-37)``)


def _widened(dtype, *ts):
    """The operands and the rounder of ``dtype``: bf16 tensors widened to
    f32 with each result rounded back to bf16 (``_rounder``), what a
    kernel computing in f32 registers and storing bf16 does; for float32
    and float64 the tensors themselves and the identity."""
    if dtype != torch.bfloat16:
        return (*ts, lambda v: v)
    return (*(t.float() for t in ts), _rounder(dtype))


def _exp_shift(trans, r):
    """tm = max(trans) and exp(trans - tm), each operation rounded."""
    tm = trans.max()
    return tm, r(torch.exp(r(trans - tm)))


def _log_floor(s, r):
    """log(max(s, 1e-37)) of the product s rounded to the dtype."""
    tiny = float(r(torch.tensor(_TINY, dtype=torch.float64)))
    return r(torch.log(torch.clamp_min(r(s), tiny)))


def _step(alpha, trans_shift, tm, x_t, r=lambda v: v):
    """One max-shifted exp-space alpha update (``ops/crf.py:_step``),
    each operation rounded by ``r``, the product summed in f32."""
    m = alpha.max(dim=-1, keepdim=True).values
    s = r(torch.exp(r(alpha - m))) @ trans_shift
    return r(r(r(_log_floor(s, r) + m) + tm) + x_t)


def _log_sum_exp(v, r=lambda v: v):
    m = v.max(dim=-1, keepdim=True).values
    return r(m[:, 0] + r(torch.log(r(r(torch.exp(r(v - m))).sum(dim=-1)))))


def crf_forward_plain(x, mask, trans, a, b) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Plain PyTorch loop, spelled as ``paddle_tpu/ops/crf.py:
    crf_log_z_ref``. x [B,T,C], mask [B,T], trans [C,C], a, b [C].
    Returns (alphas [B,T,C] with alpha_0 = a + x_0 and alpha frozen on
    padded steps, log Z [B]) in x's dtype; bf16 with the reference
    kernel's rounding points (the module note)."""
    dt = x.dtype
    x, trans, a, b, r = _widened(dt, x, trans, a, b)
    tm, trans_shift = _exp_shift(trans, r)
    alpha = r(a[None, :] + x[:, 0])
    alphas = [alpha]
    for t in range(1, x.shape[1]):
        nxt = _step(alpha, trans_shift, tm, x[:, t], r)
        alpha = torch.where(mask[:, t, None] > 0, nxt, alpha)
        alphas.append(alpha)
    log_z = _log_sum_exp(r(alpha + b[None, :]), r)
    return torch.stack(alphas, dim=1).to(dt), log_z.to(dt)


def crf_log_z_plain(x, mask, trans, a, b) -> torch.Tensor:
    """log Z [B] (``crf_log_z_ref``)."""
    return crf_forward_plain(x, mask, trans, a, b)[1]


def crf_betas_plain(x, mask, trans, b) -> torch.Tensor:
    """The beta recursion of ``paddle_tpu/ops/crf.py:_crf_bwd``, what the
    backward's chain kernel computes: betas [B,T,C] with beta_{T-1} = b and
    beta_{t-1}[i] = logsumexp_j(trans[i,j] + x_t[j] + beta_t[j]), max-shifted
    in exp space, frozen where step t is padding. In x's dtype (bf16:
    every operation rounded, the product summed in f32)."""
    B, T, C = x.shape
    dt = x.dtype
    x, trans, b, r = _widened(dt, x, trans, b)
    tm, trans_shift = _exp_shift(trans, r)  # [prev, next]
    beta = b[None, :].expand(B, C)
    betas = [beta]
    for t in range(T - 1, 0, -1):
        y = r(x[:, t] + beta)
        m = y.max(dim=-1, keepdim=True).values
        prev = r(r(_log_floor(r(torch.exp(r(y - m))) @ trans_shift.T, r)
                   + m) + tm)
        beta = torch.where(mask[:, t, None] > 0, prev, beta)
        betas.append(beta)
    return torch.stack(betas[::-1], dim=1).to(dt)  # [B,T,C], betas[:, t]


def crf_bwd_plain(x, mask, trans, b, alphas, log_z, g):
    """The analytic backward of ``paddle_tpu/ops/crf.py:_crf_bwd`` in plain
    PyTorch: the marginals of log Z weighted by ``g`` [B] (d loss / d log
    Z). Returns (dx [B,T,C], dtrans [C,C], da [C], db [C]) in x's dtype;
    bf16 with ``_crf_bwd``'s rounding points, the sums over steps and
    sequences in f32 and rounded once (the kernels' arithmetic)."""
    T = x.shape[1]
    dt = x.dtype
    betas = crf_betas_plain(x, mask, trans, b)
    x, mask, trans, b, alphas, log_z, g, betas, r = _widened(
        dt, x, mask, trans, b, alphas, log_z, g, betas)
    q = r(torch.exp(r(r(alphas + betas) - log_z[:, None, None])))
    q = r(q * mask[:, :, None])
    dx = r(g[:, None, None] * q)
    # pairwise marginals exp(alpha_{t-1}[i] + trans[i,j] + x_t[j] +
    # beta_t[j] - log Z), exponentiated summed (never factorised, so
    # forbidden transitions at -1e4 cannot overflow)
    dtrans = torch.zeros_like(trans)
    r_next = r(x[:, 1:] + betas[:, 1:])
    pair_m = mask[:, 1:] * mask[:, :-1]
    for t in range(T - 1):
        s = r(r(r(alphas[:, t, :, None] + trans[None])
                + r_next[:, t, None, :]) - log_z[:, None, None])
        p = r(r(torch.exp(torch.clamp_max(s, 30.0)))
              * (pair_m[:, t] * g)[:, None, None])
        dtrans = dtrans + p.sum(dim=0)
    da = r(g[:, None] * q[:, 0]).sum(dim=0)
    q_end = r(torch.exp(r(r(alphas[:, -1] + b[None, :]) - log_z[:, None])))
    db = r(g[:, None] * q_end).sum(dim=0)
    return tuple(t.to(dt) for t in (dx, dtrans, da, db))


def crf_viterbi_plain(x, mask, trans, a, b):
    """Viterbi decode spelled as ``paddle_tpu/layers/chain.py:crf_decode``
    (scores ``alpha_i + trans_ij``, max over i, then ``+ x_j``; ties take
    the first index). Returns (path [B,T] int32, score [B] in x's dtype);
    bf16: each addition rounded, as ``crf_decode``'s at bf16."""
    B, T, C = x.shape
    dt = x.dtype
    x, trans, a, b, r = _widened(dt, x, trans, a, b)
    alpha = r(a[None, :] + x[:, 0])
    ident = torch.arange(C, device=x.device)[None, :].expand(B, C)
    ptrs = []
    for t in range(1, T):
        scores = r(alpha[:, :, None] + trans[None])  # [B, prev, next]
        best = scores.max(dim=1).values
        best_prev = scores.argmax(dim=1)  # the first index among maxima
        live = mask[:, t, None] > 0
        alpha = torch.where(live, r(best + x[:, t]), alpha)
        ptrs.append(torch.where(live, best_prev, ident))
    final = r(alpha + b[None, :])
    score, state = final.max(dim=1).values, final.argmax(dim=1)
    path = [state]
    for ptr in reversed(ptrs):
        state = ptr.gather(1, state[:, None])[:, 0]
        path.append(state)
    return torch.stack(path[::-1], dim=1).to(torch.int32), score.to(dt)


def _floor_inputs(C: int):
    """The chain floor's fixed inputs: r_j = -(j mod 7) / 4 (every row of
    its matrix), x_j = -1/2 - (j mod 5) / 8, the start -(j mod 3) / 2."""
    j = torch.arange(C)
    return (-0.25 * (j % 7)).float(), (-0.5 - 0.125 * (j % 5)).float(), \
        (-0.5 * (j % 3)).float()


FLOOR_VARIANTS = ("beta", "viterbi", "alpha")


def chain_floor_plain(T: int, C: int, variant: str = "beta") -> torch.Tensor:
    """What ``crf_chain_floor`` computes: T steps of the beta recursion
    (``crf_betas_plain`` with trans[i, j] = r_j, x_t = x, mask 1, b = the
    start), of the Viterbi's (``crf_viterbi_plain``'s step, trans[i, j] =
    r_j) or of the alpha recursion (``crf_forward_plain``'s step with
    trans[i, j] = r_i, x_t = x, mask 1) from the start, at C classes.
    Returns [C] the last vector; the Viterbi adds [C] the last step's
    first-index argmax, as floats."""
    r, x, start = _floor_inputs(C)
    if variant == "beta":
        xs = x[None, None, :].expand(1, T + 1, C)
        return crf_betas_plain(xs, torch.ones(1, T + 1),
                               r[None, :].expand(C, C), start)[0, 0]
    if variant == "alpha":  # alpha_0 = 0 + start, then T steps
        xs = torch.cat([start[None], x[None].expand(T, C)])[None]
        zeros = torch.zeros(C)
        return crf_forward_plain(xs, torch.ones(1, T + 1),
                                 r[:, None].expand(C, C), zeros,
                                 zeros)[0][0, -1]
    if variant != "viterbi":
        raise ValueError(f"chain_floor_plain: variant {variant!r} is not one "
                         f"of {FLOOR_VARIANTS}")
    trans = r[None, :].expand(C, C)
    alpha = start[None, :]
    for _ in range(T):
        scores = alpha[:, :, None] + trans[None]
        arg = scores.argmax(dim=1)
        alpha = scores.max(dim=1).values + x[None, :]
    return torch.cat([alpha[0], arg[0].float()])


# -------------------------------------------------------------- kernels
def _check(kernel, x, mask, trans, more):
    """The operands' device, types and shapes in one pass
    (``build.check_cell``; the per-tensor messages on failure): all of
    x's dtype, float32 or (C <= 32) bf16. ``more``: (name, tensor, shape
    by (B, T, C)). Returns (the card's index, B, T, C, whether the bf16
    form runs)."""
    if x.dim() != 3:
        raise ValueError(f"{kernel}: x must be [B, T, C], got "
                         f"{tuple(x.shape)}")
    B, T, C = x.shape
    if T < 1 or C < 1:
        raise ValueError(f"{kernel}: T={T}, C={C} classes: the kernel takes "
                         "T >= 1, C >= 1")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and C > 32:
        raise ValueError(f"{kernel}: bfloat16 at C={C} > 32 classes: the "
                         "block forms have no bf16 form yet (ROADMAP "
                         "Queue 2)")
    dt = x.dtype if bf16 else torch.float32
    idx, _ = build.check_cell(kernel, (
        ("x", x, (B, T, C), dt), ("mask", mask, (B, T), dt),
        ("trans", trans, (C, C), dt),
        *((name, t, shape(B, T, C), dt) for name, t, shape in more)))
    return idx, B, T, C, bf16


_VEC = lambda B, T, C: (C,)  # noqa: E731


@functools.lru_cache(maxsize=None)
def _work_floats(kernel: int, C: int) -> int:
    """Floats of scratch the earlier forward (``kernel`` 0,
    ``crf_alpha_fwd_lanes``) or the inline backward (1) needs at C <= 256:
    2 C^2 + 1 where its matrices outgrow shared memory, else 0
    (``csrc/crf.cu:crf_work_floats``)."""
    fn = build.load("crf").crf_work_floats
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(kernel, C)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def crf_alpha_fwd(x, mask, trans, a, b, *, in_global=False):
    """The forward kernel's wrapper; same arguments and results as
    ``crf_forward_plain``, any C, one launch (``csrc/crf.cu:
    crf_alpha_fwd``), no scratch where E stays in shared memory.
    ``crf_alpha_fwd.launches`` counts the calls that launched it.
    ``in_global`` reads E from each block's copy in global memory even
    where it fits shared memory (the same bits; chip_smoke.py times both
    paths)."""
    if x.device.type == "cpu":
        return crf_forward_plain(x, mask, trans, a, b)
    idx, B, T, C, bf16 = _check("crf_alpha_fwd", x, mask, trans,
                                (("a", a, _VEC), ("b", b, _VEC)))
    dev = x.device
    alphas = torch.empty((B, T, C), dtype=x.dtype, device=dev)
    log_z = torch.empty((B,), dtype=x.dtype, device=dev)
    n = fwd_work_floats(B, C, in_global)
    work = torch.empty((n,), dtype=torch.float32, device=dev) if n else None
    err = build.call(build.bind("crf", "crf_alpha_fwd", 8, 5), idx,
                     x.data_ptr(), mask.data_ptr(), trans.data_ptr(),
                     a.data_ptr(), b.data_ptr(), _ptr(work),
                     alphas.data_ptr(), log_z.data_ptr(), B, T, C,
                     int(in_global), int(bf16))
    build.raise_on(err, "crf_alpha_fwd")
    build.count_launch(crf_alpha_fwd, x)
    return alphas, log_z


crf_alpha_fwd.launches = 0
crf_alpha_fwd.bf16_launches = 0


def crf_bwd(x, mask, trans, b, alphas, log_z, g):
    """The backward kernels' wrapper; same arguments and results as
    ``crf_bwd_plain``, any C. Two launches (``csrc/crf.cu:crf_bwd``): up to
    32 classes each sequence's whole backward in one block, then the sum of
    the sequences' partials; above, the beta chain (betas into scratch),
    then the marginal pass. dtrans, da and db are summed over the batch in
    a fixed order (no float atomics: two runs give the same bits)."""
    if x.device.type == "cpu":
        return crf_bwd_plain(x, mask, trans, b, alphas, log_z, g)
    idx, B, T, C, bf16 = _check("crf_bwd", x, mask, trans, (
        ("b", b, _VEC), ("alphas", alphas, lambda B, T, C: (B, T, C)),
        ("log_z", log_z, lambda B, T, C: (B,)),
        ("g", g, lambda B, T, C: (B,))))
    dev = x.device
    dx = torch.empty((B, T, C), dtype=x.dtype, device=dev)
    dtrans = torch.empty((C, C), dtype=x.dtype, device=dev)
    da = torch.empty((C,), dtype=x.dtype, device=dev)
    db = torch.empty((C,), dtype=x.dtype, device=dev)
    work = torch.empty((bwd_work_floats(B, T, C),), dtype=torch.float32,
                       device=dev)
    err = build.call(build.bind("crf", "crf_bwd", 12, 4), idx,
                     x.data_ptr(), mask.data_ptr(), trans.data_ptr(),
                     b.data_ptr(), alphas.data_ptr(), log_z.data_ptr(),
                     g.data_ptr(), work.data_ptr(), dx.data_ptr(),
                     dtrans.data_ptr(), da.data_ptr(), db.data_ptr(), B, T, C,
                     int(bf16))
    build.raise_on(err, "crf_bwd")
    build.count_launch(crf_bwd, x)
    return dx, dtrans, da, db


crf_bwd.launches = 0
crf_bwd.bf16_launches = 0


@functools.lru_cache(maxsize=None)
def _viterbi_scratch(T: int, C: int) -> int:
    return _viterbi_plan(T, C)["scratch_per_row"]


def crf_viterbi(x, mask, trans, a, b):
    """The Viterbi kernel's wrapper; same arguments and results as
    ``crf_viterbi_plain``: the path is identical, not merely close. Any C;
    one launch, with no scratch where the back-pointers fit shared memory
    (``crf_plan``)."""
    if x.device.type == "cpu":
        return crf_viterbi_plain(x, mask, trans, a, b)
    idx, B, T, C, bf16 = _check("crf_viterbi", x, mask, trans,
                                (("a", a, _VEC), ("b", b, _VEC)))
    dev = x.device
    path = torch.empty((B, T), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=x.dtype, device=dev)
    per_row = _viterbi_scratch(T, C)
    scratch = torch.empty((B * per_row,), dtype=torch.uint8, device=dev) \
        if per_row else None
    err = build.call(build.bind("crf", "crf_viterbi", 8, 4), idx,
                     x.data_ptr(), mask.data_ptr(), trans.data_ptr(),
                     a.data_ptr(), b.data_ptr(), _ptr(scratch),
                     path.data_ptr(), score.data_ptr(), B, T, C, int(bf16))
    build.raise_on(err, "crf_viterbi")
    build.count_launch(crf_viterbi, x)
    return path, score


crf_viterbi.launches = 0
crf_viterbi.bf16_launches = 0


def crf_chain_floor(T: int, C: int, variant: str = "beta",
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """The chain-floor microkernel (card only): one block (a warp at C <=
    32) runs T steps of the backward's beta step, the Viterbi's step or
    the forward's alpha step (``variant``) with no global memory: its time
    over T is a step's least latency, the unit of the chain bound. Returns
    what ``chain_floor_plain`` does."""
    out = torch.empty((2 * C if variant == "viterbi" else C,),
                      device=device or "cuda")
    err = build.call(build.bind("crf", "crf_chain_floor", 1, 3),
                     out.get_device(), out.data_ptr(), T, C,
                     FLOOR_VARIANTS.index(variant))
    build.raise_on(err, "crf_chain_floor")
    return out


# ------------------------------------------------------------- autograd
class CrfFunction(torch.autograd.Function):
    """The custom gradient of log Z (JAX ``_crf_core`` with ``_crf_fwd`` /
    ``_crf_bwd``): the forward kernel saves the alphas and log Z, the
    backward kernels compute the marginals from them. mask gets no
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

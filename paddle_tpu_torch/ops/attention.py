"""Flash attention: the CUDA kernels and their plain versions.

The port's counterpart of ``paddle_tpu/ops/attention.py``. On the TPU the
forward is one Pallas kernel (``_flash_kernel``: grid (batch·heads,
q-blocks, kv-blocks), the accumulator in VMEM across the kv sweep) and the
backward is ``jax.vjp`` of ``blockwise_attention``, a recompute through a
``lax.scan``. Here both are hand-written CUDA kernels of
``csrc/flash_attn.cu`` (its source note gives the design and the bound on
the H100): the forward, and the FA2-style analytic backward from the
saved row statistics, every product on the tensor cores in split TF32
(``split_tf32_einsum`` is that arithmetic in plain PyTorch; ``flash_plan``
gives the kernels' tiles and shared memory).

Two kernel wrappers, each counting the calls that launched its kernels
(``.launches``) and choosing by device: on a CUDA tensor it launches (or
raises), on a CPU tensor it runs its plain PyTorch version, which the CPU
tests hold against the JAX package.

- ``flash_fwd``: o [B,N,Tq,D] and the row statistics ``lse`` [2, B·N, Tq]
  (``lse[0]`` the row max m, ``lse[1]`` log l: the row log-sum-exp
  m + log l kept as its two terms, so that a row whose every key is masked,
  m = -1e9, keeps log l); plain version ``blockwise_plain``.
- ``flash_bwd``: (dq, dk, dv) from q, k, v, the mask, o, ``lse`` and dO;
  plain version ``flash_bwd_plain``.

Their launch path is the recurrent cells' (``build.check_cell``: every
check in one pass; ``build.call``: PyTorch's current stream, a device
guard only off the current device); without a mask the kernels take a
null pointer (every key real).

The tensor-core kernels are instantiated for D in ``HEAD_DIMS``; on the
card another D <= 128 is padded with zero columns up to the next instance
and the results sliced back (``fwd_padded``, ``bwd_padded``), with the
scale of the true D. 128 < D <= ``WIDE_MAX_D`` takes the wide-head path
of the same entries (split TF32 on the tensor cores too, any D there: a
block of 16 rows, D padded to whole chunks of 64 columns streamed through
a ring; each score summed by one warp over all of D, each output column
by one warp over the keys), and any wider head the split-row path (a
block a row, its D split across the block's warps, the partial dots
added in a fixed order).

``mha_plain`` is the plain softmax attention, the ground truth of the
tests. ``flash_attention`` takes ``flash_fwd`` alone when no gradient is
wanted and otherwise ``FlashFunction``, whose backward is ``flash_bwd``.
The plain versions take any float type.

bfloat16 (``--compute_dtype bfloat16``: seq2seq's self-attention block
hands flash bf16 q, k and v). The reference's Pallas kernel is
dtype-generic; at bf16 it computes (``_flash_kernel``, block 256): s =
q k^T of the bf16 operands summed in f32, times the scale in f32, the
mask as ``_NEG``; m and l in f32, l summing the unrounded f32 p; the
accumulator adds p rounded to bf16 times v, summed in f32; o = acc / l
rounded to bf16. ``blockwise_plain`` keeps exactly those rounding points
for bf16 q (bit-equal to the interpreted Pallas kernel within one kv
block; beyond, the online softmax's rescaling points are the kernel's).
The backward (JAX: ``jax.vjp`` of ``blockwise_attention`` at bf16, which
rounds the scores and their cotangents to bf16) is here the analytic
one on the widened bf16 operands, summed in f32, dq, dk and dv rounded
to bf16 (``flash_bwd_plain``), within 2e-2 of JAX's largest entry. On
the card both have a bf16 form for D <= 128 (``csrc/flash_attn.cu``, the
``_bf16`` kernels: bf16 tiles in shared memory by cp.async, ldmatrix,
``mma.sync`` m16n8k16 bf16 with f32 sums for every product of two bf16
values; P and dS, which are not bf16 values, split into bf16 hi + lo
terms; instances ``BF16_HEAD_DIMS``, a narrower head padded to the next
one; ``flash_plan(D, bf16=True)``; counted in ``.bf16_launches``); a
bf16 tensor with a wider head (the wide and split forms) raises: those
forms are still to port. The mask stays f32.

A query row that sees no key (an all-padding kv row, or with ``causal``
and Tq > Tk the first Tq - Tk rows) gets JAX's result: JAX pads Tk to a
multiple of ``min(256, Tk)`` with masked zero keys, so such a row's output
is ``sum_{j<Tk} v_j / Tk_pad``, its dv share ``dO / Tk_pad`` and its dq 0.
``blockwise_plain`` pads the same way; the kernels give such rows that
rule of their own (``csrc/flash_attn.cu``) and keep the causal block skips
for every row that sees a key.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops import build

_NEG = -1e9
# the kv block of the plain online softmax: what JAX's flash_attention
# passes to blockwise_attention on the CPU
_PLAIN_BLOCK_K = 256
# the head widths the tensor-core kernels are instantiated for
# (csrc/flash_attn.cu); another D up to the last pads with zero columns to
# the next one
HEAD_DIMS = (8, 16, 32, 64, 128)
# the bf16 form's instances (an mma's k is 16 bf16 values)
BF16_HEAD_DIMS = (16, 32, 64, 128)
# the widest head of the wide-head path (csrc/flash_attn.cu: kWideMaxD),
# which takes every D above HEAD_DIMS[-1] up to it; the split-row path
# takes every D above it
WIDE_MAX_D = 1024


def _default_scale(q, scale):
    return scale if scale is not None else q.shape[-1] ** -0.5


def _causal_visible(Tq, Tk, k0, width, device):
    """[Tq, width] bool: key k0 + j visible from query i, ``kj <= qi + (Tk -
    Tq)`` (``mha_reference``'s causal offset)."""
    qi = torch.arange(Tq, device=device)[:, None] + (Tk - Tq)
    kj = k0 + torch.arange(width, device=device)[None, :]
    return kj <= qi


# ---------------------------------------------------------------- plain
def _round_tf32(x):
    """float32 x rounded to TF32, 10 mantissa bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``; finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32_einsum(eq, a, b):
    """The kernels' product in plain PyTorch: ``torch.einsum(eq, a, b)``
    of float32 operands, each split into big = TF32(x) and small =
    TF32(x - big), summed as small·big' + big·small' + big·big' (the
    term small·small' dropped), as the kernels' ``mma.sync`` tiles sum
    them."""
    a_big, b_big = _round_tf32(a), _round_tf32(b)
    a_small, b_small = _round_tf32(a - a_big), _round_tf32(b - b_big)
    return (torch.einsum(eq, a_small, b_big)
            + torch.einsum(eq, a_big, b_small)) \
        + torch.einsum(eq, a_big, b_big)


def mha_plain(q, k, v, kv_mask=None, causal=False, scale=None):
    """Plain softmax attention, spelled as ``paddle_tpu/ops/attention.py:
    mha_reference``. q [B,N,Tq,D], k/v [B,N,Tk,D], kv_mask [B,Tk]."""
    scale = _default_scale(q, scale)
    s = torch.einsum("bnqd,bnkd->bnqk", q, k) * scale
    if kv_mask is not None:
        s = s.masked_fill(~(kv_mask[:, None, None, :] > 0), _NEG)
    if causal:
        Tq, Tk = s.shape[-2:]
        s = s.masked_fill(~_causal_visible(Tq, Tk, 0, Tk, s.device), _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnqk,bnkd->bnqd", p, v)


def blockwise_plain(q, k, v, kv_mask=None, causal=False, scale=None,
                    einsum=torch.einsum):
    """The online softmax over kv blocks of ``blockwise_attention``
    (``paddle_tpu/ops/attention.py:54-102``, ``block_k = min(256, Tk)``), a
    Python loop for its ``lax.scan``. Returns o [B,N,Tq,D] and the row
    statistics [2, B·N, Tq] (m, log l) the backward takes. ``einsum``
    computes its two products (``split_tf32_einsum``: the kernel's
    arithmetic)."""
    B, N, Tq, D = q.shape
    Tk = k.shape[2]
    scale = _default_scale(q, scale)
    bf16 = q.dtype == torch.bfloat16
    if bf16:  # the Pallas kernel's operands: bf16 products summed in f32
        q, k, v = q.float(), k.float(), v.float()
    block_k = min(_PLAIN_BLOCK_K, Tk)
    pad = (-Tk) % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        base = kv_mask if kv_mask is not None else q.new_ones((B, Tk))
        kv_mask = F.pad(base, (0, pad))
    acc = q.new_zeros((B, N, Tq, D))
    m_run = q.new_full((B, N, Tq), _NEG)
    l_run = q.new_zeros((B, N, Tq))
    for k0 in range(0, k.shape[2], block_k):
        s = einsum("bnqd,bnkd->bnqk", q, k[:, :, k0:k0 + block_k]) * scale
        if kv_mask is not None:
            s = s.masked_fill(
                ~(kv_mask[:, None, None, k0:k0 + block_k] > 0), _NEG)
        if causal:
            s = s.masked_fill(
                ~_causal_visible(Tq, Tk, k0, block_k, s.device), _NEG)
        m_new = torch.maximum(m_run, s.max(dim=-1).values)
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(dim=-1)
        if bf16:  # p rounded to v's dtype (``p.astype(v.dtype)``)
            p = p.to(torch.bfloat16).float()
        acc = acc * alpha[..., None] + einsum(
            "bnqk,bnkd->bnqd", p, v[:, :, k0:k0 + block_k])
        m_run = m_new
    lse = torch.stack([m_run, torch.log(l_run)]).reshape(2, B * N, Tq)
    o = acc / l_run[..., None]
    return (o.to(torch.bfloat16) if bf16 else o), lse


def flash_bwd_plain(q, k, v, kv_mask, o, lse, do, causal=False,
                    scale=None, einsum=torch.einsum):
    """The analytic backward in plain PyTorch: P recomputed from the row
    statistics, ``delta = rowsum(dO o)``, ``dV = Pᵀ dO``, ``dS = P (dO Vᵀ -
    delta)`` zeroed where a score was masked or causally hidden (as
    ``jnp.where`` gives them no gradient), ``dQ = dS K scale``, ``dK = dSᵀ
    Q scale``. Returns (dq, dk, dv). ``einsum`` computes the five
    products. bf16 operands: widened, the gradient in f32, dq, dk and dv
    rounded to bf16 (the bf16 kernels' arithmetic)."""
    B, N, Tq, _ = q.shape
    Tk = k.shape[2]
    scale = _default_scale(q, scale)
    if q.dtype == torch.bfloat16:
        grads = flash_bwd_plain(*(t.float() for t in (q, k, v)), kv_mask,
                                o.float(), lse, do.float(), causal, scale,
                                einsum)
        return tuple(t.to(torch.bfloat16) for t in grads)
    s = einsum("bnqd,bnkd->bnqk", q, k) * scale
    live = torch.ones((B, 1, Tq, Tk), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        live = live & (kv_mask[:, None, None, :] > 0)
    if causal:
        live = live & _causal_visible(Tq, Tk, 0, Tk, q.device)
    m, log_l = (t.reshape(B, N, Tq, 1) for t in lse)
    p = torch.exp((s.masked_fill(~live, _NEG) - m) - log_l)
    delta = (do * o).sum(dim=-1, keepdim=True)
    dv = einsum("bnqk,bnqd->bnkd", p, do)
    dp = einsum("bnqd,bnkd->bnqk", do, v)
    ds = (p * (dp - delta)).masked_fill(~live, 0.0)
    dq = einsum("bnqk,bnkd->bnqd", ds, k) * scale
    dk = einsum("bnqk,bnqd->bnkd", ds, q) * scale
    return dq, dk, dv


# ------------------------------------------------------ head-width padding
def padded_width(D: int, bf16: bool = False) -> int:
    """The kernels' head width for D: the smallest instance >= D up to
    ``HEAD_DIMS[-1]`` (``BF16_HEAD_DIMS`` for the bf16 form), D itself on
    the wide-head and split-row paths above it. Raises for D < 1."""
    if D < 1:
        raise ValueError(f"head width D={D}: the flash kernels take D >= 1")
    for width in BF16_HEAD_DIMS if bf16 else HEAD_DIMS:
        if D <= width:
            return width
    return D


def _pad_heads(width, *ts):
    return tuple(F.pad(t, (0, width - t.shape[-1])) for t in ts)


def fwd_padded(fwd, width, q, k, v, kv_mask, causal, scale):
    """``fwd`` (a forward with ``flash_fwd``'s arguments and results) at
    head width ``width`` >= D: zero columns of q and k leave every score
    unchanged, zero columns of v give zero columns of o, which are sliced
    away; the row statistics are the same. ``scale`` must be the true D's
    (``D ** -0.5`` by default), passed explicitly."""
    o, lse = fwd(*_pad_heads(width, q, k, v), kv_mask, causal, scale)
    return o[..., :q.shape[-1]].contiguous(), lse


def bwd_padded(bwd, width, q, k, v, kv_mask, o, lse, do, causal, scale):
    """``bwd`` (a backward with ``flash_bwd``'s arguments and results) at
    head width ``width``: o and dO padded with zero columns too (delta =
    rowsum(dO o) is unchanged), dq, dk and dv sliced back to D."""
    D = q.shape[-1]
    grads = bwd(*_pad_heads(width, q, k, v), kv_mask,
                *_pad_heads(width, o), lse, *_pad_heads(width, do), causal,
                scale)
    return tuple(t[..., :D].contiguous() for t in grads)


# -------------------------------------------------------------- kernels
# a block of every kernel owns 64 rows (query rows in the forward and dq,
# keys in dkdv) over 4 warps of 16 (csrc/flash_attn.cu)
FLASH_ROWS = 64
# an H100 SM's shared memory (228 KB) and what the runtime keeps of it for
# each resident block; a block may take at most build.SMEM_BYTES
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024


# the wide-head path (csrc/flash_attn.cu: kWideRows, kWideKeys,
# kWideChunk, kWideWarps, kWideStagesFwd / Bwd): a block's rows, the rows
# of a streamed tile (8 a warp), the columns of a staged chunk (8 a warp),
# the warps, the chunks of the forward's and the backward's rings
WIDE_ROWS = 16
WIDE_KEYS = 64
WIDE_CHUNK = 64
WIDE_WARPS = 8
WIDE_STAGES = dict(fwd=4, dq=2, dkdv=2)
# the split-row path: a block's threads (one row) and the rows a step
# streams (csrc/flash_attn.cu: kSplitThreads, kSplitRows)
SPLIT_THREADS = 256
SPLIT_ROWS = 8


def _wide_plan(D: int) -> dict:
    """The wide-head path at 128 < D <= ``WIDE_MAX_D`` (``wide_smem`` in
    the kernel): a block owns ``rows`` rows (16 queries; 16 keys in dkdv);
    D is padded to ``padded`` (whole ``chunk``s of 64 columns); the
    streamed operand comes in chunks of ``stage_rows`` rows by ``chunk``
    columns through a ring of ``stages[kernel]`` chunks; a product over D
    splits the tile's rows across the 8 warps, a product into D splits the
    chunk's columns (8 a warp); the kernel's instance holds ``instance``
    chunks of accumulators (4, 8, 16). Shared memory: the resident rows
    (q; q and dO; k and v), split into TF32 big and small (2 x 16 x
    ``padded`` words each) where ``presplit[kernel]`` (the forward's
    always, dq's and dkdv's up to the 8-chunk instance), else raw (16 x
    (``padded`` + 4) floats); the ring (rows of ``chunk`` + 4), P split in
    two (2 x 16 x 68) and 272 floats of vectors (the warps' row maxima and
    sums; dq's delta)."""
    padded = -(-D // WIDE_CHUNK) * WIDE_CHUNK
    chunks = padded // WIDE_CHUNK
    instance = 4 if chunks <= 4 else 8 if chunks <= 8 else 16
    presplit = dict(fwd=True, dq=instance <= 8, dkdv=instance <= 8)
    shared = (2 * WIDE_ROWS * (WIDE_KEYS + 4)
              + 2 * WIDE_WARPS * WIDE_ROWS + WIDE_ROWS)
    smem = {name: 4 * (resident * WIDE_ROWS
                       * (2 * padded if presplit[name] else padded + 4)
                       + WIDE_STAGES[name] * WIDE_KEYS * (WIDE_CHUNK + 4)
                       + shared)
            for name, resident in (("fwd", 1), ("dq", 2), ("dkdv", 2))}
    return dict(variant="wide", rows=WIDE_ROWS, stage_rows=WIDE_KEYS,
                chunk=WIDE_CHUNK, stages=dict(WIDE_STAGES), padded=padded,
                instance=instance, presplit=presplit, max_d=WIDE_MAX_D,
                smem=smem)


def wide_parts(blocks: int, D: int, sms: int = build.H100_SMS) -> int:
    """The parts (``gridDim.z``, ``wide_parts`` in the kernel) a wide-head
    launch of ``blocks`` blocks (B N times the row blocks of 16) splits its
    outputs' chunks into: at the 16-chunk instance (D > 512), doubled while
    the blocks stay within the card's ``sms`` SMs and a part keeps a chunk;
    1 below it. Part z's blocks compute the products over D whole and
    those into D for its chunks alone, so every output element is the same
    sum at any number of parts."""
    chunks = -(-D // WIDE_CHUNK)
    parts = 1
    while (_wide_plan(D)["instance"] == 16 and 2 * parts <= chunks
           and blocks * 2 * parts <= sms):
        parts *= 2
    return parts


def _bf16_plan(D: int) -> dict:
    """The bf16 form at an instance of ``BF16_HEAD_DIMS``: bf16 tiles of
    ``ld`` = D (+ 8 where D / 8 is even: an odd number of 16-byte chunks a
    row) elements a row, the forward's kv stages of 64 keys, dq's 32 keys
    at D = 128 (64 below), dkdv's query stages likewise; a stage holds two
    tiles and the mask (or m, log l, delta) as f32."""
    if D not in BF16_HEAD_DIMS:
        raise ValueError(f"flash_plan: D={D} is not a bf16 instance "
                         f"({BF16_HEAD_DIMS})")
    ld = D if (D // 8) % 2 else D + 8
    kv, kv_dq = 64, 32 if D == 128 else 64
    qc = kv_dq
    tile = lambda rows: 2 * rows * ld
    stage = lambda rows, vecs: 2 * tile(rows) + 4 * vecs * rows
    smem = dict(fwd=tile(FLASH_ROWS) + 2 * stage(kv, 1),
                dq=2 * tile(FLASH_ROWS) + 2 * stage(kv_dq, 1)
                + 4 * FLASH_ROWS,
                dkdv=2 * tile(FLASH_ROWS) + 2 * stage(qc, 3) + 4 * 4)
    plan = dict(variant="tensor_cores_bf16", rows=FLASH_ROWS, ld=ld,
                kv_cols=kv, dq_cols=kv_dq, q_cols=qc, max_d=WIDE_MAX_D)
    return plan, smem


def flash_plan(D: int, bf16: bool = False) -> dict:
    """The kernels' tiles and dynamic shared memory at head width ``D``,
    by the formulas of ``csrc/flash_attn.cu`` (``flash_smem``; a card test
    holds the two equal). An instance (``HEAD_DIMS``): ``variant``
    ``tensor_cores``, ``rows`` a block owns, ``kv_cols`` keys a ring stage
    of the forward, ``dq_cols`` of dq, ``q_cols`` queries a stage of dkdv.
    128 < D <= ``WIDE_MAX_D``: ``variant`` ``wide`` (``_wide_plan``). Above:
    ``variant`` ``split``, a block of ``threads`` a row, ``stage_rows``
    streamed rows a step, no dynamic shared memory. All: ``smem_<kernel>``
    bytes and ``blocks_per_sm_<kernel>`` by shared memory, for ``fwd``,
    ``dq`` and ``dkdv``, and ``max_d``, the widest head of the wide
    path. ``bf16``: the bf16 form's plan (``_bf16_plan``; ``flash_bf16_smem``
    in the kernel), at the instances ``BF16_HEAD_DIMS`` only."""
    if bf16:
        plan, smem = _bf16_plan(D)
    elif D > WIDE_MAX_D:
        plan = dict(variant="split", rows=1, threads=SPLIT_THREADS,
                    stage_rows=SPLIT_ROWS, max_d=WIDE_MAX_D)
        smem = dict(fwd=0, dq=0, dkdv=0)
    elif HEAD_DIMS[-1] < D:
        plan = _wide_plan(D)
        smem = plan.pop("smem")
    elif D not in HEAD_DIMS:
        raise ValueError(f"flash_plan: D={D} is not an instance "
                         f"({HEAD_DIMS}) nor above {HEAD_DIMS[-1]}")
    else:
        ld = D + 4  # row stride of every tile, floats
        kv = 32 if D == 128 else 64  # keys a stage, forward
        kv_dq = 16 if D == 128 else 64  # keys a stage, dq
        qc = 16 if D == 128 else 32  # queries a stage, dkdv
        rows = FLASH_ROWS * ld  # a resident tile: q, dO, k or v
        smem = dict(fwd=4 * (rows + 2 * (2 * kv * ld + kv)),
                    dq=4 * (2 * rows + 2 * (2 * kv_dq * ld + kv_dq)
                            + FLASH_ROWS),
                    dkdv=4 * (2 * rows + 2 * (2 * qc * ld + 3 * qc)) + 4 * 4)
        plan = dict(variant="tensor_cores", rows=FLASH_ROWS, kv_cols=kv,
                    dq_cols=kv_dq, q_cols=qc, max_d=WIDE_MAX_D)
    for name, nbytes in smem.items():
        plan["smem_" + name] = nbytes
        plan["blocks_per_sm_" + name] = SM_SMEM_BYTES // (
            nbytes + BLOCK_RESERVED_BYTES)
    return plan


def flash_smem_of_kernel(which: str, D: int, bf16: bool = False) -> int:
    """The dynamic shared memory the kernel ``which`` (``fwd``, ``dq``,
    ``dkdv``) requests at head width D, by its own count (card only: it
    loads the library), to hold ``flash_plan`` against; ``bf16``: the bf16
    form's (``flash_bf16_smem``)."""
    lib = build.load("flash_attn")
    fn = lib.flash_bf16_smem if bf16 else lib.flash_smem
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn(("fwd", "dq", "dkdv").index(which), D)


def _check(kernel, q, k, v, kv_mask, o=None, lse=None, do=None):
    """Every check of the kernels' operands in one pass (``build.
    check_cell``; the per-tensor messages on failure): q [B,N,Tq,D], k and
    v [B,N,Tk,D], the mask [B,Tk] when given and, for the backward, o and
    dO [B,N,Tq,D] and lse [2, B·N, Tq]; contiguous, on one card, q, k, v,
    o and dO all float32 or all bf16 (q's dtype), lse and the mask
    float32. Returns (the card's index, (B, N, Tq, Tk, D))."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{kernel}: q and k must be [B, N, T, D], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, N, Tq, D = q.shape
    Tk = k.shape[2]
    if Tq < 1 or Tk < 1:
        raise ValueError(f"{kernel}: Tq={Tq}, Tk={Tk}: the kernels take "
                         "T >= 1")
    kv = (B, N, Tk, D)
    dt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    tensors = [("q", q, q.shape, dt), ("k", k, kv, dt), ("v", v, kv, dt)]
    if o is not None:
        tensors += [("o", o, q.shape, dt), ("do", do, q.shape, dt),
                    ("lse", lse, (2, B * N, Tq))]
    if kv_mask is not None:
        tensors.append(("kv_mask", kv_mask, (B, Tk)))
    idx, _ = build.check_cell(kernel, tensors)
    return idx, (B, N, Tq, Tk, D)


def _bf16_form(kernel, q):
    """Whether a card call takes the bf16 form: bf16 q with a head of at
    most ``BF16_HEAD_DIMS[-1]``; a wider bf16 head raises."""
    if q.dtype != torch.bfloat16:
        return False
    if q.shape[-1] > HEAD_DIMS[-1]:
        raise ValueError(
            f"{kernel}: a bfloat16 head of D={q.shape[-1]} > "
            f"{HEAD_DIMS[-1]}: the wide-head and split-row kernels have no "
            "bf16 form yet (ROADMAP Queue 2)")
    return True


def flash_fwd(q, k, v, kv_mask=None, causal=False, scale=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's wrapper: (o [B,N,Tq,D] in q's dtype, lse [2,
    B·N, Tq] float32), the results of ``blockwise_plain``. No mask: every
    key real (the kernel takes a null mask). ``flash_fwd.launches`` counts
    the calls that launched the f32 form, ``.bf16_launches`` the bf16
    form's."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return blockwise_plain(q, k, v, kv_mask, causal, scale)
    bf16 = _bf16_form("flash_fwd", q)
    width = padded_width(q.shape[-1], bf16)
    if width != q.shape[-1]:
        return fwd_padded(flash_fwd, width, q, k, v, kv_mask, causal, scale)
    idx, (B, N, Tq, Tk, D) = _check("flash_fwd", q, k, v, kv_mask)
    # the kernels read q, k, v by 16-byte copies
    q, k, v = (build.aligned(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = q.new_empty((2, B * N, Tq), dtype=torch.float32)
    err = build.call(
        build.bind("flash_attn", "flash_fwd", 6, 7, 1), idx, q.data_ptr(),
        k.data_ptr(), v.data_ptr(),
        None if kv_mask is None else kv_mask.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, N, Tq, Tk, D, int(causal), int(bf16),
        float(scale))
    build.raise_on(err, "flash_fwd")
    build.count_launch(flash_fwd, q)
    return o, lse


flash_fwd.launches = 0
flash_fwd.bf16_launches = 0


def flash_bwd(q, k, v, kv_mask, o, lse, do, causal=False, scale=None):
    """The backward kernels' wrapper (``flash_bwd_dq``, then
    ``flash_bwd_dkdv``): (dq, dk, dv), the results of
    ``flash_bwd_plain``, in q's dtype. No float atomics: two runs give the
    same bits."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, kv_mask, o, lse, do, causal, scale)
    bf16 = _bf16_form("flash_bwd", q)
    width = padded_width(q.shape[-1], bf16)
    if width != q.shape[-1]:
        return bwd_padded(flash_bwd, width, q, k, v, kv_mask, o, lse, do,
                          causal, scale)
    idx, (B, N, Tq, Tk, D) = _check("flash_bwd", q, k, v, kv_mask, o, lse,
                                    do)
    q, k, v, o, do = (build.aligned(t) for t in (q, k, v, o, do))
    delta = q.new_empty((B * N, Tq), dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    err = build.call(
        build.bind("flash_attn", "flash_bwd", 11, 7, 1), idx, q.data_ptr(),
        k.data_ptr(), v.data_ptr(),
        None if kv_mask is None else kv_mask.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, N, Tq, Tk, D, int(causal),
        int(bf16), float(scale))
    build.raise_on(err, "flash_bwd")
    build.count_launch(flash_bwd, q)
    return dq, dk, dv


flash_bwd.launches = 0
flash_bwd.bf16_launches = 0


# ------------------------------------------------------------- autograd
class FlashFunction(torch.autograd.Function):
    """The custom gradient of flash attention (JAX ``_flash_core`` with
    ``_flash_fwd`` / ``_flash_bwd``): the forward kernel saves o and the
    row statistics, the backward kernels compute the analytic gradient
    from them (JAX recomputes through ``blockwise_attention`` instead; the
    results agree). The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        o, lse = flash_fwd(q, k, v, kv_mask, causal, scale)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, kv_mask, o, lse, do.contiguous(),
                               ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Flash attention, the counterpart of ``paddle_tpu/ops/attention.py:
    flash_attention``: q [B,N,Tq,D], k/v [B,N,Tk,D], a float kv_mask
    [B,Tk] (> 0 = a real key), the default scale ``D ** -0.5``.
    Differentiable in q, k and v through ``FlashFunction``; without a
    gradient, the forward kernel alone. Inputs of any layout (the heads
    split of a projection is a strided view) are made contiguous here, as
    the kernels take contiguous tensors."""
    scale = _default_scale(q, scale)
    q, k, v = (t.contiguous() for t in (q, k, v))
    if kv_mask is not None:  # f32, or f64 for f64 operands
        kv_mask = kv_mask.to(torch.promote_types(
            q.dtype, torch.float32)).contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashFunction.apply(q, k, v, kv_mask, causal, scale)
    return flash_fwd(q, k, v, kv_mask, causal, scale)[0]

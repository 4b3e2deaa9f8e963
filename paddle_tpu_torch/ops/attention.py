"""Flash attention: the CUDA kernels and their plain versions.

The port's counterpart of ``paddle_tpu/ops/attention.py``. On the TPU the
forward is one Pallas kernel (``_flash_kernel``: grid (batch·heads,
q-blocks, kv-blocks), the accumulator in VMEM across the kv sweep) and the
backward is ``jax.vjp`` of ``blockwise_attention``, a recompute through a
``lax.scan``. Here both are hand-written CUDA kernels of
``csrc/flash_attn.cu`` (its source note gives the design and the bound on
the H100): the forward, and the FA2-style analytic backward from the
saved row statistics.

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

The kernels are instantiated for D in ``HEAD_DIMS``; on the card another
D <= 128 is padded with zero columns up to the next instance and the
results sliced back (``fwd_padded``, ``bwd_padded``), with the scale of
the true D. D > 128 raises.

``mha_plain`` is the plain softmax attention, the ground truth of the
tests. ``flash_attention`` takes ``flash_fwd`` alone when no gradient is
wanted and otherwise ``FlashFunction``, whose backward is ``flash_bwd``.
f32 on the card; the plain versions take any float type.

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
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops import build

_NEG = -1e9
# the kv block of the plain online softmax: what JAX's flash_attention
# passes to blockwise_attention on the CPU
_PLAIN_BLOCK_K = 256
# the head widths the kernels are instantiated for (csrc/flash_attn.cu);
# another D up to the last pads with zero columns to the next one
HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_HEADS_TIMES_BATCH = 65535  # the kernels' grid y


def _default_scale(q, scale):
    return scale if scale is not None else q.shape[-1] ** -0.5


def _causal_visible(Tq, Tk, k0, width, device):
    """[Tq, width] bool: key k0 + j visible from query i, ``kj <= qi + (Tk -
    Tq)`` (``mha_reference``'s causal offset)."""
    qi = torch.arange(Tq, device=device)[:, None] + (Tk - Tq)
    kj = k0 + torch.arange(width, device=device)[None, :]
    return kj <= qi


# ---------------------------------------------------------------- plain
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


def blockwise_plain(q, k, v, kv_mask=None, causal=False, scale=None):
    """The online softmax over kv blocks of ``blockwise_attention``
    (``paddle_tpu/ops/attention.py:54-102``, ``block_k = min(256, Tk)``), a
    Python loop for its ``lax.scan``. Returns o [B,N,Tq,D] and the row
    statistics [2, B·N, Tq] (m, log l) the backward takes."""
    B, N, Tq, D = q.shape
    Tk = k.shape[2]
    scale = _default_scale(q, scale)
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
        s = torch.einsum("bnqd,bnkd->bnqk", q, k[:, :, k0:k0 + block_k]) \
            * scale
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
        acc = acc * alpha[..., None] + torch.einsum(
            "bnqk,bnkd->bnqd", p, v[:, :, k0:k0 + block_k])
        m_run = m_new
    lse = torch.stack([m_run, torch.log(l_run)]).reshape(2, B * N, Tq)
    return acc / l_run[..., None], lse


def flash_bwd_plain(q, k, v, kv_mask, o, lse, do, causal=False,
                    scale=None):
    """The analytic backward in plain PyTorch: P recomputed from the row
    statistics, ``delta = rowsum(dO o)``, ``dV = Pᵀ dO``, ``dS = P (dO Vᵀ -
    delta)`` zeroed where a score was masked or causally hidden (as
    ``jnp.where`` gives them no gradient), ``dQ = dS K scale``, ``dK = dSᵀ
    Q scale``. Returns (dq, dk, dv)."""
    B, N, Tq, _ = q.shape
    Tk = k.shape[2]
    scale = _default_scale(q, scale)
    s = torch.einsum("bnqd,bnkd->bnqk", q, k) * scale
    live = torch.ones((B, 1, Tq, Tk), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        live = live & (kv_mask[:, None, None, :] > 0)
    if causal:
        live = live & _causal_visible(Tq, Tk, 0, Tk, q.device)
    m, log_l = (t.reshape(B, N, Tq, 1) for t in lse)
    p = torch.exp((s.masked_fill(~live, _NEG) - m) - log_l)
    delta = (do * o).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bnqk,bnqd->bnkd", p, do)
    dp = torch.einsum("bnqd,bnkd->bnqk", do, v)
    ds = (p * (dp - delta)).masked_fill(~live, 0.0)
    dq = torch.einsum("bnqk,bnkd->bnqd", ds, k) * scale
    dk = torch.einsum("bnqk,bnqd->bnkd", ds, q) * scale
    return dq, dk, dv


# ------------------------------------------------------ head-width padding
def padded_width(D: int) -> int:
    """The kernels' head width for D: the smallest instance >= D. Raises
    for D above the widest instance."""
    for width in HEAD_DIMS:
        if D <= width:
            return width
    raise ValueError(f"head width D={D} is not supported: the flash kernels "
                     f"take D <= {HEAD_DIMS[-1]}")


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
@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("flash_attn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = [p] * 6 + [i] * 6 + [ctypes.c_float, p]
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_bwd.argtypes = [p] * 11 + [i] * 6 + [ctypes.c_float, p]
    lib.flash_bwd.restype = ctypes.c_int
    return lib


def _check(kernel, q, k, v, kv_mask, **more):
    """The operands' device, types and shapes; returns (device, B, N, Tq,
    Tk, D)."""
    dev = build.cuda_device(kernel, q)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{kernel}: q and k must be [B, N, T, D], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, N, Tq, D = q.shape
    Tk = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head width D={D} is not an instance of "
                         f"the kernels ({HEAD_DIMS}); flash_fwd and "
                         "flash_bwd pad it")
    if Tq < 1 or Tk < 1 or B * N > MAX_HEADS_TIMES_BATCH:
        raise ValueError(f"{kernel}: Tq={Tq}, Tk={Tk}, B*N={B * N}: the "
                         f"kernels take T >= 1 and B*N <= "
                         f"{MAX_HEADS_TIMES_BATCH}")
    build.check_tensors(kernel, dev, q=(q, (B, N, Tq, D)),
                        k=(k, (B, N, Tk, D)), v=(v, (B, N, Tk, D)),
                        kv_mask=(kv_mask, (B, Tk)),
                        **{name: (t, (B, N, Tq, D))
                           for name, t in more.items()})
    return dev, B, N, Tq, Tk, D


def _card_mask(kv_mask, q, Tk):
    return kv_mask if kv_mask is not None else q.new_ones((q.shape[0], Tk))


def flash_fwd(q, k, v, kv_mask=None, causal=False, scale=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's wrapper: (o [B,N,Tq,D], lse [2, B·N, Tq]),
    the results of ``blockwise_plain``.
    ``flash_fwd.launches`` counts the calls that launched it."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return blockwise_plain(q, k, v, kv_mask, causal, scale)
    width = padded_width(q.shape[-1])
    if width != q.shape[-1]:
        return fwd_padded(flash_fwd, width, q, k, v, kv_mask, causal, scale)
    kv_mask = _card_mask(kv_mask, q, k.shape[2])
    dev, B, N, Tq, Tk, D = _check("flash_fwd", q, k, v, kv_mask)
    o = torch.empty_like(q)
    lse = torch.empty((2, B * N, Tq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, N, Tq, Tk, D, int(causal),
            float(scale), stream)
    build.raise_on(err, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_bwd(q, k, v, kv_mask, o, lse, do, causal=False, scale=None):
    """The backward kernels' wrapper (``flash_bwd_dq``, then
    ``flash_bwd_dkdv``): (dq, dk, dv), the results of
    ``flash_bwd_plain``. No float atomics: two runs give the same bits."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, kv_mask, o, lse, do, causal, scale)
    width = padded_width(q.shape[-1])
    if width != q.shape[-1]:
        return bwd_padded(flash_bwd, width, q, k, v, kv_mask, o, lse, do,
                          causal, scale)
    kv_mask = _card_mask(kv_mask, q, k.shape[2])
    dev, B, N, Tq, Tk, D = _check("flash_bwd", q, k, v, kv_mask, o=o, do=do)
    build.check_tensors("flash_bwd", dev, lse=(lse, (2, B * N, Tq)))
    delta = torch.empty((B * N, Tq), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, N, Tq, Tk, D,
            int(causal), float(scale), stream)
    build.raise_on(err, "flash_bwd")
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


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
    if kv_mask is not None:
        kv_mask = kv_mask.to(q.dtype).contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashFunction.apply(q, k, v, kv_mask, causal, scale)
    return flash_fwd(q, k, v, kv_mask, causal, scale)[0]

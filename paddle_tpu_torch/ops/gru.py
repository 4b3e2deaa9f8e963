"""Fused GRU sequence recurrence: the CUDA kernels and their plain versions.

The port's counterpart of ``paddle_tpu/ops/gru.py``. On the TPU the whole
masked recurrence is one Pallas kernel (``_gru_kernel``) in a primal form
for inference and a residual form for training; the backward
(``_bwd_rule``) is a reverse-time ``lax.scan``. Here both are the
hand-written CUDA kernels of ``csrc/gru_seq.cu``, whose source note gives
the design and the bound on the H100. The input projection ``x @ W_in``
stays outside, in the ``fc`` layer.

Two routes, chosen by shape (``gru_route``), never by failure:

- persistent: one cooperative launch per sequence and one per reverse
  chain, each block holding the weights of its slice of hidden units in
  shared memory (``gru_plan`` gives the slice, the grid and the staging
  chunk, and the shared-memory bytes the kernels will ask for);
- two-launch: two launches per step forward and, backward, one
  ``gru_bwd_step`` call per step, for shapes whose weight slice and
  staging do not fit one SM (H above 1524 at B = 16, 1452 at B = 50)
  or H % 4 != 0.

``two_launch=True`` forces the second route (to time both at one shape).
A CUDA tensor launches a kernel or raises; a CPU tensor runs the plain
PyTorch version of the route the card would take, which the CPU tests
hold against the JAX package.

Kernel wrappers, each counting the calls that launched its kernels
(``.launches``) and the device launches (``.step_launches``: 1 per call
on the persistent route, two per step on the other):

- ``gru_seq``: the primal forward (ys, hT); plain ``gru_sequence_plain``.
- ``gru_seq_train``: the residual forward (ys, hs, gates); plain
  ``gru_sequence_residual_plain``.
- ``gru_bwd_chain``: the whole reverse chain (dxs, dh0); plain
  ``gru_bwd_chain_plain``, the kernel's three phases block by block.
- ``gru_bwd_step``: one reverse step (two elementwise kernels, a product
  after each), the two-launch route's; plain ``gru_bwd_step_plain``.

The recurrent weights are ``w_gate`` [H, 2H] and ``w_state`` [H, H]. The
layers pass the two column slices of one [H, 3H] parameter, which are not
contiguous: the kernels take each weight's row stride, and the wrappers
refuse a weight whose columns are not contiguous.

``gru_sequence`` takes the primal kernel when no gradient is wanted and
otherwise ``GruFunction``, whose backward (``gru_backward``) transcribes
``_bwd_rule``: the chain, then ``dWg`` and ``dWs`` as one product each
over T*B rows.

bfloat16. As for the LSTM (``ops/lstm.py``), the reference's bf16
computation is its scan ``gru_sequence_ref`` under ``jax.vjp``: every
operation rounded to bf16, the products once after an f32 sum, sigmoid
as ``1 / (1 + exp(-x))``; its f32 ``ys`` take the last sum of ``h - z*h
+ z*c`` unrounded (XLA elides the round trip into the f32 product with
the mask), ``hT`` stays bf16. The persistent kernels' bf16 form keeps
those rounding points on kernels of their own (``csrc/gru_seq.cu``, last
section: ``gru_bf16_kernel``, ``gru_bf16_chain_kernel``; the recurrent
products on the tensor cores, ``mma.sync`` m16n8k16 with bf16 operands and
f32 sums, the weights resident as bf16, the state and the gradients
exchanged as bf16); its chain computes each step in f32 from the bf16
residuals and rounds where it stores (da_z, da_r, da_c, the dh carry)
and each product once. The bf16 forms' blocks are ``gru_plan(...,
bf16=True)``'s: the f32 route's shapes, a block owning an even number
of units, ``BF16_UNITS`` where it fits and never fewer than the f32
plan's. A mixed call (f32 ``xs``, bf16 weights) takes the float32
kernels on the widened weights. The two-launch route has no bf16 form
and refuses bf16 on the card.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from paddle_tpu_torch.ops import build
from paddle_tpu_torch.ops.build import (H100_SMS, SMEM_BYTES, aligned,
                                        check_weight, device_sms)
from paddle_tpu_torch.ops.lstm import _rounder, _sigmoid, bf16_ld
from paddle_tpu_torch.utils.precision import matmul, result_type

Pair = Tuple[torch.Tensor, torch.Tensor]

# the persistent kernels' constants (csrc/gru_seq.cu: kPThreads, kTileRows,
# kTileCols, kMaxSlices); MIN_CHUNK is the route's own rule
THREADS = 256
TILE_ROWS = TILE_COLS = 4
MAX_SLICES = 32
MIN_CHUNK = 32
PERSISTENT, TWO_LAUNCH = "persistent", "two_launch"
# the bf16 forms (csrc/gru_seq.cu, last section): a warp's ring of k16
# chunks (kBfSlots), the 8 warps' K slices, at most kBfMaxUnits units a
# block; BF16_UNITS is the plan's units where they fit (the faster of 8
# and 16 at the acoustic model's (16, 1024) on the H100, PERF.md)
BF16_SLOTS = 4
BF16_WARPS = 8
BF16_MAX_UNITS = 16
BF16_UNITS = 8


def _cdiv(a, b):
    return -(-a // b)


def gru_units(H, sms=H100_SMS) -> int:
    """Hidden units a persistent block owns: ceil(H / SMs), so that the
    grid, ceil(H / units) blocks, has at most one block per SM."""
    return _cdiv(H, sms)


def gru_partition(H, units) -> List[Tuple[int, int]]:
    """The blocks' unit slices [u0, u1): block p owns
    [p * units, min((p + 1) * units, H))."""
    return [(u0, min(u0 + units, H)) for u0 in range(0, H, units)]


def _slices(B, nc):
    """K slices per product tile (``slices_of`` in the kernel): the
    threads the tiles leave, rounded down to a power of two, at most
    MAX_SLICES; 0 where the tiles outnumber the threads."""
    tiles = _cdiv(B, TILE_ROWS) * _cdiv(nc, TILE_COLS)
    if tiles > THREADS:
        return 0
    s = 1
    while 2 * s <= MAX_SLICES and 2 * s * tiles <= THREADS:
        s *= 2
    return s


def _stage_floats(B, K, chunk):
    return B * K if chunk >= K else 2 * B * chunk


def persistent_smem(B, H, units, chunk, backward) -> int:
    """Shared-memory bytes of a persistent block (``persistent_smem`` in
    the kernel): 3 * units * H resident weights, the staging (B x H where
    ``chunk`` covers H; else two buffers of B x chunk) and what the block
    keeps of its own units: the carries (forward z and h, backward dh)
    and, double-buffered a step ahead, their inputs (forward x and mask;
    backward z, r, c, h_prev, dy and mask)."""
    own = (B * units + 2 * (5 * B * units + B) if backward
           else 2 * B * units + 2 * (3 * B * units + B))
    return 4 * (3 * units * H + _stage_floats(B, H, chunk) + own)


def _chunk(B, H, units, backward):
    """Staging chunk (floats) of the products (each over K = H): all of
    it where it fits beside the weights (every copy in flight at once),
    else the widest two buffers that fit; 0 where fewer than MIN_CHUNK
    columns fit."""
    left = SMEM_BYTES - persistent_smem(B, H, units, 0, backward)
    if left >= 4 * B * H:
        return H
    chunk = left // (8 * B) // 4 * 4
    return chunk if chunk >= MIN_CHUNK else 0


def _tiles_smem(B, H, units, mt, backward):
    """``tiles_smem``: a bf16 block's bytes at ``mt`` m16 tiles a row group
    (see ``bf16_smem``)."""
    nt = 1 if units <= 8 else 2
    sums_ld = 16 * nt + 8
    weights = 2 * 3 * 8 * nt * (bf16_ld(H) + 8)
    ring = 2 * BF16_WARPS * BF16_SLOTS * 16 * mt * 16
    sums = 4 * BF16_WARPS * 16 * mt * sums_ld
    bu = B * units
    own = (4 * bu + 2 * (4 * bu + 4 * B + 8 * bu) if backward
           else 8 * bu + 2 * (4 * B + 6 * bu))
    return weights + max(ring, sums) + own


def bf16_mtiles(B, H, units) -> int:
    """m16 tiles of the bf16 products' row group (``bf16_mtiles``): 1, 2
    or 4 as the batch asks (16, 32, 64 rows; a larger batch loops over
    groups), halved while the chain's block would not fit."""
    mt = 1 if B <= 16 else 2 if B <= 32 else 4
    while mt > 1 and _tiles_smem(B, H, units, mt, True) > SMEM_BYTES:
        mt //= 2
    return mt


def bf16_smem(B, H, units, backward) -> int:
    """Shared-memory bytes of a bf16 block (``bf16_smem`` in the kernel):
    the 3 * 8 * n8-tiles resident weight rows of ``bf16_ld(H)`` + 8 bf16
    (the 16-byte pad keeps ldmatrix off bank conflicts), the 8 warps'
    rings of k16 chunks (``BF16_SLOTS`` of [16 * m16 tiles][16] bf16),
    which then hold their f32 sums, and the own units' state: forward the
    h and z carries (f32) and, double-buffered, the mask (f32) and the x
    columns (bf16); backward the dh carry and, double-buffered, dy and the
    mask (f32) and z, r, c, h_prev (bf16)."""
    return _tiles_smem(B, H, units, bf16_mtiles(B, H, units), backward)


def _bf16_units(B, H, sms):
    """The bf16 forms' units a block: ``BF16_UNITS`` where its blocks fit,
    else the most below it that fit; never fewer than the f32 forms' (the
    grid stays within the card's SMs) and always even (two units a 4-byte
    copy)."""
    least = _cdiv(gru_units(H, sms), 2) * 2
    for u in range(max(BF16_UNITS, least), least - 1, -2):
        if max(bf16_smem(B, H, u, False), bf16_smem(B, H, u, True)) \
                <= SMEM_BYTES:
            return u
    return least


def gru_plan(B, H, sms=H100_SMS, bf16=False) -> dict:
    """The persistent route's plan for a [B, H] recurrence on a card of
    ``sms`` SMs: ``route`` (PERSISTENT where H % 4 == 0, the product tiles
    fit the block and both the forward's and the backward's staging fit
    beside the weights; else TWO_LAUNCH), ``units``, ``grid``, the staging
    ``chunk`` and ``smem`` bytes of the forward and of the backward.
    ``bf16``: the bf16 forms' plan (``units``, ``grid``, ``smem_fwd``,
    ``smem_bwd``), PERSISTENT where the float32 plan is and its blocks
    fit too."""
    if bf16:
        u = _bf16_units(B, H, sms)
        plan = dict(units=u, grid=_cdiv(H, u) if H else 0,
                    smem_fwd=bf16_smem(B, H, u, False),
                    smem_bwd=bf16_smem(B, H, u, True))
        ok = (gru_route(B, H, sms) == PERSISTENT and u % 2 == 0
              and 2 <= u <= BF16_MAX_UNITS and plan["grid"] <= sms
              and max(plan["smem_fwd"], plan["smem_bwd"]) <= SMEM_BYTES)
        plan["route"] = PERSISTENT if ok else TWO_LAUNCH
        return plan
    units = gru_units(H, sms)
    plan = dict(units=units, grid=_cdiv(H, units) if H else 0)
    for kind, backward in (("fwd", False), ("bwd", True)):
        chunk = _chunk(B, H, units, backward) if H else 0
        plan[f"chunk_{kind}"] = chunk
        plan[f"smem_{kind}"] = persistent_smem(B, H, units, chunk, backward)
    ok = (B >= 1 and H >= 4 and H % 4 == 0 and _slices(B, 2 * units) > 0
          and plan["chunk_fwd"] > 0 and plan["chunk_bwd"] > 0)
    plan["route"] = PERSISTENT if ok else TWO_LAUNCH
    return plan


def gru_route(B, H, sms=H100_SMS) -> str:
    """PERSISTENT or TWO_LAUNCH for a [B, H] recurrence (``gru_plan``)."""
    return gru_plan(B, H, sms)["route"]


def persistent_smem_of_kernel(B, H, units, chunk, backward) -> int:
    """The kernel's own count of a persistent block's shared-memory bytes
    (card only: it loads the library), to hold ``persistent_smem``
    against."""
    fn = build.load("gru_seq").gru_persistent_smem
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn(B, H, units, chunk, int(backward))


def bf16_smem_of_kernel(B, H, units, backward) -> int:
    """The kernel's own count of a bf16 block's shared-memory bytes (card
    only), to hold ``bf16_smem`` against."""
    fn = build.load("gru_seq").gru_bf16_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn(B, H, units, int(backward))


def gru_step(x_t, h, w_gate, w_state):
    """One GRU step on the projected input ``x_t`` [B, 3H] (bias folded):
    (z, r, c, h_new), spelled as ``paddle_tpu/ops/gru.py:gru_sequence_ref``
    (``h - z*h + z*c``); mixed operands (an f32 state, bf16 weights)
    promote as JAX's do."""
    H = h.shape[-1]
    zr = x_t[:, :2 * H] + matmul(h, w_gate)
    z = _sigmoid(zr[:, :H])
    r = _sigmoid(zr[:, H:])
    c = torch.tanh(x_t[:, 2 * H:] + matmul(r * h, w_state))
    return z, r, c, h - z * h + z * c


def _ys(h, z, c, h_new, m):
    """The output ``h_new * mask``; in bf16 with the last sum of ``h - z*h
    + z*c`` taken in f32, as the reference's f32 output does (see the
    module note)."""
    if h_new.dtype == torch.float32:
        return h_new * m
    return ((h - z * h).float() + (z * c).float()) * m


def gru_sequence_plain(xs_b, mask, w_gate, w_state, h0) -> Pair:
    """Plain PyTorch loop over time. xs_b [T,B,3H] holds the projected
    inputs with the gate bias folded in, mask [T,B] f32, w_gate [H,2H],
    w_state [H,H], h0 [B,H]. Padded steps hold h and emit ``h_new * m``.
    Returns (ys [T,B,H] (f32), hT)."""
    h = h0
    ys = []
    for t in range(xs_b.shape[0]):
        z, _, c, h_new = gru_step(xs_b[t], h, w_gate, w_state)
        m = mask[t].unsqueeze(-1)
        ys.append(_ys(h, z, c, h_new, m))
        h = torch.where(m > 0, h_new, h)
    if not ys:
        return xs_b.new_zeros(0, *h0.shape, dtype=mask.dtype), h0
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
        ys.append(_ys(h, z, c, h_new, m))
        h = torch.where(m > 0, h_new, h)
        hs.append(h)
        gates.append(torch.cat([z, r, c], dim=-1))
    return torch.stack(ys), torch.stack(hs), torch.stack(gates)


_BF16 = torch.bfloat16


def _seq_args(kernel, xs_b, mask, w_gate, w_state, h0, plan):
    """Checks the sequence operands: xs_b's dtype (float32 or bf16) for
    all but the f32 mask; the two-launch route (``plan`` None) has no bf16
    form. Returns (device, T, B, H, ldg, lds)."""
    dev = build.cuda_device(kernel, xs_b)
    T, B, H3 = xs_b.shape
    H = H3 // 3
    dt = _BF16 if xs_b.dtype == _BF16 else torch.float32
    if dt == _BF16 and plan is None:
        raise ValueError(f"{kernel}: B={B} H={H} is on the two-launch "
                         "route, which has no bfloat16 form")
    build.check_tensors(kernel, dev, xs=(xs_b, (T, B, 3 * H), dt),
                        mask=(mask, (T, B)), h0=(h0, (B, H), dt))
    ldg = check_weight(kernel, dev, "w_gate", w_gate, (H, 2 * H), dt)
    lds = check_weight(kernel, dev, "w_state", w_state, (H, H), dt)
    return dev, T, B, H, ldg, lds


def _persistent_plan(t, B, H, two_launch):
    """The persistent route's plan for the card ``t`` lies on (the bf16
    forms' for a bf16 ``t``), or None for the two-launch route (forced, or
    the shape's)."""
    if two_launch:
        return None
    plan = gru_plan(B, H, device_sms(t), bf16=t.dtype == _BF16)
    return plan if plan["route"] == PERSISTENT else None


def _forward_persistent(kernel, plan, xs_b, mask, w_gate, w_state, h0, ldg,
                        lds, residual):
    """One persistent forward launch in xs_b's dtype: (ys, hT) or,
    ``residual``, (ys, hs, gates); ys f32, the rest in xs_b's dtype. The
    f32 form's primal state ping-pongs in h [2, B, H] (h[0] = h0), its
    residual form's crosses blocks through hs; the bf16 form's through its
    exchange hx ([T + 1 or 2, B, ``bf16_ld(H)``] bf16, h0 in slot 0, zero
    columns past H), of which hs is a view where the stride is H."""
    T, B, _ = xs_b.shape
    H = h0.shape[1]
    dev, dt = xs_b.device, xs_b.dtype
    new = lambda *shape, dtype=dt: torch.empty(shape, dtype=dtype,
                                               device=dev)
    ys = new(T, B, H, dtype=torch.float32)
    gates = new(T, B, 3 * H) if residual else None
    count = torch.empty(1, dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    if dt == _BF16:
        ld = bf16_ld(H)
        hx = (torch.empty if ld == H else torch.zeros)(
            (T + 1 if residual else 2, B, ld), dtype=dt, device=dev)
        hx[0, :, :H].copy_(h0)
        rhx = new(B, ld)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = build.bind("gru_seq", "gru_bf16_forward", 9, 7)(
                aligned(xs_b).data_ptr(), mask.data_ptr(), w_gate.data_ptr(),
                w_state.data_ptr(), hx.data_ptr(), rhx.data_ptr(),
                ys.data_ptr(), ptr(gates), count.data_ptr(), int(residual),
                ldg, lds, T, B, H, plan["units"], stream)
        build.raise_coop(err, kernel, plan)
        hs = hx[1:, :, :H] if residual else hx[T % 2, :, :H]
        hs = hs if ld == H else hs.contiguous()
        return (ys, hs, gates) if residual else (ys, hs)
    hs = new(T, B, H) if residual else None
    h = None
    if not residual:
        h = new(2, B, H)
        h[0].copy_(h0)
    rh = new(B, H)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        # the residual form stages h0 itself with 16-byte copies
        err = build.bind("gru_seq", "gru_seq_forward_persistent", 11, 8)(
            xs_b.data_ptr(), mask.data_ptr(), w_gate.data_ptr(),
            w_state.data_ptr(), aligned(h0).data_ptr(), ptr(h),
            ys.data_ptr(), ptr(hs), ptr(gates), rh.data_ptr(),
            count.data_ptr(), int(residual), ldg, lds, T, B, H,
            plan["units"], plan["chunk_fwd"], stream)
    build.raise_coop(err, kernel, plan)
    return (ys, hs, gates) if residual else (ys, h[T % 2])


def gru_seq(xs_b, mask, w_gate, w_state, h0, two_launch=False) -> Pair:
    """The primal kernel's wrapper; same arguments and results as
    ``gru_sequence_plain``. ``two_launch=True`` forces the two-launch
    route. ``gru_seq.launches`` counts the calls that launched a kernel,
    ``gru_seq.step_launches`` the device launches (1 a call on the
    persistent route, two per timestep on the other). bf16 ``xs_b``
    takes the bf16 form, counted in ``gru_seq.bf16_launches``
    (``build.count_launch``)."""
    args = (xs_b, mask, w_gate, w_state, h0)
    if xs_b.device.type == "cpu":
        return gru_sequence_plain(*args)
    plan = _persistent_plan(xs_b, xs_b.shape[1], xs_b.shape[2] // 3,
                            two_launch)
    dev, T, B, H, ldg, lds = _seq_args("gru_seq", *args, plan)
    if plan is not None:
        out = _forward_persistent("gru_seq", plan, *args, ldg, lds, False)
        build.count_launch(gru_seq, xs_b, 1 if T else 0)
        return out
    h = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    h[0].copy_(h0)
    ys = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    gates = torch.empty((B, 3 * H), dtype=torch.float32, device=dev)
    rh = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("gru_seq", "gru_seq_forward", 8, 5)(
            xs_b.data_ptr(), mask.data_ptr(), w_gate.data_ptr(),
            w_state.data_ptr(), h.data_ptr(), gates.data_ptr(),
            rh.data_ptr(), ys.data_ptr(), ldg, lds, T, B, H, stream)
    build.raise_on(err, "gru_seq")
    build.count_launch(gru_seq, xs_b, 2 * T)
    return ys, h[T % 2]


gru_seq.launches = 0
gru_seq.step_launches = 0
gru_seq.bf16_launches = 0


def gru_seq_train(xs_b, mask, w_gate, w_state, h0, two_launch=False):
    """The residual kernel's wrapper; same arguments and results as
    ``gru_sequence_residual_plain``. Routes and counts as ``gru_seq``."""
    args = (xs_b, mask, w_gate, w_state, h0)
    if xs_b.device.type == "cpu":
        return gru_sequence_residual_plain(*args)
    plan = _persistent_plan(xs_b, xs_b.shape[1], xs_b.shape[2] // 3,
                            two_launch)
    dev, T, B, H, ldg, lds = _seq_args("gru_seq_train", *args, plan)
    if plan is not None:
        out = _forward_persistent("gru_seq_train", plan, *args, ldg, lds,
                                  True)
        build.count_launch(gru_seq_train, xs_b, 1 if T else 0)
        return out
    ys, hs = (torch.empty((T, B, H), dtype=torch.float32, device=dev)
              for _ in range(2))
    gates = torch.empty((T, B, 3 * H), dtype=torch.float32, device=dev)
    rh = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("gru_seq", "gru_seq_forward_train", 9, 5)(
            xs_b.data_ptr(), mask.data_ptr(), w_gate.data_ptr(),
            w_state.data_ptr(), h0.data_ptr(), ys.data_ptr(),
            hs.data_ptr(), gates.data_ptr(), rh.data_ptr(), ldg, lds, T,
            B, H, stream)
    build.raise_on(err, "gru_seq_train")
    build.count_launch(gru_seq_train, xs_b, 2 * T)
    return ys, hs, gates


gru_seq_train.launches = 0
gru_seq_train.step_launches = 0
gru_seq_train.bf16_launches = 0


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


def gru_bwd_chain_plain(dys, mask, gates, h0, hs, w_gate, w_state, dhT,
                        units=None):
    """The reverse chain of ``_bwd_rule`` (``paddle_tpu/ops/gru.py:
    141-161``) as the persistent kernel runs it, in plain PyTorch: per
    reverse step, phase 1 (dh_new, dz, da_c, da_z and the first two terms
    of dh_prev, elementwise), phase 2 (drh = da_c @ Ws^T, dr, da_r,
    + drh * r), phase 3 (+ da_z @ Wg[:, :H]^T, then + da_r @ Wg[:, H:]^T:
    the kernel sums the first while the grid barrier for da_r is still
    open), each phase over the
    blocks' unit slices in order (``units`` units a block as
    ``gru_partition``; None: one slice of all H). Returns (dxs [T, B, 3H],
    dh0).

    bf16 residuals (the bf16 form): every step computes in f32 from them
    and rounds to bf16 where the kernel does: dy, da_z, da_c, da_r, each
    product's result, and the dh carry at the step's last sum; dxs and
    dh0 come back bf16."""
    dt = gates.dtype
    rnd = _rounder(dt)
    gates, h0, hs, w_gate, w_state, dhT = (
        a.float() for a in (gates, h0, hs, w_gate, w_state, dhT))
    T, B, H = hs.shape
    parts = gru_partition(H, units or max(H, 1))
    dxs = torch.empty((T, B, 3 * H), dtype=hs.dtype, device=hs.device)
    dh = dhT.clone()
    for t in range(T - 1, -1, -1):
        m = mask[t].unsqueeze(-1)
        z, r, c = gates[t].split(H, dim=-1)
        h_pv = hs[t - 1] if t else h0
        dx = dxs[t]
        for u0, u1 in parts:  # 1. each block's units, elementwise
            sl = slice(u0, u1)
            d = dh[:, sl]
            dh_new = m * (d + rnd(dys[t][:, sl]))
            dz = dh_new * (c[:, sl] - h_pv[:, sl])
            dx[:, 2 * H + u0:2 * H + u1] = rnd((dh_new * z[:, sl]) * (
                1 - c[:, sl] * c[:, sl]))
            dx[:, u0:u1] = rnd((dz * z[:, sl]) * (1 - z[:, sl]))
            dh[:, sl] = (1 - m) * d + dh_new * (1 - z[:, sl])
        for u0, u1 in parts:  # 2. drh of the block's units from all da_c
            sl = slice(u0, u1)
            drh = rnd(dx[:, 2 * H:] @ w_state[sl].t())
            dr = drh * h_pv[:, sl]
            dx[:, H + u0:H + u1] = rnd((dr * r[:, sl]) * (1 - r[:, sl]))
            dh[:, sl] = dh[:, sl] + drh * r[:, sl]
        for u0, u1 in parts:  # 3a. + da_z @ Wg[:, :H]^T
            sl = slice(u0, u1)
            dh[:, sl] = dh[:, sl] + rnd(dx[:, :H] @ w_gate[sl, :H].t())
        for u0, u1 in parts:  # 3b. + da_r @ Wg[:, H:]^T
            sl = slice(u0, u1)
            dh[:, sl] = rnd(dh[:, sl] + rnd(dx[:, H:2 * H]
                                           @ w_gate[sl, H:].t()))
    return dxs.to(dt), dh.to(dt)


def gru_bwd_chain(dys, mask, gates, h0, hs, w_gate, w_state, dhT):
    """The reverse chain kernel's wrapper (the persistent route); the
    arguments and results of ``gru_bwd_chain_plain``. One cooperative
    launch per call; raises where the shape is not on the route or the
    launch is refused. ``.launches`` counts calls, ``.step_launches``
    device launches."""
    args = (dys, mask, gates, h0, hs, w_gate, w_state, dhT)
    if hs.device.type == "cpu":
        return gru_bwd_chain_plain(*args)
    dev = build.cuda_device("gru_bwd_chain", hs)
    T, B, H = hs.shape
    bh = (B, H)
    dt = hs.dtype if hs.dtype == _BF16 else torch.float32
    build.check_tensors("gru_bwd_chain", dev, dys=(dys, (T, B, H)),
                        mask=(mask, (T, B)),
                        gates=(gates, (T, B, 3 * H), dt), h0=(h0, bh, dt),
                        hs=(hs, (T, B, H), dt), dhT=(dhT, bh, dt))
    ldg = check_weight("gru_bwd_chain", dev, "w_gate", w_gate, (H, 2 * H),
                       dt)
    lds = check_weight("gru_bwd_chain", dev, "w_state", w_state, (H, H), dt)
    plan = _persistent_plan(hs, B, H, False)
    if plan is None:
        raise ValueError(f"gru_bwd_chain: B={B} H={H} is not on the "
                         "persistent route (gru_route); the per-step "
                         "backward (gru_bwd_step) takes it")
    dxs = torch.empty((T, B, 3 * H), dtype=dt, device=dev)
    dh0 = torch.empty(bh, dtype=dt, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if dt == _BF16:
            # the blocks' exchange of da_z, da_r, da_c as bf16, by the
            # step's parity (zeroed by the launcher)
            dax = torch.empty((2, 3, B, bf16_ld(H)), dtype=dt, device=dev)
            err = build.bind("gru_seq", "gru_bf16_chain", 12, 6)(
                dys.data_ptr(), mask.data_ptr(), aligned(gates).data_ptr(),
                aligned(h0).data_ptr(), aligned(hs).data_ptr(),
                w_gate.data_ptr(),
                w_state.data_ptr(), dhT.data_ptr(), dxs.data_ptr(),
                dax.data_ptr(), dh0.data_ptr(), count.data_ptr(), ldg, lds,
                T, B, H, plan["units"], stream)
        else:
            err = build.bind("gru_seq", "gru_bwd_chain_launch", 11, 7)(
                dys.data_ptr(), mask.data_ptr(), gates.data_ptr(),
                h0.data_ptr(), hs.data_ptr(), w_gate.data_ptr(),
                w_state.data_ptr(), dhT.data_ptr(), dxs.data_ptr(),
                dh0.data_ptr(), count.data_ptr(), ldg, lds, T, B, H,
                plan["units"], plan["chunk_bwd"], stream)
    build.raise_coop(err, "gru_bwd_chain", plan)
    build.count_launch(gru_bwd_chain, hs, 1 if T else 0)
    return dxs, dh0


gru_bwd_chain.launches = 0
gru_bwd_chain.step_launches = 0
gru_bwd_chain.bf16_launches = 0


def gru_backward(mask, w_gate, w_state, h0, hs, gates, dys, dhT, step=None,
                 two_launch=False):
    """``_bwd_rule`` (``paddle_tpu/ops/gru.py:135-166``) over the residuals
    of ``gru_seq_train``: returns (dxs, dWg, dWs, dh0). The reverse chain
    is ``gru_bwd_chain`` on the persistent route; on the two-launch route
    (the shape's, or ``two_launch=True``), or where a ``step`` is given,
    one ``step`` per reverse step, by default ``gru_bwd_step`` (the card
    checks pass ``gru_bwd_step_plain`` for the plain backward). The
    weight gradients are one product each over T*B rows after the chain,
    where JAX sums them per step."""
    T, B, H = hs.shape
    dys = dys.contiguous()
    h_prev = torch.cat([h0[None], hs[:-1]], dim=0)
    if hs.dtype == _BF16 or step is None and not two_launch and gru_route(
            B, H, device_sms(hs)) == PERSISTENT:
        dxs, dh = gru_bwd_chain(dys, mask, gates, h0, hs, w_gate, w_state,
                                dhT.contiguous())
    else:
        step = step or gru_bwd_step
        dxs = torch.empty((T, B, 3 * H), dtype=hs.dtype, device=hs.device)
        dh = dhT.contiguous().clone()
        drh = torch.empty_like(dh)
        for t in range(T - 1, -1, -1):
            step(dys[t], mask[t], gates[t], h_prev[t], w_gate, w_state, dh,
                 drh, dxs[t])
    rows = T * B
    dWg = h_prev.reshape(rows, H).t() @ dxs[..., :2 * H].reshape(rows, 2 * H)
    r_h = gates[..., H:2 * H] * h_prev
    dWs = r_h.reshape(rows, H).t() @ dxs[..., 2 * H:].reshape(rows, H)
    return dxs, dWg, dWs, dh


class GruFunction(torch.autograd.Function):
    """The custom gradient of the fused recurrence (JAX ``_gru_core`` with
    ``_fwd_rule`` / ``_bwd_rule``): the residual forward kernel saves
    (hs, gates), the backward replays them in reverse time, on the route
    the forward took."""

    @staticmethod
    def forward(ctx, xs_b, mask, w_gate, w_state, h0, two_launch):
        ys, hs, gates = gru_seq_train(xs_b, mask, w_gate, w_state, h0,
                                      two_launch=two_launch)
        ctx.save_for_backward(mask, w_gate, w_state, h0, hs, gates)
        ctx.two_launch = two_launch
        return ys, hs[-1].clone()

    @staticmethod
    def backward(ctx, dys, dhT):
        dxs, dWg, dWs, dh0 = gru_backward(*ctx.saved_tensors, dys, dhT,
                                          two_launch=ctx.two_launch)
        return dxs, None, dWg, dWs, dh0, None


class _BiasFold(torch.autograd.Function):
    """``xs + bias`` of the bf16 form, whose bias gradient is summed as
    ``jax.vjp`` of ``gru_sequence_ref`` sums it at bf16: the scan's
    transpose reduces each step's cotangent of ``x_t + bias`` over the
    batch (f32 accumulation, rounded to bf16 once a step) and carries the
    bias cotangent in bf16 from the last step to the first, rounding at
    every step. One sum over all T * B rows, rounded once, lies farther
    from the f32 gradient where the steps cancel (a narrow encoder's
    ``wbias``: 0.00100 against JAX's 0.00037, ROADMAP Queue 3)."""

    @staticmethod
    def forward(ctx, xs, bias):
        return xs + bias

    @staticmethod
    def backward(ctx, g):
        steps = g.sum(dim=1)  # [T, 3H], one rounding a step
        if not steps.shape[0]:
            return g, steps.new_zeros(steps.shape[1:])
        acc = steps[-1]
        for t in range(steps.shape[0] - 2, -1, -1):
            acc = acc + steps[t]
        return g, acc


def gru_sequence(xs, mask, w_gate, w_state, bias, h0, reverse=False,
                 two_launch=False) -> Pair:
    """Fused GRU over a padded [T,B,3H] gate-projection sequence, the
    counterpart of ``paddle_tpu/ops/gru.py:gru_sequence``. ``reverse=True``
    runs back to front (flip in, flip out: outputs stay in input time
    order and hT is the state after time 0). Differentiable: with grad
    enabled and an input that requires it, the residual kernel and
    ``GruFunction``'s backward; otherwise the lean primal kernel.
    ``two_launch=True`` forces the two-launch route. The weights may be
    column slices of one [H, 3H] matrix. Returns (ys [T,B,H], hT)."""
    if reverse:
        ys, hT = gru_sequence(xs.flip(0), mask.flip(0), w_gate, w_state, bias,
                              h0, two_launch=two_launch)
        return ys.flip(0), hT
    ops = (xs, w_gate, w_state, bias, h0)
    if result_type(*ops) == torch.float32:
        # f32, or JAX's promoted product of a mixed call: the float32
        # kernels on the exactly widened operands
        xs, w_gate, w_state, bias, h0 = (a.float() for a in ops)
    # fold the bias in once (bf16: the reference's own x_t + bias, rounded,
    # its gradient summed as the reference's scan sums it)
    xs_b = (_BiasFold.apply(xs, bias) if xs.dtype == _BF16 else
            xs + bias).contiguous()
    args = (xs_b, mask.contiguous(), w_gate, w_state, h0.contiguous())
    if xs.shape[0] and torch.is_grad_enabled() and any(
            a.requires_grad for a in args):
        return GruFunction.apply(*args, two_launch)
    return gru_seq(*args, two_launch=two_launch)

"""Fused LSTM sequence recurrence: the CUDA kernels and their plain versions.

The port's counterpart of ``paddle_tpu/ops/lstm.py``. On the TPU the whole
masked recurrence is one Pallas kernel (``_lstm_kernel``, and
``_lstm_kernel_tiled`` for big hidden sizes), in a primal form for
inference and a residual form for training; the backward (``_bwd_rule``)
is a reverse-time ``lax.scan``. Here they are the hand-written CUDA
kernels of ``csrc/lstm_seq.cu``, whose source note gives their design and
their bound on the H100. The input projection ``x @ W_in`` stays outside,
in the ``fc`` layer, exactly as in the JAX package.

Two routes, chosen by shape (``lstm_route``), never by failure:

- persistent: one cooperative launch per sequence and one per reverse
  chain, each block holding its slice of W in shared memory
  (``lstm_plan`` gives the slice, the grids and the
  shared-memory bytes the kernels will ask for);
- per-step: one launch per timestep forward and, backward, one
  ``lstm_bwd_step`` call and one product per step, for shapes whose
  weight slice and staging do not fit one SM (H above 1280 at B = 1, 16
  and 64), with more than 64 rows, or H % 4 != 0.

``per_step=True`` forces the second route (to time both at one shape). A
CUDA tensor launches a kernel or raises; a CPU tensor runs the plain
PyTorch version of the route the card would take, which the CPU tests
hold against the JAX package.

Kernel wrappers, each counting the calls that launched its kernel
(``.launches``) and, where a call may launch more than once, the device
launches (``.step_launches``: 1 a call on the persistent route, T on the
per-step one):

- ``lstm_seq``: the primal forward (ys, hT, cT); plain
  ``lstm_sequence_plain``.
- ``lstm_seq_train``: the residual forward (ys, hs, cs, gates); plain
  ``lstm_sequence_residual_plain``.
- ``lstm_bwd_chain``: the whole reverse chain (dxs, dh0, dc0); plain
  ``lstm_bwd_chain_plain``, arranged as the kernel's blocks.
- ``lstm_bwd_step``: one reverse step of the backward's elementwise
  chain, the per-step route's; plain ``lstm_bwd_step_plain``.

``lstm_sequence`` takes the primal kernel when no gradient is wanted and
otherwise ``LstmFunction``, whose backward (``lstm_backward``) is a
transcription of ``_bwd_rule``: the chain (or the per-step loop), then
``dW`` and the peephole gradients as one product and three sums, where
JAX sums them per step.

bfloat16 (``--compute_dtype bfloat16``). The reference's Pallas kernels
cannot run with bf16 operands and an f32 mask (``ys_ref[0] = h_new * m``
is f32, stored into a bf16 ref), so what the JAX package computes in bf16
is its scan, ``lstm_sequence_ref``, differentiated by ``jax.vjp``: every
operation rounded to bf16 (the recurrent product once, after an f32 sum;
``x_t + h @ w + gate_bias`` in that order, the bias not folded first;
sigmoid as ``1 / (1 + exp(-x))``, three roundings), ``ys = h_new * mask``
promoted to f32 by the f32 mask (XLA takes ``og * tanh(c_new)`` there
before h_new's rounding: ``_ys``), ``hT`` and ``cT`` bf16. The plain
versions run that on bf16 tensors (``_sigmoid``), and the persistent
route has a bf16 form on the tensor cores (``csrc/lstm_seq.cu``:
``lstm_bf16_kernel``, ``lstm_bf16_chain_kernel``; ``mma.sync`` m16n8k16
with bf16 operands and f32 sums, W resident in shared memory as bf16, h_t
and dgates exchanged as bf16) with the same rounding points: the wrappers
take it for bf16 ``xs`` (counted in ``.bf16_launches``) and take the bias
unfolded. Its reverse chain computes each step in f32 from the bf16
residuals and rounds where it stores (dgates, the dh and dc carries) and
the recurrent product once; ``dW`` is one f32-accumulated product rounded
once, where JAX accumulates it in bf16 step by step. A mixed call (f32
``xs`` with bf16 weights: every layer after the first recurrent one,
whose f32 ``ys`` promote what follows) is JAX's promoted f32 product: the
float32 kernels on the exactly widened weights. The bf16 forms keep the
f32 forms' units and grids, so they take every (B, H) of the persistent
route; their shared memory is ``lstm_plan(..., bf16=True)``'s. The
per-step route has no bf16 form and refuses bf16 on the card.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from paddle_tpu_torch.ops import build
from paddle_tpu_torch.ops.build import (H100_SMS, SMEM_BYTES, aligned,
                                        check_weight, device_sms)
from paddle_tpu_torch.utils.precision import result_type

Tensors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# every BASELINE.md rnn-table (batch, hidden) pair, as in
# paddle_tpu/ops/lstm.py:BENCH_SHAPES
BENCH_SHAPES = [(64, 256), (64, 512), (64, 1280), (128, 256), (128, 1280),
                (256, 256), (256, 1280), (512, 512)]

# the persistent kernels' constants (csrc/lstm_seq.cu): the units a block
# may own (the instantiated kernels), the blocks of a chain row group
# (kGroupCols), the most rows
UNITS = (1, 2, 4, 10)
GROUP_COLS = 16
MAX_ROWS = 64
PERSISTENT, PER_STEP = "persistent", "per_step"
# the shared-memory kinds of csrc/lstm_seq.cu:lstm_persistent_smem and
# lstm_bf16_smem
_KINDS = {"fwd": 0, "bwd": 1}


def _cdiv(a, b):
    return -(-a // b)


def lstm_units(H, sms=H100_SMS) -> int:
    """Hidden units a persistent block owns: the fewest of ``UNITS`` whose
    chain grid (the ceil(H / units) slices in whole row groups of
    ``GROUP_COLS`` blocks, ``lstm_chain_grid``) has at most one block per
    SM; where none does, ceil(H / SMs) (a shape off the route)."""
    cap = sms // GROUP_COLS * GROUP_COLS
    return next((u for u in UNITS if _cdiv(H, u) <= cap), _cdiv(H, sms))


def lstm_partition(H, units) -> List[Tuple[int, int]]:
    """The blocks' unit slices [u0, u1): block p owns
    [p * units, min((p + 1) * units, H))."""
    return [(u0, min(u0 + units, H)) for u0 in range(0, H, units)]


def lstm_chain_grid(H, units) -> int:
    """The chain's blocks (``chain_grid``): the unit slices rounded up to
    whole row groups of ``GROUP_COLS``; the last blocks may own no unit."""
    return _cdiv(_cdiv(H, units), GROUP_COLS) * GROUP_COLS


def _lane_rows(B):
    """Rows a lane holds in the chain's product (``lane_rows``): one warp
    covers all B rows, padded to 8 x this."""
    return 1 if B <= 8 else 2 if B <= 16 else 4 if B <= 32 else 8


def _fwd_rows(B):
    """(rows a lane, row warps) of the forward's product (``fwd_rows``);
    the other 8 / row warps split K."""
    return (1, 1) if B <= 8 else (2, 1) if B <= 16 else (4, 1) if B <= 32 \
        else (4, 2)


def _half_rows(rpl):
    """A lane's rows handed over in one round (``half_rows``)."""
    return rpl // 2 if rpl > 1 else 1


def _padded_ld(K):
    """Row stride of a shared-memory matrix (``padded_ld``): an odd number
    of float4s."""
    return 4 * ((K // 4) | 1)


def _chain_bufs(B, H, units):
    """The chain's staging buffers (``chain_bufs``): all R chunks of the
    column group's dgates where they fit beside the weights, else two."""
    R = lstm_chain_grid(H, units) // GROUP_COLS
    weights = GROUP_COLS * units * _padded_ld(4 * units * R)
    chunk = 8 * _lane_rows(B) * _padded_ld(4 * units)
    return R if 4 * (weights + R * chunk) <= SMEM_BYTES else 2


# the forward's staging: each of the 8 warps of a block a ring of SLOTS
# slots of 2 float4s of h for each of its rows (``kSlots``)
WARPS = 8
SLOTS = 3


# the bf16 forms (csrc/lstm_seq.cu, last section): a forward warp's ring
# of k16 chunks of h (kBfSlots)
BF16_SLOTS = 4


def bf16_ld(H) -> int:
    """Row stride of the bf16 forward's exchange of h (``bf16_ld``): H
    rounded up to the mma's k = 16; the columns past H are 0."""
    return _cdiv(H, 16) * 16


def _bf16_mtiles(B):
    """m16 tiles of the batch rows in the bf16 products (``bf16_mtiles``)."""
    return 1 if B <= 16 else 2 if B <= 32 else 4


def chain_la(units) -> int:
    """A block's row of the bf16 chain's dgates exchange (``chain_la``):
    4 * units rounded up to 8 (16-byte copies)."""
    return _cdiv(4 * units, 8) * 8


def _bf16_smem(B, H, units, kind):
    """``bf16_smem``: forward, W's 4 * units columns as bf16 rows in whole
    n8 tiles (``bf16_ld(H)`` + 8 wide, the 16-byte pad keeps ldmatrix off
    bank conflicts) and the warps' rings of h chunks, which then hold the 8
    warps' f32 sums of the product; chain, W's 16 * units rows and the
    staged dgates' rows (16 per m16 tile) over the R chunks of
    ``chain_la`` columns rounded up to 16, + 8."""
    mt = _bf16_mtiles(B)
    if kind == "fwd":
        nt = _cdiv(4 * units, 8)
        sums_ld = 8 * nt + (0 if nt % 2 else 8)
        ring = 2 * WARPS * BF16_SLOTS * 16 * mt * 16
        sums = 4 * WARPS * 16 * mt * sums_ld
        return 2 * 8 * nt * (bf16_ld(H) + 8) + max(ring, sums)
    R = lstm_chain_grid(H, units) // GROUP_COLS
    kp = _cdiv(R * chain_la(units), 16) * 16
    return 2 * (GROUP_COLS * units + 16 * mt) * (kp + 8)


def lstm_smem(B, H, units, kind, bf16=False) -> int:
    """Shared-memory bytes of a persistent block (``lstm_smem`` in the
    kernel). Forward (``kind="fwd"``): the 4 * units resident weight rows
    (H wide, padded to an odd number of float4s) and the 8 warps' staging
    rings of h ([SLOTS][rows][8]), which then hold the K slices' sums on
    their way to warp 0 and the cells' sums. Chain (``"bwd"``): the row
    group's 16 * units weight rows over the column group's 4 * units * R
    columns and the staging of its dgates, which then hold the K halves'
    sums and pass the partial out half the rows at a time. The carries and
    the own inputs live in registers. ``bf16``: the bf16 forms' blocks
    (``_bf16_smem``)."""
    if bf16:
        return _bf16_smem(B, H, units, kind)
    if kind == "fwd":
        rpl, mw = _fwd_rows(B)
        stage = WARPS * SLOTS * 8 * rpl * 8
        sums = max(128 * rpl * units, 32 * rpl * mw * units)
        return 4 * (4 * units * _padded_ld(H) + max(stage, sums))
    rpl = _lane_rows(B)
    R = lstm_chain_grid(H, units) // GROUP_COLS
    return 4 * (GROUP_COLS * units * _padded_ld(4 * units * R)
                + max(_chain_bufs(B, H, units) * 8 * rpl
                      * _padded_ld(4 * units),
                      4 * 32 * _half_rows(rpl) * units,
                      8 * _half_rows(rpl) * (GROUP_COLS * units + 4)))


def lstm_plan(B, H, sms=H100_SMS, bf16=False) -> dict:
    """The persistent route's plan for a [B, H] recurrence on a card of
    ``sms`` SMs: ``units``, the forward's ``grid`` and the chain's
    ``grid_bwd``, and the bytes ``smem_fwd`` / ``smem_bwd`` of the forward
    and of the chain; ``route``: PERSISTENT where 1 <= B <= 64,
    H % 4 == 0, the units are one of ``UNITS`` with the chain grid within
    the card's SMs and both float32 blocks fit the card's limit; else
    PER_STEP. ``bf16``: the bf16 forms' plan, the same units and grids
    with their own blocks' bytes, on the route where the float32 plan is
    and its own blocks fit too (they do at every such shape: at most
    184,960 bytes, at (64, 1280))."""
    units = lstm_units(H, sms)
    ok = 1 <= B <= MAX_ROWS and H >= 4 and H % 4 == 0 and units in UNITS
    smem = lambda kind, bf: lstm_smem(B, H, units, kind, bf) if ok else 0
    plan = dict(units=units, grid=_cdiv(H, units) if H else 0,
                grid_bwd=lstm_chain_grid(H, units) if H else 0,
                smem_fwd=smem("fwd", bf16), smem_bwd=smem("bwd", bf16))
    ok = ok and plan["grid_bwd"] <= sms and max(
        smem("fwd", False), smem("bwd", False), plan["smem_fwd"],
        plan["smem_bwd"]) <= SMEM_BYTES
    plan["route"] = PERSISTENT if ok else PER_STEP
    return plan


def lstm_route(B, H, sms=H100_SMS) -> str:
    """PERSISTENT or PER_STEP for a [B, H] recurrence (``lstm_plan``)."""
    return lstm_plan(B, H, sms)["route"]


def persistent_smem_of_kernel(B, H, units, kind, bf16=False) -> int:
    """The kernel's own count of a persistent block's shared-memory bytes
    (card only: it loads the library), to hold ``lstm_smem`` against;
    ``bf16``: the bf16 forms' (``lstm_bf16_smem``)."""
    lib = build.load("lstm_seq")
    fn = lib.lstm_bf16_smem if bf16 else lib.lstm_persistent_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn(B, H, units, _KINDS[kind])


def _sigmoid(x):
    """``torch.sigmoid`` in float32; below it the reference's spelling,
    ``1 / (1 + exp(-x))`` with each operation rounded (``jax.nn.sigmoid``
    lowers to those three operations)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def _rounder(dtype):
    """x -> x rounded to ``dtype`` and kept in float32: the rounding
    points of a kernel that computes in f32 registers and stores
    ``dtype``; the identity for float32."""
    if dtype == torch.float32:
        return lambda x: x
    return lambda x: x.to(dtype).float()


def _cell(x_t, h, c, w, check_i, check_f, check_o, gate_bias=None):
    """One step of the peephole cell: (i, ig, fg, og, c_new, h_new). With
    ``gate_bias`` (the bf16 form) the reference's ``x_t + h @ w +
    gate_bias``; without, x_t has the bias folded in."""
    a = x_t + h @ w
    if gate_bias is not None:
        a = a + gate_bias
    a_i, a_ig, a_fg, a_og = a.chunk(4, dim=-1)
    i = torch.tanh(a_i)
    ig = _sigmoid(a_ig + c * check_i)
    fg = _sigmoid(a_fg + c * check_f)
    c_new = i * ig + c * fg
    og = _sigmoid(a_og + c_new * check_o)
    return i, ig, fg, og, c_new, og * torch.tanh(c_new)


def _ys(og, c_new, h_new, m):
    """The output ``h_new * mask``. In bf16 the reference's f32 output
    takes the product ``og * tanh(c_new)`` before h_new's rounding (XLA
    widens the f32 multiply's operand back to og and tanh's bf16 values:
    the rounding to bf16 and back is elided), exact in f32; in float32 it
    is h_new."""
    if h_new.dtype == torch.float32:
        return h_new * m
    return og.float() * torch.tanh(c_new).float() * m


def lstm_sequence_plain(xs_b, mask, w, check_i, check_f, check_o, h0,
                        c0, gate_bias=None) -> Tensors:
    """Plain PyTorch loop over time. xs_b [T,B,4H] holds the pre-projected
    inputs with the gate bias folded in (or, bf16, ``gate_bias`` [4H]
    apart), mask [T,B] f32, w [H,4H], the peepholes [H], h0/c0 [B,H].
    Returns (ys [T,B,H], hT, cT); ys is f32 (``h_new * mask``)."""
    h, c = h0, c0
    ys = []
    for t in range(xs_b.shape[0]):
        *_, og, c_new, h_new = _cell(xs_b[t], h, c, w, check_i, check_f,
                                     check_o, gate_bias)
        m = mask[t].unsqueeze(-1)
        h = torch.where(m > 0, h_new, h)
        c = torch.where(m > 0, c_new, c)
        ys.append(_ys(og, c_new, h_new, m))
    if not ys:
        return xs_b.new_zeros(0, *h0.shape, dtype=mask.dtype), h0, c0
    return torch.stack(ys), h, c


def lstm_sequence_residual_plain(xs_b, mask, w, check_i, check_f, check_o,
                                 h0, c0, gate_bias=None):
    """The residual form of ``lstm_sequence_plain`` (JAX ``_lstm_pallas(...,
    with_residuals=True)``): (ys, hs, cs [T,B,H], gates [T,B,4H]) with the
    guarded state chains hs, cs and the activated gates [i|ig|fg|og]."""
    h, c = h0, c0
    ys, hs, cs, gates = [], [], [], []
    for t in range(xs_b.shape[0]):
        i, ig, fg, og, c_new, h_new = _cell(xs_b[t], h, c, w, check_i,
                                            check_f, check_o, gate_bias)
        m = mask[t].unsqueeze(-1)
        h = torch.where(m > 0, h_new, h)
        c = torch.where(m > 0, c_new, c)
        ys.append(_ys(og, c_new, h_new, m))
        hs.append(h)
        cs.append(c)
        gates.append(torch.cat([i, ig, fg, og], dim=-1))
    return (torch.stack(ys), torch.stack(hs), torch.stack(cs),
            torch.stack(gates))


def _cell_grads(dh_in, dc_in, dy_t, m, gates_t, c_new, c_prev, check_i,
                check_f, check_o, rnd=lambda x: x):
    """The elementwise chain of one reverse step of ``_bwd_rule``
    (``paddle_tpu/ops/lstm.py:366-389``, the kernels' order of terms) on
    the carries dh_in (the product of the step after already added) and
    dc_in: (dgates_t [.., 4H], dc_prev, (1 - m) * dh_in). ``rnd``: the
    bf16 form's rounding of dy (the f32 cotangent of ys meets bf16 h_new),
    of dgates_t and of dc_prev (``_rounder``)."""
    H = dh_in.shape[-1]
    i, ig, fg, og = (gates_t[..., k * H:(k + 1) * H] for k in range(4))
    dh_new = m * (dh_in + rnd(dy_t))
    dc_new = m * dc_in
    tc = torch.tanh(c_new)
    da_og = (dh_new * tc) * og * (1 - og)
    dc_tot = dc_new + dh_new * og * (1 - tc * tc) + da_og * check_o
    da_i = dc_tot * ig * (1 - i * i)
    da_ig = (dc_tot * i) * ig * (1 - ig)
    da_fg = (dc_tot * c_prev) * fg * (1 - fg)
    dc_prev = (1 - m) * dc_in + dc_tot * fg + da_ig * check_i \
        + da_fg * check_f
    return (rnd(torch.cat([da_i, da_ig, da_fg, da_og], dim=-1)),
            rnd(dc_prev), (1 - m) * dh_in)


def lstm_bwd_step_plain(dy_t, m_t, gates_t, c_new, c_prev, check_i,
                        check_f, check_o, dhw, dh, dc, dgates_t):
    """One reverse step of ``_bwd_rule`` (``paddle_tpu/ops/lstm.py:366-389``)
    in plain PyTorch, with the arguments and in-place contract of
    ``lstm_bwd_step``: dh holds (1 - m_{t+1}) dh_{t+1} and dhw holds
    dgates_{t+1} @ W^T on entry; dh, dc and dgates_t are written."""
    dg, dc_prev, dh_prev = _cell_grads(dh + dhw, dc, dy_t,
                                       m_t.unsqueeze(-1), gates_t, c_new,
                                       c_prev, check_i, check_f, check_o)
    dc.copy_(dc_prev)
    dh.copy_(dh_prev)
    dgates_t.copy_(dg)


_BF16 = torch.bfloat16


def _seq_args(kernel, xs_b, mask, w, check_i, check_f, check_o, h0, c0,
              gate_bias, plan):
    """Checks the sequence operands: xs_b's dtype (float32, or bf16 with
    the gate bias apart) for all but the f32 mask. Returns (device, T, B,
    H, ldw). The per-step kernels (``plan`` None) take a contiguous f32 w
    and have no bf16 form; the persistent ones any row stride."""
    dev = build.cuda_device(kernel, xs_b)
    T, B, H4 = xs_b.shape
    H = H4 // 4
    bh = (B, H)
    dt = _BF16 if xs_b.dtype == _BF16 else torch.float32
    if dt == _BF16 and plan is None:
        raise ValueError(f"{kernel}: B={B} H={H} is on the per-step route, "
                         "which has no bfloat16 form")
    bias = {} if dt == torch.float32 else dict(
        gate_bias=(gate_bias, (4 * H,), dt))
    build.check_tensors(kernel, dev, xs=(xs_b, (T, B, 4 * H), dt),
                        mask=(mask, (T, B)), check_i=(check_i, (H,), dt),
                        check_f=(check_f, (H,), dt),
                        check_o=(check_o, (H,), dt), h0=(h0, bh, dt),
                        c0=(c0, bh, dt), **bias)
    if plan is not None:
        ldw = check_weight(kernel, dev, "w", w, (H, 4 * H), dt)
    else:
        build.check_tensors(kernel, dev, w=(w, (H, 4 * H)))
        ldw = 4 * H
    return dev, T, B, H, ldw


def _persistent_plan(t, B, H, per_step):
    """The persistent route's plan for the card ``t`` lies on (the bf16
    forms' for a bf16 ``t``), or None for the per-step route (forced, or
    the shape's)."""
    if per_step:
        return None
    plan = lstm_plan(B, H, device_sms(t), bf16=t.dtype == _BF16)
    return plan if plan["route"] == PERSISTENT else None


def _forward_persistent(kernel, plan, xs_b, mask, w, check_i, check_f,
                        check_o, h0, c0, gate_bias, ldw, residual):
    """One persistent forward launch in xs_b's dtype (the f32 or the bf16
    form): (ys, hT, cT) or, ``residual``, (ys, hs, cs, gates); ys is f32,
    the rest in xs_b's dtype. The f32 form writes h_t of every step into
    hs (the blocks' exchange); the bf16 form into its exchange hx [T + 1,
    B, ``bf16_ld(H)``] of bf16 values (h0 in slot 0, zero columns past H),
    of which hs is a view where the stride is H."""
    T, B, _ = xs_b.shape
    H = h0.shape[1]
    dev, dt = xs_b.device, xs_b.dtype
    new = lambda *shape, dtype=dt: torch.empty(shape, dtype=dtype,
                                               device=dev)
    ys = new(T, B, H, dtype=torch.float32)
    cs, gates = (new(T, B, H), new(T, B, 4 * H)) if residual else (None,
                                                                   None)
    c = None if residual else c0.clone()
    count = torch.empty(1, dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    bf16 = dt == _BF16
    if bf16:
        ld = bf16_ld(H)
        hx = (torch.empty if ld == H else torch.zeros)(
            (T + 1, B, ld), dtype=dt, device=dev)
        hx[0, :, :H].copy_(h0)
    else:
        hx = new(T, B, H)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if bf16:
            err = build.bind("lstm_seq", "lstm_bf16_forward", 14, 6)(
                xs_b.data_ptr(), mask.data_ptr(), w.data_ptr(),
                check_i.data_ptr(), check_f.data_ptr(), check_o.data_ptr(),
                gate_bias.data_ptr(), c0.data_ptr(), hx.data_ptr(), ptr(c),
                ys.data_ptr(), ptr(cs), ptr(gates), count.data_ptr(),
                int(residual), ldw, T, B, H, plan["units"], stream)
        else:
            # h0 staged with 16-byte copies
            err = build.bind("lstm_seq", "lstm_seq_forward_persistent", 14,
                             6)(
                xs_b.data_ptr(), mask.data_ptr(), w.data_ptr(),
                check_i.data_ptr(), check_f.data_ptr(), check_o.data_ptr(),
                aligned(h0).data_ptr(), c0.data_ptr(), hx.data_ptr(),
                ptr(c), ys.data_ptr(), ptr(cs), ptr(gates),
                count.data_ptr(), int(residual), ldw, T, B, H,
                plan["units"], stream)
    build.raise_coop(err, kernel, plan)
    if not bf16:
        return (ys, hx, cs, gates) if residual else (
            ys, hx[-1] if T else h0, c)
    hs = hx[1:, :, :H] if residual else hx[T, :, :H]
    hs = hs if hx.shape[2] == H else hs.contiguous()
    return (ys, hs, cs, gates) if residual else (ys, hs if T else h0, c)


def lstm_seq(xs_b, mask, w, check_i, check_f, check_o, h0, c0,
             per_step=False, gate_bias=None) -> Tensors:
    """The primal kernel's wrapper; same arguments and results as
    ``lstm_sequence_plain``. ``per_step=True`` forces the per-step route.
    ``lstm_seq.launches`` counts the calls that launched a kernel,
    ``lstm_seq.step_launches`` the device launches (1 a call on the
    persistent route, one per timestep on the other). bf16 ``xs_b``
    (with ``gate_bias`` apart) takes the bf16 form, counted in
    ``lstm_seq.bf16_launches`` (``build.count_launch``)."""
    args = (xs_b, mask, w, check_i, check_f, check_o, h0, c0)
    if xs_b.device.type == "cpu":
        return lstm_sequence_plain(*args, gate_bias=gate_bias)
    plan = _persistent_plan(xs_b, xs_b.shape[1], xs_b.shape[2] // 4,
                            per_step)
    dev, T, B, H, ldw = _seq_args("lstm_seq", *args, gate_bias, plan)
    if plan is not None:
        # h_t of every step (the kernel reads h_{t-1} where no SM read
        # before, see lstm_persistent_kernel)
        out = _forward_persistent("lstm_seq", plan, *args, gate_bias, ldw,
                                  False)
        build.count_launch(lstm_seq, xs_b, 1 if T else 0)
        return out
    c = c0.clone()
    ys = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    h = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    h[0].copy_(h0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("lstm_seq", "lstm_seq_forward", 9, 3)(
            xs_b.data_ptr(), mask.data_ptr(), w.data_ptr(),
            check_i.data_ptr(), check_f.data_ptr(), check_o.data_ptr(),
            h.data_ptr(), c.data_ptr(), ys.data_ptr(), T, B, H, stream)
    build.raise_on(err, "lstm_seq")
    build.count_launch(lstm_seq, xs_b, T)
    return ys, h[T % 2], c


lstm_seq.launches = 0
lstm_seq.step_launches = 0
lstm_seq.bf16_launches = 0


def lstm_seq_train(xs_b, mask, w, check_i, check_f, check_o, h0, c0,
                   per_step=False, gate_bias=None):
    """The residual kernel's wrapper; same arguments and results as
    ``lstm_sequence_residual_plain``. Routes and counts as ``lstm_seq``."""
    args = (xs_b, mask, w, check_i, check_f, check_o, h0, c0)
    if xs_b.device.type == "cpu":
        return lstm_sequence_residual_plain(*args, gate_bias=gate_bias)
    plan = _persistent_plan(xs_b, xs_b.shape[1], xs_b.shape[2] // 4,
                            per_step)
    dev, T, B, H, ldw = _seq_args("lstm_seq_train", *args, gate_bias, plan)
    if plan is not None:
        out = _forward_persistent("lstm_seq_train", plan, *args, gate_bias,
                                  ldw, True)
        build.count_launch(lstm_seq_train, xs_b, 1 if T else 0)
        return out
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
    build.count_launch(lstm_seq_train, xs_b, T)
    return ys, hs, cs, gates


lstm_seq_train.launches = 0
lstm_seq_train.step_launches = 0
lstm_seq_train.bf16_launches = 0


def lstm_bwd_step(dy_t, m_t, gates_t, c_new, c_prev, check_i, check_f,
                  check_o, dhw, dh, dc, dgates_t):
    """The backward step kernel's wrapper (the per-step route); the
    arguments and the in-place contract of ``lstm_bwd_step_plain`` (dh, dc
    and dgates_t are written). One device launch per call."""
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


def lstm_bwd_chain_plain(dys, mask, gates, cs, c0, w, check_i, check_f,
                         check_o, dhT, dcT, units=None):
    """The reverse chain of ``_bwd_rule`` (``paddle_tpu/ops/lstm.py:
    366-389``) in plain PyTorch, arranged as the persistent kernel
    arranges it over blocks of ``units`` units (``lstm_partition``; None:
    one block of all H): block p = 16 r + c of ``lstm_chain_grid`` blocks
    in row groups r of 16. Per reverse step t (t < T - 1): 1, for every
    row group r and column group c, the partial dgates_{t+1}[:, the gate
    columns of the units of blocks c, c + 16, ...] @ W[the units of row
    group r, those columns]^T (one product here; the kernel sums it float4
    by float4); 2, each unit's dh_in = its carry + the 16 partials of its
    row group added in c order, as the kernel adds them; then, every t,
    the elementwise chain of each block's units (dgates_t, the carries).
    After t = 0, 1-2 once more give dh0. The products' inner order
    differs from the kernel's, so the two agree within rounding, not bit
    for bit. Returns (dxs [T, B, 4H], dh0, dc0).

    bf16 residuals (the bf16 form): every step computes in f32 from them
    and rounds to bf16 where the kernel stores or sums in bf16: dy, the
    recurrent product once (its 16 partials added in f32), dh_in = carry +
    product, dgates_t and dc_prev; dxs, dh0 and dc0 come back bf16."""
    dt = gates.dtype
    rnd = _rounder(dt)
    gates, cs, c0, w, check_i, check_f, check_o, dhT, dcT = (
        a.float() for a in (gates, cs, c0, w, check_i, check_f, check_o,
                            dhT, dcT))
    T, B, H = cs.shape
    U = units or max(H, 1)
    blocks = lstm_partition(H, U)
    col_groups = [torch.cat([torch.arange(g * H + u0, g * H + u1)
                             for u0, u1 in blocks[c::GROUP_COLS]
                             for g in range(4)])
                  for c in range(min(GROUP_COLS, len(blocks)))]
    rows = GROUP_COLS * U
    row_groups = [(j0, min(j0 + rows, H)) for j0 in range(0, H, rows)]
    dxs = torch.empty((T, B, 4 * H), dtype=cs.dtype, device=cs.device)
    dh, dc = dhT.clone(), dcT.clone()

    def reduce(dg):  # 1-2: the row groups' partials, added in c order
        for j0, j1 in row_groups:
            total = dg[:, col_groups[0]] @ w[j0:j1, col_groups[0]].t()
            for cols in col_groups[1:]:
                total = total + dg[:, cols] @ w[j0:j1, cols].t()
            dh[:, j0:j1] = rnd(dh[:, j0:j1] + rnd(total))

    for t in range(T - 1, -1, -1):
        if t < T - 1:
            reduce(dxs[t + 1])
        m = mask[t].unsqueeze(-1)
        c_prev = cs[t - 1] if t else c0
        for u0, u1 in blocks:  # the elementwise chain of each block's units
            sl = slice(u0, u1)
            c = torch.cat([torch.arange(g * H + u0, g * H + u1)
                           for g in range(4)])
            dg, dc[:, sl], dh[:, sl] = _cell_grads(
                dh[:, sl], dc[:, sl], dys[t][:, sl], m, gates[t][:, c],
                cs[t][:, sl], c_prev[:, sl], check_i[sl], check_f[sl],
                check_o[sl], rnd)
            dxs[t][:, c] = dg
    if T:
        reduce(dxs[0])
    return dxs.to(dt), dh.to(dt), dc.to(dt)


def lstm_bwd_chain(dys, mask, gates, cs, c0, w, check_i, check_f, check_o,
                   dhT, dcT):
    """The reverse chain kernel's wrapper (the persistent route); the
    arguments and results of ``lstm_bwd_chain_plain`` (on the CPU, that
    function over one block: the partitions agree within rounding, which
    the CPU tests hold). One cooperative launch per call; raises where the
    shape is not on the route or the launch is refused. ``.launches``
    counts calls, ``.step_launches`` device launches; bf16 residuals take
    the bf16 form, counted in ``.bf16_launches``."""
    args = (dys, mask, gates, cs, c0, w, check_i, check_f, check_o, dhT,
            dcT)
    if cs.device.type == "cpu":
        return lstm_bwd_chain_plain(*args)
    dev = build.cuda_device("lstm_bwd_chain", cs)
    T, B, H = cs.shape
    bh = (B, H)
    dt = cs.dtype if cs.dtype == _BF16 else torch.float32
    build.check_tensors(
        "lstm_bwd_chain", dev, dys=(dys, (T, B, H)), mask=(mask, (T, B)),
        gates=(gates, (T, B, 4 * H), dt), cs=(cs, (T, B, H), dt),
        c0=(c0, bh, dt), check_i=(check_i, (H,), dt),
        check_f=(check_f, (H,), dt), check_o=(check_o, (H,), dt),
        dhT=(dhT, bh, dt), dcT=(dcT, bh, dt))
    ldw = check_weight("lstm_bwd_chain", dev, "w", w, (H, 4 * H), dt)
    plan = _persistent_plan(cs, B, H, False)
    if plan is None:
        raise ValueError(f"lstm_bwd_chain: B={B} H={H} is not on the "
                         "persistent route (lstm_route); the per-step "
                         "backward (lstm_bwd_step) takes it")
    U, G = plan["units"], plan["grid_bwd"]
    bf16 = dt == _BF16
    dxs = torch.empty((T, B, 4 * H), dtype=dt, device=dev)
    # the blocks' exchange of dgates: bf16 rows of chain_la(U) in the bf16
    # form, f32 rows of 4U in the f32 form
    dgs = torch.empty((2, G, B, chain_la(U) if bf16 else 4 * U), dtype=dt,
                      device=dev)
    part = torch.empty((2, G, B, GROUP_COLS * U), dtype=torch.float32,
                       device=dev)
    dh0, dc0 = (torch.empty(bh, dtype=dt, device=dev) for _ in range(2))
    count = torch.empty(G // GROUP_COLS + GROUP_COLS, dtype=torch.int32,
                        device=dev)
    entry = "lstm_bf16_chain" if bf16 else "lstm_bwd_chain_launch"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.bind("lstm_seq", entry, 17, 5)(
            *(a.data_ptr() for a in args), dxs.data_ptr(), dgs.data_ptr(),
            part.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            count.data_ptr(), ldw, T, B, H, U, stream)
    build.raise_coop(err, "lstm_bwd_chain", plan)
    build.count_launch(lstm_bwd_chain, cs, 1 if T else 0)
    return dxs, dh0, dc0


lstm_bwd_chain.launches = 0
lstm_bwd_chain.step_launches = 0
lstm_bwd_chain.bf16_launches = 0


def lstm_backward(mask, w, check_i, check_f, check_o, h0, c0, hs, cs, gates,
                  dys, dhT, dcT, step=None, per_step=False):
    """``_bwd_rule`` (``paddle_tpu/ops/lstm.py:358-396``) over the
    residuals of ``lstm_seq_train``: returns (dxs, dW, dpI, dpF, dpO, dh0,
    dc0). The reverse chain is ``lstm_bwd_chain`` on the persistent route;
    on the per-step route (the shape's, or ``per_step=True``), or where a
    ``step`` is given, one ``step`` per reverse step, by default
    ``lstm_bwd_step`` (the card checks pass ``lstm_bwd_step_plain`` for
    the plain backward), with the recurrent product ``dgates_t @ W^T``
    between steps. The products and sums after the chain are PyTorch's,
    as JAX leaves them to XLA."""
    T, B, H = hs.shape
    dys = dys.contiguous()
    if hs.dtype == _BF16 or step is None and not per_step and lstm_route(
            B, H, device_sms(hs)) == PERSISTENT:
        dxs, dh0, dc = lstm_bwd_chain(dys, mask, gates, cs, c0, w, check_i,
                                      check_f, check_o, dhT.contiguous(),
                                      dcT.contiguous())
    else:
        step = step or lstm_bwd_step
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
    (hs, cs, gates), the backward replays them in reverse time, on the
    route the forward took."""

    @staticmethod
    def forward(ctx, xs_b, mask, w, check_i, check_f, check_o, h0, c0,
                per_step, gate_bias=None):
        ys, hs, cs, gates = lstm_seq_train(xs_b, mask, w, check_i, check_f,
                                           check_o, h0, c0,
                                           per_step=per_step,
                                           gate_bias=gate_bias)
        ctx.save_for_backward(mask, w, check_i, check_f, check_o, h0, c0,
                              hs, cs, gates)
        ctx.per_step = per_step
        ctx.has_bias = gate_bias is not None
        return ys, hs[-1].clone(), cs[-1].clone()

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        dxs, dW, dpI, dpF, dpO, dh0, dc0 = lstm_backward(
            *ctx.saved_tensors, dys, dhT, dcT, per_step=ctx.per_step)
        # the bf16 form's unfolded bias: the sum of the gate gradients
        dbias = dxs.sum(dim=(0, 1)) if ctx.has_bias else None
        return dxs, None, dW, dpI, dpF, dpO, dh0, dc0, None, dbias


def lstm_sequence(xs, mask, w, gate_bias, check_i, check_f, check_o, h0, c0,
                  reverse=False, per_step=False) -> Tensors:
    """Fused LSTM over a padded [T,B,4H] gate-projection sequence, the
    counterpart of ``paddle_tpu/ops/lstm.py:lstm_sequence``.
    ``reverse=True`` runs back to front (flip in, flip out; outputs stay
    in input time order). Differentiable: with grad enabled and an input
    that requires it, the residual kernel and ``LstmFunction``'s backward;
    otherwise the lean primal kernel. ``per_step=True`` forces the
    per-step route. Returns (ys [T,B,H], hT, cT).

    bf16 operands take the bf16 forms (ys f32, hT and cT bf16); a call
    whose operands promote to f32 (``jnp.result_type``: f32 ``xs`` with
    bf16 weights) takes the float32 path on the exactly widened
    operands, JAX's promoted product."""
    if reverse:
        ys, hT, cT = lstm_sequence(xs.flip(0), mask.flip(0), w, gate_bias,
                                   check_i, check_f, check_o, h0, c0,
                                   per_step=per_step)
        return ys.flip(0), hT, cT
    ops = (xs, w, gate_bias, check_i, check_f, check_o, h0, c0)
    dt = result_type(*ops)
    if dt == _BF16:
        args = (xs.contiguous(), mask.contiguous(), w.contiguous(),
                check_i.contiguous(), check_f.contiguous(),
                check_o.contiguous(), h0.contiguous(), c0.contiguous())
        gate_bias = gate_bias.contiguous()
        if xs.shape[0] and torch.is_grad_enabled() and any(
                a.requires_grad for a in args + (gate_bias,)):
            return LstmFunction.apply(*args, per_step, gate_bias)
        return lstm_seq(*args, per_step=per_step, gate_bias=gate_bias)
    if dt == torch.float32:
        xs, w, gate_bias, check_i, check_f, check_o, h0, c0 = (
            a.float() for a in ops)
    xs_b = (xs + gate_bias).contiguous()  # fold the bias in once
    args = (xs_b, mask.contiguous(), w.contiguous(), check_i.contiguous(),
            check_f.contiguous(), check_o.contiguous(), h0.contiguous(),
            c0.contiguous())
    if xs.shape[0] and torch.is_grad_enabled() and any(
            a.requires_grad for a in args):
        return LstmFunction.apply(*args, per_step)
    return lstm_seq(*args, per_step=per_step)

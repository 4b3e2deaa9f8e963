"""The LSTM kernels' routes and the reverse chain's plain version, on the CPU.

``lstm_route`` / ``lstm_plan`` decide by shape whether a recurrence takes
the persistent kernels of ``csrc/lstm_seq.cu`` (one cooperative launch per
sequence or reverse chain, each block holding its units' four gate
columns of W in shared memory) or the per-step kernels; the card tests
check that the kernel counts the same shared-memory bytes. Here: the
route of every shape the repo's paths and chip checks run, the line above
which the per-step route takes over, the shared-memory arithmetic, the
unit partition, and ``lstm_bwd_chain_plain`` (the chain kernel's phases,
block by block) against ``jax.vjp`` of the JAX ``lstm_sequence`` in
interpret mode.

Tolerance: gradients rtol 1e-4 / atol 1e-5 (the reverse recurrence, and
dW and the peephole gradients summed over T*B rows in one product where
JAX sums per step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import common
from paddle_tpu.ops import lstm as jlstm
from paddle_tpu_torch.ops import lstm as tlstm

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# (B, H): the classifier's train batch, its gradient check's 16 rows and
# serving batches 1-64 (the serve CLI's powers of two) at 1280; the
# tagger's train and test batch, serving batch 1 and call of 16 rows at
# 128; BENCH_SHAPES' (64, 256) and (64, 512); the card tests' small shapes
ROUTED = [(64, 1280), (16, 1280), (1, 1280), (2, 1280), (4, 1280),
          (8, 1280), (32, 1280), (64, 128), (1, 128), (16, 128), (64, 256),
          (64, 512), (5, 40), (33, 40), (33, 96), (5, 96), (3, 96), (2, 8)]


@pytest.mark.parametrize("B,H", ROUTED)
def test_paths_take_the_persistent_route(B, H):
    plan = tlstm.lstm_plan(B, H)
    assert plan["route"] == tlstm.PERSISTENT
    assert plan["grid"] <= tlstm.H100_SMS
    assert plan["units"] * plan["grid"] >= H > plan["units"] * (
        plan["grid"] - 1)
    assert plan["grid_bwd"] % tlstm.GROUP_COLS == 0
    assert plan["grid"] <= plan["grid_bwd"] <= tlstm.H100_SMS
    assert plan["smem_fwd"] <= tlstm.SMEM_BYTES
    assert plan["smem_bwd"] <= tlstm.SMEM_BYTES


@pytest.mark.parametrize("B", [1, 16, 64])
def test_route_line(B):
    """The largest H on the persistent route is 1280 at B = 1, 16 and 64
    (the source note's line: 10 units a block in 128 blocks, 8 row groups
    of 16; at 1284 the chain needs a ninth row group, 144 blocks on 132
    SMs); above it, and for H % 4 != 0, the per-step route. At most 64
    rows are on the route (the BENCH_SHAPES pairs (128, 256), (128, 1280),
    (256, 256), (256, 1280) and (512, 512) are off it)."""
    assert tlstm.lstm_route(B, 1280) == tlstm.PERSISTENT
    assert tlstm.lstm_route(B, 1284) == tlstm.PER_STEP
    assert tlstm.lstm_route(B, 130) == tlstm.PER_STEP
    assert tlstm.lstm_route(64, 1280) == tlstm.PERSISTENT
    for rows, H in ((65, 1280), (128, 256), (128, 1280), (256, 256),
                    (256, 1280), (512, 512)):
        assert tlstm.lstm_route(rows, H) == tlstm.PER_STEP


def test_shared_memory_arithmetic():
    """At the classifier's (64, 1280): 10 units a block (128 blocks). The
    forward: their four gate columns of W resident (rows padded to an odd
    number of float4s, 1284 floats: 205,440 bytes) and each of the 8
    warps a ring of 3 slots of 2 float4s of h for each of its 32 rows
    (6,144 floats); a fourth slot would not fit. The chain: its row
    group's 160 units over its column group's 8 x 40 gate columns (stride
    324) and two buffers of one block's dgates [64][40] (stride 44), which
    then pass the partial out 32 rows [32][164] at a time; all 8 buffers
    at once would not fit.
    The carries and own inputs live in registers: the GRU kernels'
    layout, which keeps the carries (c, h) and, double-buffered, the own
    inputs (4 gates and the mask) in shared memory, would leave no ring of
    3 slots at this shape."""
    B, H = 64, 1280
    plan = tlstm.lstm_plan(B, H)
    U = plan["units"]
    assert (U, plan["grid"], plan["grid_bwd"]) == (10, 128, 128)
    weights = 4 * U * 1284
    assert 4 * weights == 205440
    assert plan["smem_fwd"] == 4 * (weights + 8 * 3 * 32 * 8) == 230016
    assert 4 * (weights + 8 * 4 * 32 * 8) > tlstm.SMEM_BYTES
    assert plan["smem_bwd"] == 4 * (160 * 324 + 2 * B * 44) == 229888
    assert 32 * 164 <= 2 * B * 44
    assert 4 * (160 * 324 + 8 * B * 44) > tlstm.SMEM_BYTES
    gru_style_own = 2 * B * U + 2 * (4 * B * U + B)
    assert 4 * (weights + gru_style_own + 8 * 3 * 32 * 8) > \
        tlstm.SMEM_BYTES
    # H = 128, 1 unit a block: the chain stages its column group's 8
    # chunks at once
    plan = tlstm.lstm_plan(64, 128)
    assert (plan["units"], plan["grid"], plan["grid_bwd"]) == (1, 128, 128)
    assert plan["smem_fwd"] == 4 * (4 * 132 + 8 * 3 * 32 * 8)
    assert plan["smem_bwd"] == 4 * (16 * 36 + 8 * 64 * 4)


@pytest.mark.parametrize("H", [1, 7, 128, 512, 1000, 1280, 1320])
@pytest.mark.parametrize("sms", [1, 7, 132, 264])
def test_unit_partition_covers_every_unit_once(H, sms):
    units = tlstm.lstm_units(H, sms)
    parts = tlstm.lstm_partition(H, units)
    assert len(parts) <= sms
    covered = [j for u0, u1 in parts for j in range(u0, u1)]
    assert covered == list(range(H))
    assert all(0 < u1 - u0 <= units for u0, u1 in parts)


def _inputs(T, B, H, seed):
    """A ragged mask with an all-padding row (the last), nonzero h0, c0
    and peepholes."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    lens[-1] = 0
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    return dict(xs=f(T, B, 4 * H), mask=mask, w=f(H, 4 * H, scale=0.3),
                b=f(4 * H, scale=0.1), pI=f(H, scale=0.2),
                pF=f(H, scale=0.2), pO=f(H, scale=0.2),
                h0=f(B, H, scale=0.5), c0=f(B, H, scale=0.5),
                dys=f(T, B, H), dhT=f(B, H), dcT=f(B, H))


_T = lambda v: torch.from_numpy(np.ascontiguousarray(v))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("units", [1, 3, None])
def test_chain_plain_matches_jax_vjp(reverse, units):
    """``lstm_bwd_chain_plain`` with the kernel's partition (8 blocks of
    one unit, as 132 SMs split H = 8), a ragged one (3 + 3 + 2) and one
    block, after the plain residual forward with carried h0 and c0: dxs,
    dW, the peephole gradients, dh0 and dc0 against ``jax.vjp`` of the
    JAX ``lstm_sequence`` (interpret mode)."""
    T, B, H = 5, 3, 8
    assert tlstm.lstm_units(H) == 1
    a = _inputs(T, B, H, seed=41 + reverse)
    names = ("xs", "w", "pI", "pF", "pO", "h0", "c0")
    with common.force_mode("interpret"):
        _, vjp = jax.vjp(
            lambda xs, w, pI, pF, pO, h0, c0: jlstm.lstm_sequence(
                xs, jnp.asarray(a["mask"]), w, jnp.asarray(a["b"]), pI, pF,
                pO, h0, c0, reverse=reverse),
            *(jnp.asarray(a[k]) for k in names))
        want = vjp(tuple(jnp.asarray(a[k]) for k in ("dys", "dhT", "dcT")))
    flip = (lambda v: np.ascontiguousarray(v[::-1])) if reverse \
        else (lambda v: v)
    xs_b, mask = _T(flip(a["xs"]) + a["b"]), _T(flip(a["mask"]))
    w, pI, pF, pO, h0, c0 = (_T(a[k]) for k in names[1:])
    _, hs, cs, gates = tlstm.lstm_sequence_residual_plain(
        xs_b, mask, w, pI, pF, pO, h0, c0)
    before = tlstm.lstm_bwd_chain.launches
    dxs, dh0, dc0 = tlstm.lstm_bwd_chain_plain(
        _T(flip(a["dys"])), mask, gates, cs, c0, w, pI, pF, pO,
        _T(a["dhT"]), _T(a["dcT"]), units=units)
    assert tlstm.lstm_bwd_chain.launches == before  # plain: no kernel
    h_prev = torch.cat([h0[None], hs[:-1]])
    c_prev = torch.cat([c0[None], cs[:-1]])
    dW = h_prev.reshape(T * B, H).t() @ dxs.reshape(T * B, 4 * H)
    dpI = (dxs[..., H:2 * H] * c_prev).sum(dim=(0, 1))
    dpF = (dxs[..., 2 * H:3 * H] * c_prev).sum(dim=(0, 1))
    dpO = (dxs[..., 3 * H:] * cs).sum(dim=(0, 1))
    got = (flip(dxs.numpy()), dW.numpy(), dpI.numpy(), dpF.numpy(),
           dpO.numpy(), dh0.numpy(), dc0.numpy())
    for name, g, w_ in zip(names, got, want):
        np.testing.assert_allclose(g, np.asarray(w_), **GRAD_TOL,
                                   err_msg=name)
    # the padded row passes dhT and dcT through untouched, no dxs
    np.testing.assert_array_equal(dh0.numpy()[-1], a["dhT"][-1])
    np.testing.assert_array_equal(dc0.numpy()[-1], a["dcT"][-1])
    assert not dxs[:, -1].any()


@pytest.mark.parametrize("units,H", [(1, 8), (3, 8), (1, 40), (2, 44)])
def test_chain_plain_partition_equals_one_block(units, H):
    """The kernel's arrangement (row groups of 16 blocks by column groups;
    at H = 40 and 44, three row groups, the last ragged) and one block of
    all units give the same chain (each unit's sums are the same dot
    products, summed by groups of columns)."""
    T, B = 4, 3
    a = _inputs(T, B, H, seed=5)
    w = _T(a["w"])
    checks = [_T(a[k]) for k in ("pI", "pF", "pO")]
    _, hs, cs, gates = tlstm.lstm_sequence_residual_plain(
        _T(a["xs"] + a["b"]), _T(a["mask"]), w, *checks, _T(a["h0"]),
        _T(a["c0"]))
    args = (_T(a["dys"]), _T(a["mask"]), gates, cs, _T(a["c0"]), w, *checks,
            _T(a["dhT"]), _T(a["dcT"]))
    for g, w_ in zip(tlstm.lstm_bwd_chain_plain(*args, units=units),
                     tlstm.lstm_bwd_chain_plain(*args)):
        torch.testing.assert_close(g, w_, rtol=1e-6, atol=1e-6)


def test_cpu_backward_takes_the_chain_of_its_route():
    """On the CPU ``lstm_backward`` follows the route the H100 would take:
    the plain chain (over one block) on the persistent route,
    the plain per-step loop with ``per_step=True``, with equal results; no
    launches. A given ``step`` takes the loop too."""
    T, B, H = 4, 2, 8
    a = _inputs(T, B, H, seed=9)
    w, mask, h0, c0 = _T(a["w"]), _T(a["mask"]), _T(a["h0"]), _T(a["c0"])
    checks = [_T(a[k]) for k in ("pI", "pF", "pO")]
    _, hs, cs, gates = tlstm.lstm_sequence_residual_plain(
        _T(a["xs"] + a["b"]), mask, w, *checks, h0, c0)
    res = (mask, w, *checks, h0, c0, hs, cs, gates, _T(a["dys"]),
           _T(a["dhT"]), _T(a["dcT"]))
    counts = (tlstm.lstm_bwd_chain.launches, tlstm.lstm_bwd_step.launches)
    chain = tlstm.lstm_backward(*res)
    loop = tlstm.lstm_backward(*res, per_step=True)
    stepped = tlstm.lstm_backward(*res, step=tlstm.lstm_bwd_step_plain)
    assert (tlstm.lstm_bwd_chain.launches,
            tlstm.lstm_bwd_step.launches) == counts
    for g, w_, s in zip(chain, loop, stepped):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(s, w_, rtol=0, atol=0)
    # the chain is the plain chain's over one block
    dxs, dh0, dc0 = tlstm.lstm_bwd_chain_plain(
        _T(a["dys"]), mask, gates, cs, c0, w, *checks, _T(a["dhT"]),
        _T(a["dcT"]))
    assert torch.equal(chain[0], dxs) and torch.equal(chain[5], dh0)


def test_chain_counters_are_reported():
    """``ops.kernel_counts()`` reports the chain's launches and device
    launches beside the other LSTM kernels', and ``reset_kernel_counts``
    sets them to 0 (the CLI's summaries and ``/healthz`` read them)."""
    from paddle_tpu_torch import ops
    counts = ops.kernel_counts()
    assert set(counts["lstm_bwd_chain"]) == {"launches", "step_launches"}
    for name in ("lstm_seq", "lstm_seq_train"):
        assert set(counts[name]) == {"launches", "step_launches"}
    tlstm.lstm_bwd_chain.launches += 1
    ops.reset_kernel_counts()
    assert ops.kernel_counts()["lstm_bwd_chain"] == {"launches": 0,
                                                     "step_launches": 0}

"""The GRU kernels' routes and the reverse chain's plain version, on the CPU.

``gru_route`` / ``gru_plan`` decide by shape whether a recurrence takes
the persistent kernels of ``csrc/gru_seq.cu`` (one cooperative launch per
sequence or reverse chain, each block holding its units' weights in shared
memory) or the two-launch kernels; the card tests check that the kernel
counts the same shared-memory bytes. Here: the route of every shape the
repo's paths and chip checks run, the line above which the two-launch
route takes over, the shared-memory arithmetic, the unit partition, and
``gru_bwd_chain_plain`` (the chain kernel's three phases, block by block)
against ``jax.vjp`` of the JAX ``gru_sequence`` in interpret mode.

Tolerance: gradients rtol 1e-4 / atol 1e-5 (the reverse recurrence, and
dWg, dWs summed over T*B rows in one product where JAX sums per step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import common
from paddle_tpu.ops import gru as jgru
from paddle_tpu_torch.ops import gru as tgru

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# (B, H): chip_smoke's GRU_SHAPES (the seq2seq path's (50, 512), (64, 256),
# batch 1, the CTC acoustic model's (16, 1024)), the seq2seq and acoustic
# gradient checks' 8 and 4 rows, and the card tests' small shapes
ROUTED = [(50, 512), (64, 256), (1, 512), (16, 1024), (8, 512), (4, 1024),
          (5, 40), (50, 96), (33, 64), (2, 8)]


@pytest.mark.parametrize("B,H", ROUTED)
def test_paths_take_the_persistent_route(B, H):
    plan = tgru.gru_plan(B, H)
    assert plan["route"] == tgru.PERSISTENT
    assert plan["grid"] <= tgru.H100_SMS
    assert plan["units"] * plan["grid"] >= H > plan["units"] * (
        plan["grid"] - 1)
    for kind in ("fwd", "bwd"):
        assert plan[f"smem_{kind}"] <= tgru.SMEM_BYTES
        assert plan[f"chunk_{kind}"] % 4 == 0


@pytest.mark.parametrize("B,last", [(16, 1524), (50, 1452), (64, 1396),
                                    (1, 1584)])
def test_route_line(B, last):
    """The largest H on the persistent route at each batch (the source
    note's line); one step of 4 above it, and H = 1536 at the acoustic
    model's batch 16 (chip_smoke's row above the line), take the
    two-launch route, as does any H % 4 != 0."""
    assert tgru.gru_route(B, last) == tgru.PERSISTENT
    assert tgru.gru_route(B, last + 4) == tgru.TWO_LAUNCH
    assert tgru.gru_route(16, 1536) == tgru.TWO_LAUNCH
    assert tgru.gru_route(2, 1600) == tgru.TWO_LAUNCH
    assert tgru.gru_route(B, 510) == tgru.TWO_LAUNCH


def test_shared_memory_arithmetic():
    """At the acoustic model's (16, 1024): 8 units a block (128 blocks),
    96 KB of weights, h staged whole (16 x 1024 floats), and the carries
    and inputs of the block's units a step ahead."""
    B, H = 16, 1024
    plan = tgru.gru_plan(B, H)
    U = plan["units"]
    assert (U, plan["grid"]) == (8, 128)
    assert plan["chunk_fwd"] == plan["chunk_bwd"] == H
    weights = 3 * U * H
    assert 4 * weights == 96 * 1024
    fwd_own = 2 * B * U + 2 * (3 * B * U + B)
    bwd_own = B * U + 2 * (5 * B * U + B)
    assert plan["smem_fwd"] == 4 * (weights + B * H + fwd_own) == 168064
    assert plan["smem_bwd"] == 4 * (weights + B * H + bwd_own) == 169600
    # where the whole width does not fit: two buffers of the widest chunk
    # that does, a multiple of 4 floats
    plan = tgru.gru_plan(16, 1524)
    U, kc = plan["units"], plan["chunk_bwd"]
    assert kc < 1524 and kc % 4 == 0
    fixed = 3 * U * 1524 + 16 * U + 2 * (5 * 16 * U + 16)
    assert plan["smem_bwd"] == 4 * (fixed + 2 * 16 * kc) <= tgru.SMEM_BYTES
    assert 4 * (fixed + 2 * 16 * (kc + 4)) > tgru.SMEM_BYTES
    # the tiles of a block must not outnumber its 256 threads
    assert tgru.gru_route(1100, 1024) == tgru.TWO_LAUNCH


@pytest.mark.parametrize("H", [1, 7, 256, 512, 1000, 1024, 1536])
@pytest.mark.parametrize("sms", [1, 7, 132, 264])
def test_unit_partition_covers_every_unit_once(H, sms):
    units = tgru.gru_units(H, sms)
    parts = tgru.gru_partition(H, units)
    assert len(parts) <= sms
    covered = [j for u0, u1 in parts for j in range(u0, u1)]
    assert covered == list(range(H))
    assert all(0 < u1 - u0 <= units for u0, u1 in parts)


def _inputs(T, B, H, seed):
    """A ragged mask with an all-padding row (the last), nonzero h0."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    lens[-1] = 0
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    return dict(xs=f(T, B, 3 * H), mask=mask, w0=f(H, 3 * H, scale=0.3),
                b=f(3 * H, scale=0.1), h0=f(B, H, scale=0.5),
                dys=f(T, B, H), dhT=f(B, H))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("units", [1, 3, None])
def test_chain_plain_matches_jax_vjp(reverse, units):
    """``gru_bwd_chain_plain`` with the kernel's partition (8 blocks of one
    unit, as 132 SMs split H = 8), a ragged one (3 + 3 + 2) and one block,
    after the plain residual forward: dxs, dWg, dWs and dh0 against
    ``jax.vjp`` of the JAX ``gru_sequence`` (interpret mode)."""
    T, B, H = 5, 3, 8
    assert tgru.gru_units(H) == 1
    a = _inputs(T, B, H, seed=31 + reverse)
    wg, ws = a["w0"][:, :2 * H], a["w0"][:, 2 * H:]
    with common.force_mode("interpret"):
        _, vjp = jax.vjp(
            lambda xs, g, s, h0: jgru.gru_sequence(
                xs, jnp.asarray(a["mask"]), g, s, jnp.asarray(a["b"]), h0,
                reverse=reverse),
            *(jnp.asarray(v) for v in (a["xs"], wg, ws, a["h0"])))
        want = vjp((jnp.asarray(a["dys"]), jnp.asarray(a["dhT"])))
    flip = (lambda v: np.ascontiguousarray(v[::-1])) if reverse \
        else (lambda v: v)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    xs_b, mask = t(flip(a["xs"]) + a["b"]), t(flip(a["mask"]))
    w_gate, w_state, h0 = t(wg), t(ws), t(a["h0"])
    _, hs, gates = tgru.gru_sequence_residual_plain(xs_b, mask, w_gate,
                                                    w_state, h0)
    before = tgru.gru_bwd_chain.launches
    dxs, dh0 = tgru.gru_bwd_chain_plain(t(flip(a["dys"])), mask, gates, h0,
                                        hs, w_gate, w_state, t(a["dhT"]),
                                        units=units)
    assert tgru.gru_bwd_chain.launches == before  # plain: no kernel
    h_prev = torch.cat([h0[None], hs[:-1]]).reshape(T * B, H)
    dWg = h_prev.t() @ dxs[..., :2 * H].reshape(T * B, 2 * H)
    r_h = gates[..., H:2 * H].reshape(T * B, H) * h_prev
    dWs = r_h.t() @ dxs[..., 2 * H:].reshape(T * B, H)
    got = (flip(dxs.numpy()), dWg.numpy(), dWs.numpy(), dh0.numpy())
    for name, g, w in zip(("dxs", "dWg", "dWs", "dh0"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                   err_msg=name)
    # the padded row passes dhT through untouched and gets no dxs
    np.testing.assert_array_equal(dh0.numpy()[-1], a["dhT"][-1])
    assert not dxs[:, -1].any()


@pytest.mark.parametrize("units", [1, 3])
def test_chain_plain_partition_equals_one_block(units):
    """The kernel's block-by-block phases and one block of all units give
    the same chain (each unit's sums are the same dot products)."""
    T, B, H = 4, 3, 8
    a = _inputs(T, B, H, seed=5)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    w0 = t(a["w0"])
    xs_b = t(a["xs"] + a["b"])
    _, hs, gates = tgru.gru_sequence_residual_plain(
        xs_b, t(a["mask"]), w0[:, :2 * H], w0[:, 2 * H:], t(a["h0"]))
    args = (t(a["dys"]), t(a["mask"]), gates, t(a["h0"]), hs, w0[:, :2 * H],
            w0[:, 2 * H:], t(a["dhT"]))
    for g, w in zip(tgru.gru_bwd_chain_plain(*args, units=units),
                    tgru.gru_bwd_chain_plain(*args)):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_cpu_backward_takes_the_chain_of_its_route():
    """On the CPU ``gru_backward`` follows the route the H100 would take:
    the plain chain on the persistent route, the plain per-step loop on
    the two-launch one (forced here), with equal results; no launches."""
    T, B, H = 4, 2, 8
    a = _inputs(T, B, H, seed=9)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    w0 = t(a["w0"])
    wg, ws = w0[:, :2 * H], w0[:, 2 * H:]
    mask, h0 = t(a["mask"]), t(a["h0"])
    _, hs, gates = tgru.gru_sequence_residual_plain(
        t(a["xs"] + a["b"]), mask, wg, ws, h0)
    res = (mask, wg, ws, h0, hs, gates, t(a["dys"]), t(a["dhT"]))
    counts = (tgru.gru_bwd_chain.launches, tgru.gru_bwd_step.launches)
    chain = tgru.gru_backward(*res)
    loop = tgru.gru_backward(*res, two_launch=True)
    assert (tgru.gru_bwd_chain.launches,
            tgru.gru_bwd_step.launches) == counts
    for g, w in zip(chain, loop):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)

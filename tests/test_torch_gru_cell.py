"""The GRU cell's routes and its parity with the JAX package, on the CPU.

``gru_cell_plan`` decides by shape whether a GRU step takes the cluster
kernel of ``csrc/gru_cell.cu`` (one launch a step: clusters of blocks that
exchange r * h through distributed shared memory) or the two-launch cell
of ``csrc/gru_seq.cu``; the card tests check that the kernel counts the
same shared-memory bytes and runs one launch a call. Here: the route of
every shape the repo's paths and chip checks give the cell, the
partition of rows and units, the shared-memory arithmetic and the line
where the two-launch route takes over; and ``gru_cell`` /
``gru_cell_infer`` (their plain versions on the CPU) against the JAX
``gru_cell`` / ``gru_cell_infer`` with the Pallas cell in interpret mode,
at a batch larger than one cluster's rows.

Tolerances: forward rtol/atol 1e-5 (f32, XLA and PyTorch sum h @ W in
other orders over K=H); gradients rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import rnn_cells as jcells
from paddle_tpu.ops import common
from paddle_tpu_torch.kernels import rnn_cells as tcells
from paddle_tpu_torch.ops.build import H100_SMS, SMEM_BYTES

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# (B, H): seq2seq's training and test batch, its beam search's 8 sources x
# beam 4 and one source x beam 4, batch 1 (chip_smoke's GRU_CELL_SHAPES)
PATH_SHAPES = [(50, 512), (32, 512), (4, 512), (1, 512)]
# ragged: units that do not fill 16 blocks of 32, rows that do not fill
# the last tile
RAGGED = [(7, 40), (50, 96), (33, 64), (2, 8), (200, 512), (1, 528)]
# H % 4 != 0, and H whose block of one row exceeds the shared memory
OFF_ROUTE = [(5, 130), (3, 6), (2, 1), (16, 1024), (1, 544)]


def _partition_ok(plan, B, H):
    U, C, R = plan["units"], plan["cluster"], plan["rows"]
    assert U % 4 == 0 and 1 <= C <= 16 and 1 <= R <= tcells.CELL_MAX_ROWS
    assert (C - 1) * U < H <= C * U  # every block holds a unit
    assert (plan["clusters"] - 1) * R < B <= plan["clusters"] * R
    assert plan["blocks"] == C * plan["clusters"]
    assert plan["smem"] == tcells.cell_smem(H, U, R) <= SMEM_BYTES


@pytest.mark.parametrize("B,H", PATH_SHAPES)
def test_path_shapes_take_the_cluster_route(B, H):
    plan = tcells.gru_cell_plan(B, H)
    assert plan["route"] == tcells.CLUSTER == tcells.gru_cell_route(B, H)
    assert plan["cluster"] == 16 and plan["units"] == 32
    assert plan["blocks"] <= H100_SMS
    _partition_ok(plan, B, H)


def test_path_plans_fill_the_card():
    """50 and 32 rows: 8 clusters of 16 blocks (128 of 132 SMs); 4 rows
    and 1: a cluster a row."""
    got = {B: (tcells.gru_cell_plan(B, 512)["rows"],
               tcells.gru_cell_plan(B, 512)["clusters"])
           for B, _ in PATH_SHAPES}
    assert got == {50: (7, 8), 32: (4, 8), 4: (1, 4), 1: (1, 1)}


@pytest.mark.parametrize("B,H", RAGGED)
def test_ragged_shapes_take_the_cluster_route(B, H):
    plan = tcells.gru_cell_plan(B, H)
    assert plan["route"] == tcells.CLUSTER
    _partition_ok(plan, B, H)


@pytest.mark.parametrize("B,H", OFF_ROUTE)
def test_off_route_shapes_take_two_launches(B, H):
    assert tcells.gru_cell_route(B, H) == tcells.TWO_LAUNCH


def test_shared_memory_arithmetic():
    """cell_smem at H = 512, 32 units: 2 x 32 x 512 Wg floats (the
    partials, 16 slices x R x 64, fit in them), 32 x 512 Ws floats, R x
    512 of the tile and 3 x R x 32 of the own units."""
    for R in (1, 7, 14):
        assert tcells.cell_smem(512, 32, R) == 4 * (
            2 * 32 * 512 + 32 * 512 + R * 512 + 3 * R * 32)
    # where the partials outgrow the Wg slice they reuse its space anyway
    assert tcells.cell_smem(8, 4, 16) == 4 * (
        max(2 * 4 * 8, 2 * 16 * 8, 2 * 16 * 4) + 4 * 8 + 16 * 8
        + 3 * 16 * 4)
    # the largest tile at H = 512: 14 rows
    assert tcells.gru_cell_plan(200, 512)["rows"] == 14
    assert tcells.cell_smem(512, 32, 15) > SMEM_BYTES


def test_rows_follow_the_clusters_the_card_places():
    """A card that places 7 clusters of 16 at once: 8 rows a tile, 7
    clusters; fewer SMs: more rows, never above the tile's limit."""
    plan = tcells.gru_cell_plan(50, 512, slots=7)
    assert (plan["rows"], plan["clusters"]) == (8, 7)
    plan = tcells.gru_cell_plan(50, 512, sms=16)
    assert (plan["rows"], plan["clusters"]) == (14, 4)


def test_cluster_size_eight():
    """C = 8 at H = 256 (32 units, 104 KB a block); at H = 512 its
    blocks would hold 384 KB of weights: two launches."""
    plan = tcells.gru_cell_plan(50, 256, cluster=8)
    assert (plan["route"], plan["cluster"], plan["units"]) == (
        tcells.CLUSTER, 8, 32)
    _partition_ok(plan, 50, 256)
    assert tcells.gru_cell_plan(50, 512, cluster=8)["route"] == \
        tcells.TWO_LAUNCH


def _cell_inputs(B, H, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * sc).astype(np.float32)
            for s, sc in (((B, 3 * H), 1.0), ((B, H), 0.5),
                          ((H, 3 * H), 0.3), ((B, H), 1.0))]


@pytest.mark.parametrize("B,H", [(20, 64), (50, 96), (9, 8)])
def test_cell_matches_jax_beyond_one_cluster(B, H):
    """Both entries and the gradient against JAX's ``gru_cell`` (the Pallas
    cell in interpret mode) at a batch of several clusters' tiles."""
    assert B > tcells.gru_cell_plan(B, H)["rows"]
    x, h, w0, ct = _cell_inputs(B, H, B * 100 + H)
    jx, jh, jw = jnp.asarray(x), jnp.asarray(h), jnp.asarray(w0)
    with common.force_mode("interpret"):
        want_i = jcells.gru_cell_infer(jx, jh, jw[:, :2 * H], jw[:, 2 * H:])
        want, vjp = jax.vjp(
            lambda x_, h_, w_: jcells.gru_cell(x_, h_, w_[:, :2 * H],
                                               w_[:, 2 * H:]), jx, jh, jw)
        want_g = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (x, h, w0)]
    w = leaves[2]
    before = (tcells.gru_cell.launches, tcells.gru_cell.step_launches,
              tcells.gru_cell_infer.launches)
    got = tcells.gru_cell(leaves[0], leaves[1], w[:, :2 * H], w[:, 2 * H:])
    with torch.no_grad():
        got_i = tcells.gru_cell_infer(leaves[0], leaves[1], w[:, :2 * H],
                                      w[:, 2 * H:])
        got_2 = tcells.gru_cell_infer(leaves[0], leaves[1], w[:, :2 * H],
                                      w[:, 2 * H:], two_launch=True)
    # the CPU runs the plain version and counts no launch
    assert (tcells.gru_cell.launches, tcells.gru_cell.step_launches,
            tcells.gru_cell_infer.launches) == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), **FWD_TOL)
    assert torch.equal(got_i, got_2)
    got_g = torch.autograd.grad(got, leaves, torch.from_numpy(ct))
    for name, g, wg in zip(("dx", "dh", "dw0"), got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **GRAD_TOL,
                                   err_msg=name)


def test_cpu_wrapper_raises_for_a_cuda_only_launch():
    """The launch path itself refuses a CPU tensor: only the entries'
    device test sends CPU tensors to the plain version."""
    x, h, w0, _ = (torch.from_numpy(v) for v in _cell_inputs(3, 8, 1))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tcells._gru_launch("gru_cell_infer", x, h, w0[:, :16], w0[:, 16:])

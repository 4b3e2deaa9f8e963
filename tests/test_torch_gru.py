"""Parity of the port's GRU operators with the JAX package, on the CPU.

The primal and residual GRU sequence forward (``gru_seq`` /
``gru_seq_train``; their plain versions on the CPU) are held against the
JAX Pallas kernel ``_gru_pallas`` in interpret mode, and every gradient of
``gru_sequence`` (``GruFunction``: the residual forward and the
transcribed ``_bwd_rule``) against ``jax.grad`` of the JAX
``gru_sequence`` in interpret mode (its ``_fwd_rule`` + ``_bwd_rule``),
for ragged masks, carried h0, ``reverse`` and T=1. The GRU cell
(``gru_cell`` / ``gru_cell_infer``) is held against ``_gru_pallas`` of
``kernels/rnn_cells.py`` in interpret mode and its gradient against
``_gru_fused_bwd``; a non-default activation against the JAX inline math.

Tolerances: forward rtol/atol 1e-5 (f32, XLA and PyTorch sum h @ W in
other orders over K=H and T steps); gradients rtol 1e-4 / atol 1e-5 (the
backward adds the reverse recurrence, and dWg, dWs summed over T*B rows
in one product where JAX sums per step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import rnn_cells as jcells
from paddle_tpu.ops import common
from paddle_tpu.ops import gru as jgru
from paddle_tpu_torch.kernels import rnn_cells as tcells
from paddle_tpu_torch.ops import gru as tgru

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(T, B, H, seed, carried=True):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    return dict(xs=f(T, B, 3 * H), mask=mask, w0=f(H, 3 * H, scale=0.3),
                b=f(3 * H, scale=0.1),
                h0=f(B, H, scale=0.5) if carried
                else np.zeros((B, H), np.float32),
                dys=f(T, B, H), dhT=f(B, H))


def _torch_w(w0, H):
    """The port's layers pass the two column slices of one w0."""
    w = torch.from_numpy(w0)
    return w[:, :2 * H], w[:, 2 * H:]


@pytest.mark.parametrize("T,B,H", [(6, 3, 16), (1, 2, 8), (5, 4, 12)])
def test_forward_forms_match_jax_kernel(T, B, H):
    a = _inputs(T, B, H, seed=T * 10 + H)
    xs_b = a["xs"] + a["b"]
    wg, ws = a["w0"][:, :2 * H], a["w0"][:, 2 * H:]
    jargs = [jnp.asarray(v) for v in (xs_b, a["mask"], wg, ws, a["h0"])]
    with common.force_mode("interpret"):
        want_r = jgru._gru_pallas(*jargs, with_residuals=True)
        want_p = jgru._gru_pallas(*jargs, with_residuals=False)
    targs = (torch.from_numpy(xs_b), torch.from_numpy(a["mask"]),
             *_torch_w(a["w0"], H), torch.from_numpy(a["h0"]))
    before = (tgru.gru_seq.launches, tgru.gru_seq_train.launches)
    got_r = tgru.gru_seq_train(*targs)
    got_p = tgru.gru_seq(*targs)
    # CPU tensors: the plain versions, no kernel
    assert (tgru.gru_seq.launches, tgru.gru_seq_train.launches) == before
    for name, g, w in zip(("ys", "hs", "gates", "ys", "hT"),
                          list(got_r) + list(got_p),
                          list(want_r) + list(want_p)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("T,B,H,reverse,carried", [
    (6, 3, 16, False, True), (6, 3, 16, True, True), (5, 4, 8, False, False),
    (1, 2, 8, True, True)])
def test_every_gradient_matches_jax_bwd_rule(T, B, H, reverse, carried):
    a = _inputs(T, B, H, seed=T + 100 * H + reverse, carried=carried)
    mask = jnp.asarray(a["mask"])

    def jloss(xs, w0, b, h0):
        ys, hT = jgru.gru_sequence(xs, mask, w0[:, :2 * H], w0[:, 2 * H:], b,
                                   h0, reverse=reverse)
        return (jnp.sum(ys * jnp.asarray(a["dys"]))
                + jnp.sum(hT * jnp.asarray(a["dhT"])))

    names = ("xs", "w0", "b", "h0")
    with common.force_mode("interpret"):
        want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(a[k]) for k in names))
    leaves = {k: torch.from_numpy(a[k]).requires_grad_(True) for k in names}
    wg, ws = leaves["w0"][:, :2 * H], leaves["w0"][:, 2 * H:]
    ys, hT = tgru.gru_sequence(leaves["xs"], torch.from_numpy(a["mask"]),
                               wg, ws, leaves["b"], leaves["h0"],
                               reverse=reverse)
    loss = ((ys * torch.from_numpy(a["dys"])).sum()
            + (hT * torch.from_numpy(a["dhT"])).sum())
    np.testing.assert_allclose(float(loss.detach()), float(jloss(
        *(jnp.asarray(a[k]) for k in names))), rtol=1e-5)
    got = torch.autograd.grad(loss, [leaves[k] for k in names])
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_backward_matches_autograd_of_the_plain_loop():
    """``gru_backward`` (the transcribed ``_bwd_rule``) against autograd
    through the plain loop, with padded steps inside the batch."""
    T, B, H = 5, 3, 8
    a = _inputs(T, B, H, seed=17)
    xs = torch.from_numpy(a["xs"] + a["b"])
    mask = torch.from_numpy(a["mask"])
    wg, ws = (t.contiguous() for t in _torch_w(a["w0"], H))
    h0 = torch.from_numpy(a["h0"])
    leaves = [t.clone().requires_grad_(True) for t in (xs, wg, ws, h0)]
    ys, hT = tgru.gru_sequence_plain(leaves[0], mask, *leaves[1:])
    dys, dhT = torch.from_numpy(a["dys"]), torch.from_numpy(a["dhT"])
    want = torch.autograd.grad((ys * dys).sum() + (hT * dhT).sum(), leaves)
    _, hs, gates = tgru.gru_sequence_residual_plain(xs, mask, wg, ws, h0)
    got = tgru.gru_backward(mask, wg, ws, h0, hs, gates, dys, dhT)
    for name, g, w in zip(("dxs", "dWg", "dWs", "dh0"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("B,H", [(3, 16), (1, 8), (5, 130)])
def test_gru_cell_matches_jax_cell_kernel(B, H):
    rng = np.random.default_rng(B * 1000 + H)
    x, h, w0, ct = (rng.normal(size=s).astype(np.float32) * sc
                    for s, sc in (((B, 3 * H), 1.0), ((B, H), 0.5),
                                  ((H, 3 * H), 0.3), ((B, H), 1.0)))
    jx, jh, jw = jnp.asarray(x), jnp.asarray(h), jnp.asarray(w0)
    with common.force_mode("interpret"):
        want_i = jcells.gru_cell_infer(jx, jh, jw[:, :2 * H], jw[:, 2 * H:])
        want, vjp = jax.vjp(
            lambda x_, h_, w_: jcells.gru_cell(x_, h_, w_[:, :2 * H],
                                               w_[:, 2 * H:]), jx, jh, jw)
        want_g = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (x, h, w0)]
    w = leaves[2]
    got = tcells.gru_cell(leaves[0], leaves[1], w[:, :2 * H], w[:, 2 * H:])
    with torch.no_grad():
        got_i = tcells.gru_cell_infer(leaves[0], leaves[1], w[:, :2 * H],
                                      w[:, 2 * H:])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), **FWD_TOL)
    got_g = torch.autograd.grad(got, leaves, torch.from_numpy(ct))
    for name, g, wg in zip(("dx", "dh", "dw0"), got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **GRAD_TOL,
                                   err_msg=name)


def test_gru_cell_non_default_activation_takes_the_inline_math():
    B, H = 4, 8
    rng = np.random.default_rng(3)
    x, h, w0 = (rng.normal(size=s).astype(np.float32) * 0.5
                for s in ((B, 3 * H), (B, H), (H, 3 * H)))
    with common.force_mode("interpret"):
        want = jcells.gru_cell(jnp.asarray(x), jnp.asarray(h),
                               jnp.asarray(w0[:, :2 * H]),
                               jnp.asarray(w0[:, 2 * H:]), act_input="relu")
    w = torch.from_numpy(w0)
    got = tcells.gru_cell(torch.from_numpy(x), torch.from_numpy(h),
                          w[:, :2 * H], w[:, 2 * H:], act_input="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)

"""Parity of the port's LSTM training path with the JAX package, on the CPU.

The residual forward (``lstm_seq_train``, plain version on the CPU) is held
against the JAX Pallas kernels' residual form (``_lstm_pallas`` and the
hidden-tiled ``_lstm_pallas_tiled``) in interpret mode, and every gradient
of ``lstm_sequence`` (``LstmFunction``: the residual forward and the
transcribed ``_bwd_rule``) against ``jax.grad`` of the JAX
``lstm_sequence`` in interpret mode (its ``_fwd_rule`` + ``_bwd_rule``)
and of the ``lstm_sequence_ref`` scan, for ragged masks, carried h0/c0,
``reverse`` and T=1.

Tolerances (ROADMAP's): forward rtol/atol 1e-5 (f32, XLA and PyTorch sum
h @ W in other orders over K=H and T steps); gradients rtol 1e-4 /
atol 1e-5 (the backward adds the reverse recurrence and dW summed over
T*B rows in one product, where JAX sums per step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import common
from paddle_tpu.ops import lstm as jlstm
from paddle_tpu_torch.ops import lstm as tlstm

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(T, B, H, seed, carried=True):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    zeros = np.zeros((B, H), np.float32)
    return dict(xs=f(T, B, 4 * H), mask=mask, w=f(H, 4 * H, scale=0.2),
                b=f(4 * H, scale=0.1), pI=f(H, scale=0.1),
                pF=f(H, scale=0.1), pO=f(H, scale=0.1),
                h0=f(B, H, scale=0.5) if carried else zeros,
                c0=f(B, H, scale=0.5) if carried else zeros,
                dys=f(T, B, H), dhT=f(B, H), dcT=f(B, H))


_RES_ARGS = ("mask", "w", "pI", "pF", "pO", "h0", "c0")


@pytest.mark.parametrize("T,B,H,tiled", [(6, 3, 16, False), (1, 2, 8, False),
                                         (6, 3, 16, True)])
def test_residual_forward_matches_jax_kernels(T, B, H, tiled):
    a = _inputs(T, B, H, seed=T * 10 + H)
    xs_b = a["xs"] + a["b"]
    jargs = [jnp.asarray(xs_b)] + [jnp.asarray(a[k]) for k in _RES_ARGS]
    with common.force_mode("interpret"):
        if tiled:
            want = jlstm._lstm_pallas_tiled(*jargs, with_residuals=True,
                                            hb=8)
        else:
            want = jlstm._lstm_pallas(*jargs, with_residuals=True)
    before = tlstm.lstm_seq_train.launches
    got = tlstm.lstm_seq_train(torch.from_numpy(xs_b),
                               *(torch.from_numpy(a[k]) for k in _RES_ARGS))
    assert tlstm.lstm_seq_train.launches == before  # CPU: plain version
    for name, g, w in zip(("ys", "hs", "cs", "gates"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL,
                                   err_msg=name)


_GRAD_ARGS = ("xs", "w", "b", "pI", "pF", "pO", "h0", "c0")


def _jax_grads(a, reverse, interpret):
    mask = jnp.asarray(a["mask"])

    def loss(xs, w, b, pI, pF, pO, h0, c0):
        if interpret:
            ys, hT, cT = jlstm.lstm_sequence(xs, mask, w, b, pI, pF, pO, h0,
                                             c0, reverse=reverse)
        else:
            ys, hT, cT = jlstm.lstm_sequence_ref(xs, mask, w, b, pI, pF, pO,
                                                 h0, c0)
        return (jnp.sum(ys * a["dys"]) + jnp.sum(hT * a["dhT"])
                + jnp.sum(cT * a["dcT"]))

    args = [jnp.asarray(a[k]) for k in _GRAD_ARGS]
    with common.force_mode("interpret" if interpret else "ref"):
        return jax.grad(loss, argnums=tuple(range(8)))(*args)


def _port_grads(a, reverse):
    ts = {k: torch.tensor(a[k], requires_grad=True) for k in _GRAD_ARGS}
    before = tlstm.lstm_bwd_step.launches
    ys, hT, cT = tlstm.lstm_sequence(
        ts["xs"], torch.from_numpy(a["mask"]), ts["w"], ts["b"], ts["pI"],
        ts["pF"], ts["pO"], ts["h0"], ts["c0"], reverse=reverse)
    loss = ((ys * torch.from_numpy(a["dys"])).sum()
            + (hT * torch.from_numpy(a["dhT"])).sum()
            + (cT * torch.from_numpy(a["dcT"])).sum())
    grads = torch.autograd.grad(loss, [ts[k] for k in _GRAD_ARGS])
    assert tlstm.lstm_bwd_step.launches == before  # CPU: plain version
    return grads


@pytest.mark.parametrize("T,B,H,reverse,carried", [
    (7, 4, 8, False, False),
    (12, 5, 16, False, True),
    (9, 3, 8, True, True),
    (1, 2, 4, False, True),
])
def test_lstm_gradients_match_jax(T, B, H, reverse, carried):
    """Every gradient (xs, W, gate bias, peepholes, h0, c0) against
    ``jax.grad`` through the Pallas kernel's custom VJP."""
    a = _inputs(T, B, H, seed=T * 100 + H, carried=carried)
    for name, g, w in zip(_GRAD_ARGS, _port_grads(a, reverse),
                          _jax_grads(a, reverse, interpret=True)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("T,B,H", [(10, 4, 8), (1, 3, 4)])
def test_lstm_gradients_match_jax_scan_reference(T, B, H):
    """... and against ``jax.grad`` of the pure ``lax.scan`` reference,
    autodiff through the whole forward (no custom VJP)."""
    a = _inputs(T, B, H, seed=T + 5 * H)
    for name, g, w in zip(_GRAD_ARGS, _port_grads(a, False),
                          _jax_grads(a, False, interpret=False)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_lstm_backward_step_chain_matches_bwd_rule():
    """``lstm_backward`` over the port's residuals against JAX ``_bwd_rule``
    over the JAX kernel's residuals, with the cotangents given directly."""
    T, B, H = 8, 3, 8
    a = _inputs(T, B, H, seed=41)
    xs_b = a["xs"] + a["b"]
    jargs = [jnp.asarray(xs_b)] + [jnp.asarray(a[k]) for k in _RES_ARGS]
    with common.force_mode("interpret"):
        _, res = jlstm._fwd_rule(*jargs)
    want = jlstm._bwd_rule(res, (jnp.asarray(a["dys"]), jnp.asarray(a["dhT"]),
                                 jnp.asarray(a["dcT"])))
    want = [w for w in want if w is not None]
    t = {k: torch.from_numpy(a[k]) for k in a}
    _, hs, cs, gates = tlstm.lstm_seq_train(torch.from_numpy(xs_b),
                                            *(t[k] for k in _RES_ARGS))
    got = tlstm.lstm_backward(*(t[k] for k in _RES_ARGS), hs, cs, gates,
                              t["dys"], t["dhT"], t["dcT"])
    for name, g, w in zip(("dxs", "dW", "dpI", "dpF", "dpO", "dh0", "dc0"),
                          got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_lstm_sequence_takes_lean_kernel_without_grad():
    """No input requires grad (or grad is off): the primal path, no
    residuals and no autograd node."""
    a = _inputs(5, 2, 4, seed=3)
    args = [torch.from_numpy(a[k]) for k in ("xs", "mask", "w", "b", "pI",
                                             "pF", "pO", "h0", "c0")]
    ys, _, _ = tlstm.lstm_sequence(*args)
    assert ys.grad_fn is None
    w = args[2].clone().requires_grad_(True)
    with torch.no_grad():
        ys, _, _ = tlstm.lstm_sequence(*args[:2], w, *args[3:])
    assert ys.grad_fn is None
    ys, _, _ = tlstm.lstm_sequence(*args[:2], w, *args[3:])
    assert ys.grad_fn is not None

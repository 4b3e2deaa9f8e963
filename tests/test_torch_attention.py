"""The port's flash attention against the JAX package, on the CPU: the op
(``paddle_tpu_torch/ops/attention.py``; on CPU tensors its wrappers run
their plain versions) and the ``multi_head_attention`` layer through both
DSLs, at small sizes (head width D <= 16, T <= 40), inputs from a numpy
seed.

The JAX side runs ``flash_attention`` under ``force_mode("interpret")``
with ``block_q = block_k = 16``, as ``tests/test_ops_pallas.py`` runs it,
so its Pallas kernel ``_flash_kernel`` is taken (several q and kv blocks,
padded tails) and its gradient is ``jax.vjp`` of ``blockwise_attention``;
the forward is also held against ``blockwise_attention`` itself.

Tolerances: forward rtol/atol 1e-5 (f32 sums over D and Tk in another
order); gradients rtol 1e-4 / atol 1e-5 (the analytic backward against
JAX's recompute through the online softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.ops import common
from paddle_tpu.ops.attention import blockwise_attention, flash_attention
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.ops import attention as tattn

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(B, N, Tq, Tk, D, seed, all_padding=False):
    """q, k, v, the cotangent dO and a ragged kv mask (row 0 full; with
    ``all_padding`` the last row has no real key)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    lens = rng.integers(1, Tk + 1, size=B)
    lens[0] = Tk
    if all_padding:
        lens[-1] = 0
    mask = (np.arange(Tk)[None, :] < lens[:, None]).astype(np.float32)
    return f(B, N, Tq, D), f(B, N, Tk, D), f(B, N, Tk, D), mask, \
        f(B, N, Tq, D)


def _jax_flash(q, k, v, mask, causal, do):
    """JAX's flash attention (the Pallas kernel, interpreted) and the
    gradients of sum(o * dO) through its custom vjp."""
    def loss(q_, k_, v_):
        return jnp.sum(flash_attention(q_, k_, v_, jnp.asarray(mask),
                                       causal=causal, block_q=16,
                                       block_k=16) * do)

    args = tuple(jnp.asarray(a) for a in (q, k, v))
    with common.force_mode("interpret"):
        out = flash_attention(*args, jnp.asarray(mask), causal=causal,
                              block_q=16, block_k=16)
        grads = jax.grad(loss, (0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_flash(q, k, v, mask, causal, do):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tattn.flash_attention(*leaves, torch.from_numpy(mask),
                                causal=causal)
    grads = torch.autograd.grad((out * torch.from_numpy(do)).sum(), leaves)
    return out.detach().numpy(), [g.numpy() for g in grads]


# (B, N, Tq, Tk, D, causal): self-attention over several 16-blocks;
# cross with Tq < Tk and ragged tails; cross with Tq > Tk, where causal
# hides every key from the first Tq - Tk queries
CASES = [(2, 2, 40, 40, 8, False), (2, 2, 40, 40, 8, True),
         (3, 2, 17, 33, 16, False), (3, 2, 17, 33, 16, True),
         (2, 1, 23, 9, 8, False), (2, 1, 23, 9, 8, True)]


@pytest.mark.parametrize("B,N,Tq,Tk,D,causal", CASES)
def test_flash_attention_matches_jax(B, N, Tq, Tk, D, causal):
    """Forward against JAX's Pallas kernel (interpreted) and
    ``blockwise_attention``; dq, dk, dv against ``jax.grad`` through its
    custom vjp."""
    q, k, v, mask, do = _inputs(B, N, Tq, Tk, D, seed=B * Tq + Tk + causal)
    j_out, j_grads = _jax_flash(q, k, v, mask, causal, do)
    t_out, t_grads = _port_flash(q, k, v, mask, causal, do)
    np.testing.assert_allclose(t_out, j_out, **FWD_TOL)
    blk = blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              jnp.asarray(mask), causal=causal, block_k=16)
    np.testing.assert_allclose(t_out, np.asarray(blk), **FWD_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), t_grads, j_grads):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_analytic_backward_matches_autograd_of_plain_attention(causal):
    """``flash_bwd_plain`` from ``blockwise_plain``'s row statistics
    against torch autograd through ``mha_plain``, in float64 too (where
    the two must agree to rounding)."""
    q, k, v, mask, do = _inputs(3, 2, 29, 37, 16, seed=7 + causal)
    for dtype, tol in ((torch.float32, GRAD_TOL),
                       (torch.float64, dict(rtol=1e-10, atol=1e-12))):
        t = [torch.from_numpy(a).to(dtype) for a in (q, k, v, mask, do)]
        o, lse = tattn.blockwise_plain(*t[:4], causal)
        got = tattn.flash_bwd_plain(*t[:4], o, lse, t[4], causal)
        leaves = [x.clone().requires_grad_(True) for x in t[:3]]
        ref = tattn.mha_plain(*leaves, t[3], causal)
        torch.testing.assert_close(o, ref.detach(), **tol)
        want = torch.autograd.grad((ref * t[4]).sum(), leaves)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(g, w, **tol, msg=name)


def test_all_padding_row_is_finite_with_zero_dq():
    """A batch row whose every key is masked: every score is -1e9, so the
    output is the uniform mean of v over the Tk keys (finite, as JAX's),
    dq is exactly 0 and dv takes 1/Tk of each dO row; all as JAX gives."""
    q, k, v, mask, do = _inputs(3, 2, 12, 12, 8, seed=3, all_padding=True)
    t_out, (dq, dk, dv) = _port_flash(q, k, v, mask, False, do)
    assert np.isfinite(t_out).all() and np.isfinite(dq).all()
    np.testing.assert_allclose(t_out[-1], np.broadcast_to(
        v[-1].mean(axis=1, keepdims=True), t_out[-1].shape), **FWD_TOL)
    assert np.abs(dq[-1]).max() == 0.0 and np.abs(dk[-1]).max() == 0.0
    np.testing.assert_allclose(dv[-1], np.broadcast_to(
        do[-1].sum(axis=1, keepdims=True) / 12, dv[-1].shape), **FWD_TOL)
    j_out, j_grads = _jax_flash(q, k, v, mask, False, do)
    np.testing.assert_allclose(t_out, j_out, **FWD_TOL)
    for g, w in zip((dq, dk, dv), j_grads):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def _no_key_rows(mask, Tq, Tk, causal):
    """[B, Tq] bool: the query rows that see no key."""
    vis = np.broadcast_to(mask[:, None, :] > 0, (mask.shape[0], Tq, Tk))
    if causal:
        vis = vis & (np.arange(Tk)[None, :] <= np.arange(Tq)[:, None]
                     + (Tk - Tq))
    return ~vis.any(axis=-1)


# rows that see no key, at JAX's default blocks (block_k = 256): (a) an
# all-padding kv row with Tk > 256 and Tk % 256 != 0, (b) causal with
# Tq > Tk
@pytest.mark.parametrize("B,N,Tq,Tk,D,causal,all_padding", [
    (2, 2, 16, 333, 8, False, True), (2, 1, 333, 200, 8, True, False)])
def test_rows_without_a_key_match_jax(B, N, Tq, Tk, D, causal, all_padding):
    """``blockwise_plain`` and ``flash_bwd_plain`` against JAX's
    ``flash_attention`` (the Pallas kernel, interpreted, at its default
    blocks) and ``jax.grad`` through it: JAX pads Tk to a multiple of
    min(256, Tk) with masked zero keys, so a row that sees no key gets
    sum_j v_j / Tk_pad, a dv share of dO / Tk_pad and a zero dq."""
    q, k, v, mask, do = _inputs(B, N, Tq, Tk, D, seed=Tq + Tk,
                                all_padding=all_padding)

    def loss(q_, k_, v_):
        return jnp.sum(flash_attention(q_, k_, v_, jnp.asarray(mask),
                                       causal=causal) * do)

    args = tuple(jnp.asarray(a) for a in (q, k, v))
    with common.force_mode("interpret"):
        j_out = np.asarray(flash_attention(*args, jnp.asarray(mask),
                                           causal=causal))
        j_grads = [np.asarray(g) for g in jax.grad(loss, (0, 1, 2))(*args)]
    t_out, t_grads = _port_flash(q, k, v, mask, causal, do)
    np.testing.assert_allclose(t_out, j_out, **FWD_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), t_grads, j_grads):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)
    rows = _no_key_rows(mask, Tq, Tk, causal)
    assert rows.any()
    bk = min(256, Tk)
    tk_pad = -(-Tk // bk) * bk
    b, i = np.nonzero(rows)
    np.testing.assert_allclose(
        t_out[b, :, i], v[b].sum(axis=2) / tk_pad, **FWD_TOL)
    assert np.abs(t_grads[0][b, :, i]).max() == 0.0
    _, lse = tattn.blockwise_plain(*(torch.from_numpy(a) for a in
                                     (q, k, v, mask)), causal)
    lse = lse.reshape(2, B, N, Tq).numpy()
    assert (lse[0][b, :, i] == -1e9).all()
    np.testing.assert_allclose(lse[1][b, :, i], np.log(tk_pad), rtol=1e-6)


def test_row_statistics_are_the_log_sum_exp():
    """``lse`` holds (m, log l): m + log l is the row log-sum-exp of the
    masked, scaled scores."""
    q, k, v, mask, _ = _inputs(2, 2, 9, 21, 8, seed=11)
    t = [torch.from_numpy(a).double() for a in (q, k, v, mask)]
    _, lse = tattn.flash_fwd(*t, True)
    s = torch.einsum("bnqd,bnkd->bnqk", t[0], t[1]) * 8 ** -0.5
    s = s.masked_fill(~(t[3][:, None, None, :] > 0), -1e9)
    qi = torch.arange(9)[:, None] + 12
    s = s.masked_fill(~(torch.arange(21)[None, :] <= qi), -1e9)
    torch.testing.assert_close((lse[0] + lse[1]).reshape(2, 2, 9),
                               torch.logsumexp(s, dim=-1))


# ------------------------------------------------------------- the layer
def _layer_graph(dsl, cross, causal, bias):
    x = dsl.data(name="x", size=12, is_sequence=True)
    kv = dsl.data(name="kv", size=10, is_sequence=True) if cross else None
    return dsl.multi_head_attention(x, kv, size=16, num_heads=2,
                                    causal=causal, bias_attr=bias)


@pytest.mark.parametrize("cross,causal,bias", [
    (False, False, True), (False, True, False), (True, False, False),
    (True, True, True)])
def test_layer_matches_jax(cross, causal, bias):
    """The same LayerDef, auto-name, parameter names and shapes from both
    DSLs; the layer's output and every parameter and input gradient
    against the JAX layer (its flash kernel interpreted), with ragged
    masks and an all-padding row (the output there is 0, as the query
    mask multiplies it)."""
    jdsl.reset()
    jout = _layer_graph(jdsl, cross, causal, bias)
    tdsl.reset()
    tout = _layer_graph(tdsl, cross, causal, bias)
    assert tout.name == jout.name == "__mha_layer_0__"
    jl, tl = jout.graph.layers[jout.name], tout.graph.layers[tout.name]
    assert (tl.type, tl.size, tl.act, tl.input_names(), tl.attrs) == (
        jl.type, jl.size, jl.act, jl.input_names(), jl.attrs)
    jnet = JNetwork(jout.graph, outputs=[jout.name])
    tnet = TNetwork(tout.graph, outputs=[tout.name])
    assert sorted(tnet.param_specs) == sorted(jnet.param_specs)
    for k, spec in jnet.param_specs.items():
        assert tuple(tnet.param_specs[k].shape) == tuple(spec.shape), k
        assert tnet.param_specs[k].init == spec.init, k
    want = {"___mha_layer_0__.wq", "___mha_layer_0__.wk",
            "___mha_layer_0__.wv", "___mha_layer_0__.wo"}
    assert want <= set(tnet.param_specs)
    assert ("___mha_layer_0__.wbias" in tnet.param_specs) == bias

    rng = np.random.default_rng(int(cross) * 4 + int(causal) * 2 + bias)
    params = {k: (rng.normal(size=s.shape) * 0.4).astype(np.float32)
              for k, s in jnet.param_specs.items()}
    B, Tq, Tk = 3, 7, 11 if cross else 7
    xq = rng.normal(size=(B, Tq, 12)).astype(np.float32)
    mq = (np.arange(Tq)[None, :] < np.array([[Tq], [4], [0]])).astype(
        np.float32)
    feeds = {"x": (xq, mq)}
    if cross:
        xkv = rng.normal(size=(B, Tk, 10)).astype(np.float32)
        mkv = (np.arange(Tk)[None, :] < np.array([[Tk], [6], [0]])).astype(
            np.float32)
        feeds["kv"] = (xkv, mkv)
    ct = rng.normal(size=(B, Tq, 16)).astype(np.float32)

    masks = [m for _, m in feeds.values()]

    def jloss(p, xs):
        with common.force_mode("interpret"):
            outs = jnet.apply(p, {n: JArgument(x, jnp.asarray(m))
                                  for n, x, m in zip(feeds, xs, masks)})
        return jnp.sum(outs[jout.name].value * ct), outs[jout.name]

    (_, j_arg), (jg, jgx) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()},
        [jnp.asarray(x) for x, _ in feeds.values()])
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = [torch.from_numpy(x).requires_grad_(True) for x, _ in feeds.values()]
    t_arg = tnet.apply(tp, {n: TArgument(x, torch.from_numpy(m))
                            for n, x, m in zip(feeds, tx, masks)})[tout.name]
    np.testing.assert_allclose(t_arg.value.detach().numpy(),
                               np.asarray(j_arg.value), **FWD_TOL)
    np.testing.assert_array_equal(t_arg.mask.numpy(), mq)
    assert np.abs(t_arg.value.detach().numpy()[2]).max() == 0.0
    grads = torch.autograd.grad((t_arg.value * torch.from_numpy(ct)).sum(),
                                list(tp.values()) + tx)
    for k, g in zip(tp, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), **GRAD_TOL,
                                   err_msg=k)
    for i, g in enumerate(grads[len(tp):]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgx[i]),
                                   **GRAD_TOL, err_msg=f"input {i}")


def test_dsl_refuses_an_unknown_seq_parallel_as_jax_does():
    for dsl in (jdsl, tdsl):
        dsl.reset()
        x = dsl.data(name="x", size=8, is_sequence=True)
        with pytest.raises(ValueError, match="ring/ulysses"):
            dsl.multi_head_attention(x, num_heads=2, seq_parallel="ring2")


@pytest.mark.parametrize("causal", [False, True])
def test_pad_and_slice_around_the_plain_versions_is_exact(causal):
    """A head width that is no kernel instance (D = 40) runs padded with
    zero columns to the next instance (64) and sliced back, with the scale
    of the true D: around ``blockwise_plain`` and ``flash_bwd_plain`` the
    helpers give exactly the unpadded results (o, the row statistics, dq,
    dk, dv), an all-padding kv row included. D > 128 has no instance: it
    takes the wide-head path unpadded up to 1024, the split-row path
    above."""
    q, k, v, mask, do = (torch.from_numpy(a) for a in _inputs(
        3, 2, 20, 33, 40, 11, all_padding=True))
    scale = 40 ** -0.5
    assert tattn.padded_width(40) == 64 and tattn.padded_width(32) == 32
    o, lse = tattn.blockwise_plain(q, k, v, mask, causal, scale)
    p_o, p_lse = tattn.fwd_padded(tattn.blockwise_plain, 64, q, k, v, mask,
                                  causal, scale)
    assert p_o.shape == o.shape
    assert torch.equal(p_o, o) and torch.equal(p_lse, lse)
    want = tattn.flash_bwd_plain(q, k, v, mask, o, lse, do, causal, scale)
    got = tattn.bwd_padded(tattn.flash_bwd_plain, 64, q, k, v, mask, o, lse,
                           do, causal, scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    assert tattn.padded_width(129) == 129
    assert tattn.padded_width(1025) == 1025

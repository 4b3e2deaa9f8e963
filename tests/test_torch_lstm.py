"""Parity of the PyTorch port's LSTM path with the JAX package, on the CPU.

The same inputs, made from a numpy seed, go through the JAX function and
its port counterpart. On the CPU the port's kernel wrapper takes its plain
PyTorch version; the JAX side runs its Pallas kernels in interpret mode
(as ``tests/test_ops_pallas.py`` does) and through ``lstm_sequence_ref``.
Tolerance: rtol/atol 1e-5 (f32, summation order differs between XLA and
PyTorch over K=H and T steps of recurrence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.models.lstm_text import lstm_text_classifier as j_classifier
from paddle_tpu.ops import common
from paddle_tpu.ops import lstm as jlstm
from paddle_tpu_torch.compat.from_jax import params_from_numpy
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.models.lstm_text import \
    lstm_text_classifier as t_classifier
from paddle_tpu_torch.ops import lstm as tlstm

TOL = dict(rtol=1e-5, atol=1e-5)


def _ragged_mask(T, B, rng):
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    return (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)


def _lstm_inputs(T, B, H, seed, carried):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    xs, mask = f(T, B, 4 * H), _ragged_mask(T, B, rng)
    w, b = f(H, 4 * H, scale=0.2), f(4 * H, scale=0.1)
    pI, pF, pO = f(H, scale=0.1), f(H, scale=0.1), f(H, scale=0.1)
    if carried:
        h0, c0 = f(B, H, scale=0.5), f(B, H, scale=0.5)
    else:
        h0 = c0 = np.zeros((B, H), np.float32)
    return xs, mask, w, b, pI, pF, pO, h0, c0


@pytest.mark.parametrize("T,B,H,reverse,carried", [
    (7, 4, 8, False, False),
    (12, 5, 16, False, True),
    (9, 3, 8, True, True),
    (1, 2, 4, False, True),
])
def test_lstm_sequence_matches_jax(T, B, H, reverse, carried):
    args = _lstm_inputs(T, B, H, seed=T * 100 + H, carried=carried)
    with common.force_mode("interpret"):
        j_ys, j_hT, j_cT = jlstm.lstm_sequence(
            *map(jnp.asarray, args), reverse=reverse)
    before = tlstm.lstm_seq.launches
    t_ys, t_hT, t_cT = tlstm.lstm_sequence(*map(torch.from_numpy, args),
                                           reverse=reverse)
    assert tlstm.lstm_seq.launches == before  # CPU tensors: plain version
    for got, want in ((t_ys, j_ys), (t_hT, j_hT), (t_cT, j_cT)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if not reverse:
        r_ys, r_hT, r_cT = jlstm.lstm_sequence_ref(*map(jnp.asarray, args))
        np.testing.assert_allclose(t_ys.numpy(), np.asarray(r_ys), **TOL)
        np.testing.assert_allclose(t_cT.numpy(), np.asarray(r_cT), **TOL)


def test_lstm_seq_matches_jax_tiled_kernel():
    """The hidden-tiled Pallas kernel (h=1280 on the TPU) computes the same
    function; at a small width with two gate-column blocks it runs in
    interpret mode."""
    T, B, H, hb = 6, 3, 16, 8
    xs, mask, w, b, pI, pF, pO, h0, c0 = _lstm_inputs(T, B, H, seed=7,
                                                      carried=True)
    xs_b = xs + b
    with common.force_mode("interpret"):
        j_ys, j_hT, j_cT = jlstm._lstm_pallas_tiled(
            *map(jnp.asarray, (xs_b, mask, w, pI, pF, pO, h0, c0)),
            with_residuals=False, hb=hb)
    t_ys, t_hT, t_cT = tlstm.lstm_seq(
        *map(torch.from_numpy, (xs_b, mask, w, pI, pF, pO, h0, c0)))
    for got, want in ((t_ys, j_ys), (t_hT, j_hT), (t_cT, j_cT)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _classifier_feeds(rng, B, T, vocab, oov):
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    ids = rng.integers(0, vocab, size=(B, T)).astype(np.int32)
    if oov:
        ids[0, 0] = vocab + 3    # beyond the table: reads a zero row
        ids[-1, 0] = -1          # the OOV sentinel: reads a zero row
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    ids = ids * mask.astype(np.int32)
    if oov:
        ids[0, 0], ids[-1, 0] = vocab + 3, -1
    labels = rng.integers(0, 2, size=B).astype(np.int32)
    return ids, mask, labels


def _build_pair(build_j, build_t):
    jdsl.reset()
    build_j()
    jgraph = jdsl.current_graph()
    tdsl.reset()
    build_t()
    tgraph = tdsl.current_graph()
    return jgraph, tgraph


def _run_pair(jgraph, tgraph, out, feeds, seed):
    jnet = JNetwork(jgraph, outputs=[out])
    tnet = TNetwork(tgraph, outputs=[out])
    assert jnet.order == tnet.order
    assert {k: tuple(v.shape) for k, v in jnet.param_specs.items()} == \
        {k: tuple(v.shape) for k, v in tnet.param_specs.items()}
    jparams = jnet.init_params(jax.random.PRNGKey(seed))
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    # the zero-initialised biases and peepholes get values, so they count
    rng = np.random.default_rng(seed)
    for k, v in np_params.items():
        if not v.any():
            np_params[k] = (rng.normal(size=v.shape) * 0.1).astype(
                np.float32)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    tparams = params_from_numpy(np_params, "cpu", tnet)
    jfeed = {k: JArgument(value=jnp.asarray(v),
                          mask=None if m is None else jnp.asarray(m))
             for k, (v, m) in feeds.items()}
    tfeed = {k: TArgument(value=torch.from_numpy(v),
                          mask=None if m is None else torch.from_numpy(m))
             for k, (v, m) in feeds.items()}
    with common.force_mode("interpret"):
        want = jnet.apply(jparams, jfeed, train=False)
    got = tnet.apply(tparams, tfeed, train=False)
    return got, want


@pytest.mark.parametrize("oov", [False, True])
def test_lstm_text_classifier_forward_matches_jax(oov):
    V, E, H = 50, 6, 8
    jgraph, tgraph = _build_pair(
        lambda: j_classifier(vocab_size=V, embed_dim=E, hidden=H),
        lambda: t_classifier(vocab_size=V, embed_dim=E, hidden=H))
    rng = np.random.default_rng(11)
    ids, mask, labels = _classifier_feeds(rng, B=5, T=12, vocab=V, oov=oov)
    feeds = {"words": (ids, mask), "label": (labels, None)}
    got, want = _run_pair(jgraph, tgraph, "output", feeds, seed=3)
    for name in ("embed", "lstm0", "lstm1", "pool_time", "output"):
        np.testing.assert_allclose(got[name].value.numpy(),
                                   np.asarray(want[name].value), **TOL)
    np.testing.assert_allclose(got["output"].value.sum(-1).numpy(), 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("act,reverse", [("tanh", True), ("relu", False),
                                         ("relu", True)])
def test_lstmemory_variants_match_jax(act, reverse):
    """reverse=True through the fused path, and the inline step that
    non-default activations take, against the JAX layer."""
    V, E, H = 30, 4, 8

    def build(dsl):
        w = dsl.data(name="words", size=V, is_sequence=True)
        x = dsl.embedding(input=w, size=E, name="embed")
        p = dsl.fc(input=x, size=4 * H, act="linear", name="proj")
        dsl.lstmemory(input=p, name="lstm", reverse=reverse, act=act)

    jgraph, tgraph = _build_pair(lambda: build(jdsl), lambda: build(tdsl))
    rng = np.random.default_rng(5)
    ids, mask, _ = _classifier_feeds(rng, B=4, T=9, vocab=V, oov=False)
    got, want = _run_pair(jgraph, tgraph, "lstm",
                          {"words": (ids, mask)}, seed=8)
    np.testing.assert_allclose(got["lstm"].value.numpy(),
                               np.asarray(want["lstm"].value), **TOL)
    for g, w in zip(got["lstm"].state, want["lstm"].state):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

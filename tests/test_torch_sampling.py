"""``nce``, ``hsigmoid`` and ``sample_gaussian`` in the port against the
JAX package, on the CPU.

The training draws are JAX's, replayed through the port's helpers
(``layers/sampling.py:_nce_negatives`` and ``_gaussian_eps``): nce's
negatives are ``jax.random.randint`` and the sample's ε
``jax.random.normal`` under ``fold_in(key, crc32(name))``. Values rtol
1e-5 / atol 1e-5, gradients rtol 1e-4 / atol 1e-5.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.layers import sampling

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
KEY = jax.random.PRNGKey(1)


def _layer_key(name):
    return jax.random.fold_in(KEY, zlib.crc32(name.encode()))


def _replay(monkeypatch):
    """Route the port's draws through JAX's, and record them."""
    drawn = {}

    def negatives(shape, num_classes, ctx, name, device):
        drawn[name] = np.asarray(jax.random.randint(
            _layer_key(name), tuple(shape), 0, num_classes))
        return torch.from_numpy(drawn[name].astype(np.int64))

    def eps(shape, dtype, ctx, name, device):
        drawn[name] = np.array(jax.random.normal(
            _layer_key(name), tuple(shape), jnp.float32))
        return torch.from_numpy(drawn[name])

    monkeypatch.setattr(sampling, "_nce_negatives", negatives)
    monkeypatch.setattr(sampling, "_gaussian_eps", eps)
    return drawn


def _pair(build):
    jdsl.reset()
    out = build(jdsl)
    jnet = JNetwork(jdsl.current_graph(), outputs=[out.name])
    tdsl.reset()
    build(tdsl)
    tnet = TNetwork(tdsl.current_graph(), outputs=[out.name])
    assert {k: tuple(s.shape) for k, s in jnet.param_specs.items()} == \
        {k: tuple(s.shape) for k, s in tnet.param_specs.items()}
    return jnet, tnet, out.name


def _compare(jnet, tnet, name, feed, train, seed=0):
    """The output and every parameter's and float input's gradient of
    sum(out * w), port against JAX."""
    rng = np.random.default_rng(seed)
    params = {k: (rng.normal(size=s.shape) * 0.5).astype(np.float32)
              for k, s in sorted(jnet.param_specs.items())}
    floats = sorted(k for k, v in feed.items()
                    if np.issubdtype(v.dtype, np.floating))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    tx = {k: torch.from_numpy(v.copy()).requires_grad_(k in floats)
          for k, v in feed.items()}
    tout = tnet.apply(tp, {k: TArgument(value=v) for k, v in tx.items()},
                      train=train, seed=7)[name].value

    def jout(p, xs):
        f = {k: JArgument(value=xs.get(k, jnp.asarray(v)))
             for k, v in feed.items()}
        return jnet.apply(p, f, train=train, rng=KEY)[name].value

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jv = np.asarray(jout(jp, {}))
    np.testing.assert_allclose(tout.detach().numpy(), jv, **FWD_TOL)
    w = rng.normal(size=jv.shape).astype(np.float32)
    leaves = [tp[k] for k in sorted(tp)] + [tx[k] for k in floats]
    tg = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), leaves,
                             allow_unused=True)
    gp, gx = jax.grad(lambda p, xs: jnp.sum(jout(p, xs) * w),
                      argnums=(0, 1))(jp, {k: jnp.asarray(feed[k])
                                           for k in floats})
    for n, g, want in zip(sorted(tp) + floats, tg,
                          [gp[k] for k in sorted(tp)]
                          + [gx[k] for k in floats]):
        got = np.zeros(want.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(got, np.asarray(want), **GRAD_TOL,
                                   err_msg=n)
    return tout.detach().numpy()


def _feed(B=8, D=6, C=10, seed=0, weight=False):
    rng = np.random.RandomState(seed)
    feed = {"x": rng.randn(B, D).astype(np.float32),
            "lab": rng.randint(0, C, (B, 1)).astype(np.int32)}
    if weight:
        feed["w"] = rng.rand(B, 1).astype(np.float32)
    return feed


def _nce_net(C=10, K=5, weight=False, bias=True):
    def build(dsl):
        x = dsl.data("x", size=6)
        lab = dsl.data("lab", size=1)
        w = dsl.data("w", size=1) if weight else None
        return dsl.nce_layer(x, lab, num_classes=C, num_neg_samples=K,
                             weight=w, name="nce", bias_attr=bias)
    return build


@pytest.mark.parametrize("weight", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_nce_training_with_jax_negatives_replayed(monkeypatch, weight,
                                                  bias):
    drawn = _replay(monkeypatch)
    jnet, tnet, name = _pair(_nce_net(weight=weight, bias=bias))
    _compare(jnet, tnet, name, _feed(weight=weight), train=True)
    assert drawn["nce"].shape == (8, 5)


@pytest.mark.parametrize("C,K", [(10, 5), (8, 4), (2048, 10), (3, 7)])
def test_nce_evaluation_strided_negatives(C, K):
    jnet, tnet, name = _pair(_nce_net(C=C, K=K))
    _compare(jnet, tnet, name, _feed(C=C), train=False)


def test_nce_port_draws_repeat_under_one_seed():
    """Without the replay the port draws its own negatives: the same step
    seed the same cost, another seed another cost."""
    tdsl.reset()
    _nce_net(C=50)(tdsl)
    net = TNetwork(tdsl.current_graph(), outputs=["nce"])
    rng = np.random.default_rng(1)
    params = {k: torch.from_numpy((rng.normal(size=s.shape) * 0.5).astype(
        np.float32)) for k, s in net.param_specs.items()}
    feed = {k: TArgument(value=torch.from_numpy(v))
            for k, v in _feed(C=50).items()}
    a = net.apply(params, feed, train=True, seed=3)["nce"].value
    assert torch.equal(a, net.apply(params, feed, train=True,
                                    seed=3)["nce"].value)
    assert not torch.equal(a, net.apply(params, feed, train=True,
                                        seed=4)["nce"].value)


@pytest.mark.parametrize("C", [2, 3, 10, 1000, 1023, 1024, 2048])
@pytest.mark.parametrize("two_inputs", [False, True])
def test_hsigmoid_matches_jax(C, two_inputs):
    """Class counts that are and are not powers of two; the inputs before
    the label concatenated."""
    def build(dsl):
        x = dsl.data("x", size=6)
        srcs = [x, dsl.data("x2", size=3)] if two_inputs else x
        lab = dsl.data("lab", size=1)
        return dsl.hsigmoid(srcs, lab, num_classes=C, name="hs")
    feed = _feed(C=C)
    if two_inputs:
        feed["x2"] = np.random.RandomState(5).randn(8, 3).astype(np.float32)
    jnet, tnet, name = _pair(build)
    _compare(jnet, tnet, name, feed, train=True)


def test_sample_gaussian_training_with_jax_eps_replayed(monkeypatch):
    drawn = _replay(monkeypatch)

    def build(dsl):
        mu = dsl.data("mu", size=4)
        lv = dsl.data("lv", size=4)
        from paddle_tpu.config.model_config import Input as JI, LayerDef as JL
        from paddle_tpu_torch.config.model_config import (Input as TI,
                                                          LayerDef as TL)
        I, L = (JI, JL) if dsl is jdsl else (TI, TL)
        return dsl._add(L(name="z", type="sample_gaussian",
                          inputs=[I(mu.name), I(lv.name)], bias=False))
    rng = np.random.RandomState(2)
    feed = {"mu": rng.randn(5, 4).astype(np.float32),
            "lv": rng.randn(5, 4).astype(np.float32)}
    jnet, tnet, name = _pair(build)
    out = _compare(jnet, tnet, name, feed, train=True)
    np.testing.assert_allclose(
        out, feed["mu"] + drawn["z"] * np.exp(feed["lv"] / 2), rtol=1e-5,
        atol=1e-6)
    out = _compare(jnet, tnet, name, feed, train=False)
    np.testing.assert_array_equal(out, feed["mu"])


def test_nce_hsigmoid_descend():
    """Twin of ``tests/test_misc_layers.py``'s descent: one SGD step on
    each cost (the port's own draws) lowers it."""
    rng = np.random.RandomState(0)
    B, D, C = 8, 6, 10
    tdsl.reset()
    x = tdsl.data("x", size=D)
    lab = tdsl.data("lab", size=1)
    n = tdsl.nce_layer(x, lab, num_classes=C, num_neg_samples=5, name="nce")
    hs = tdsl.hsigmoid(x, lab, num_classes=C, name="hs")
    net = TNetwork(tdsl.current_graph(), outputs=[n.name, hs.name])
    params = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    feed = {"x": TArgument(value=torch.from_numpy(
        rng.randn(B, D).astype(np.float32))),
        "lab": TArgument(value=torch.from_numpy(rng.randint(0, C, (B, 1))))}

    def loss(p, which):
        return net.apply(p, feed, train=True, seed=1)[which].value.mean()

    for which in (n.name, hs.name):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        l0 = loss(p, which)
        gs = torch.autograd.grad(l0, [p[k] for k in sorted(p)],
                                 allow_unused=True)
        p2 = {k: (p[k] - 0.1 * g if g is not None else p[k]).detach()
              for k, g in zip(sorted(p), gs)}
        assert torch.isfinite(l0) and loss(p2, which) < l0

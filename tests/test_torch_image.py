"""The port's image layers against the JAX package, on the CPU: conv
(``exconv``), conv-trans (``exconvt``), pool, spp, batch norm, cross-map
norm and the channel-wise concat of images, each built with both DSLs
from the same calls, given the same parameters and the same inputs (numpy,
seeded), forward and gradient (of a fixed random weighting of the output,
with respect to every parameter and the input).

The JAX side runs eagerly (``lax.conv_general_dilated``,
``lax.reduce_window``, ``jnp``: no Pallas kernel lies on this path); the
port's layers are ``F.conv2d`` / ``F.conv_transpose2d`` / the pools on an
explicitly padded NCHW view.

Tolerances: forward rtol/atol 1e-5, gradients rtol 1e-4 / atol 1e-5
(ROADMAP's: f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.config import model_config as jmc
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.config import model_config as tmc
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.core.registry import get_layer_impl

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B = 3


def _layer(dsl, mc, type_, inputs, extras=None, **kw):
    """A layer the DSL has no function for (several conv inputs, spp),
    added through the DSL's own ``_add`` so shape inference runs."""
    ins = [mc.Input(i.name, extra=dict(e or {}))
           for i, e in zip(inputs, extras or [None] * len(inputs))]
    return dsl._add(mc.LayerDef(type=type_, inputs=ins, **kw))


def _graphs(build):
    """(JAX network, port network, output name): ``build(dsl, mc)`` runs
    once per package on a fresh graph."""
    jdsl.reset()
    jname = build(jdsl, jmc).name
    jg = jdsl.current_graph()
    tdsl.reset()
    tname = build(tdsl, tmc).name
    tg = tdsl.current_graph()
    assert jname == tname
    return JNetwork(jg, outputs=[jname]), TNetwork(tg, outputs=[tname]), \
        tname


def _params(jnet, tnet, seed):
    """Random parameters for both, by name; a moving variance positive."""
    assert {k: tuple(s.shape) for k, s in jnet.param_specs.items()} == \
        {k: tuple(s.shape) for k, s in tnet.param_specs.items()}
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in sorted(jnet.param_specs.items()):
        p = (rng.normal(size=s.shape) * 0.5).astype(np.float32)
        out[k] = np.abs(p) + 0.5 if k.endswith(".w2") else p
    return out


def _check(build, feeds, *, train=False, seed=0, updates=None):
    """Forward and gradients of one layer graph in both packages.
    ``feeds``: name -> (value, mask or None) numpy. ``updates``: the state
    update names the train forward must record (compared too)."""
    jnet, tnet, name = _graphs(build)
    params = _params(jnet, tnet, seed)
    tp = {k: torch.from_numpy(v).requires_grad_(
        not tnet.param_specs[k].is_static) for k, v in params.items()}
    tx = {k: torch.from_numpy(v).requires_grad_(True) for k, (v, _) in
          feeds.items()}
    tfeed = {k: TArgument(value=tx[k], mask=None if m is None
                          else torch.from_numpy(m))
             for k, (_, m) in feeds.items()}
    touts, tupd = tnet.apply_with_state(tp, tfeed, train=train)
    tout = touts[name].value
    w = np.random.default_rng(seed + 1).normal(
        size=tuple(tout.shape)).astype(np.float32)
    leaves = [tp[k] for k in sorted(tp) if tp[k].requires_grad] + \
        [tx[k] for k in sorted(tx)]
    tgrads = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), leaves,
                                 allow_unused=True)

    def jloss(p, xs):
        jfeed = {k: JArgument(value=xs[k], mask=None if m is None
                              else jnp.asarray(m))
                 for k, (_, m) in feeds.items()}
        outs, upd = jnet.apply_with_state(p, jfeed, train=train)
        return jnp.sum(outs[name].value * w), (outs[name].value, upd)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jx = {k: jnp.asarray(v) for k, (v, _) in feeds.items()}
    (_, (jout, jupd)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jx)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    jgrads = [gp[k] for k in sorted(tp) if tp[k].requires_grad] + \
        [gx[k] for k in sorted(tx)]
    names = [k for k in sorted(tp) if tp[k].requires_grad] + sorted(tx)
    for n, g, want in zip(names, tgrads, jgrads):
        got = np.zeros(want.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(got, np.asarray(want), **GRAD_TOL,
                                   err_msg=n)
    assert sorted(tupd) == sorted(jupd) == sorted(updates or [])
    for k in tupd:
        np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]),
                                   **FWD_TOL, err_msg=k)
        assert not tupd[k].requires_grad
    return tout


def _img(seed, c, h, w, b=B):
    return np.random.default_rng(seed).normal(
        size=(b, h, w, c)).astype(np.float32)


def _flat(seed, c, h, w, b=B):
    return np.random.default_rng(seed).normal(
        size=(b, c * h * w)).astype(np.float32)


def _data(dsl, name, c, h, w):
    return dsl.data(name=name, size=c * h * w, channels=c, height=h,
                    width=w)


# ------------------------------------------------------------------ conv
@pytest.mark.parametrize("groups,nf,bias", [(1, 6, True), (2, 6, True),
                                            (4, 8, True), (2, 4, False)])
def test_conv_matches_jax(groups, nf, bias):
    """Stride 2 and padding 1 on a 9 x 7 image of 4 channels: groups 1, 2,
    depthwise (groups = channels) and no bias."""
    def build(dsl, mc):
        x = _data(dsl, "x", 4, 9, 7)
        return dsl.conv(input=x, num_filters=nf, filter_size=3, stride=2,
                        padding=1, groups=groups, act="linear",
                        bias_attr=bias, name="c")

    out = _check(build, {"x": (_img(0, 4, 9, 7), None)})
    assert tuple(out.shape) == (B, 5, 4, nf)


def test_conv_of_two_inputs_sums_them():
    """One conv over two inputs (one weight each, outputs summed), the
    second a flat channel-major row fed as [B, C*H*W]."""
    ext = {"filter_size": 3, "stride": 1, "padding": 1}

    def build(dsl, mc):
        a = _data(dsl, "a", 3, 6, 6)
        b = _data(dsl, "b", 2, 6, 6)
        return _layer(dsl, mc, "exconv", [a, b], [ext, ext], name="c",
                      act="linear", attrs={"num_filters": 5})

    _check(build, {"a": (_img(1, 3, 6, 6), None),
                   "b": (_flat(2, 2, 6, 6), None)})


def test_conv_derives_geometry_of_a_flat_producer():
    """A data layer with no geometry: the conv derives 8 x 8 from 192
    features over its 3 channels (isqrt), and takes the channel-major
    rows."""
    def build(dsl, mc):
        x = dsl.data(name="x", size=192)
        return dsl.conv(input=x, num_filters=4, filter_size=3, channels=3,
                        act="relu", name="c")

    out = _check(build, {"x": (_flat(3, 3, 8, 8), None)})
    assert tuple(out.shape) == (B, 6, 6, 4)


@pytest.mark.parametrize("groups", [1, 2])
def test_conv_trans_matches_jax(groups):
    """``exconvt`` with stride 2 and padding 1: the output is (in - 1) s +
    fs - 2 p, the weight the gradient-of-conv layout (fs, fs, nf / g, c)."""
    def build(dsl, mc):
        x = _data(dsl, "x", 4, 5, 6)
        return dsl.conv(input=x, num_filters=6, filter_size=3, stride=2,
                        padding=1, groups=groups, act="linear", name="ct",
                        layer_type="exconvt")

    out = _check(build, {"x": (_img(4, 4, 5, 6), None)})
    assert tuple(out.shape) == (B, 9, 11, 6)


# ------------------------------------------------------------------ pool
@pytest.mark.parametrize("ptype", ["max-projection", "avg-projection"])
@pytest.mark.parametrize("size,stride,pad", [(3, 2, 1), (3, 2, 0),
                                             (2, 2, 0), (None, 1, 0)])
def test_pool_matches_jax(ptype, size, stride, pad):
    """Max and avg on a 7 x 9 image, where the ceil-mode windows run past
    the edge (padding to what the geometry needs, the avg over the real
    pixels only), with padding, and as a global pool (``pool_size=None``)."""
    def build(dsl, mc):
        x = _data(dsl, "x", 3, 7, 9)
        return dsl.img_pool(input=x, pool_size=size, stride=stride,
                            padding=pad, pool_type=ptype, name="p")

    _check(build, {"x": (_img(5, 3, 7, 9), None)})


def test_pool_geometry_is_the_reference_ceil_mode():
    """A 112-wide stem output pooled 3/2/1 gives 57 (the reference's ceil
    mode), where torch's ceil_mode would give 56."""
    tdsl.reset()
    x = _data(tdsl, "x", 2, 112, 112)
    p = tdsl.img_pool(input=x, pool_size=3, stride=2, padding=1)
    info = tdsl._SHAPES[p.name]
    assert (info.height, info.width) == (57, 57)


@pytest.mark.parametrize("ptype", ["max-projection", "avg-projection"])
def test_pool_of_a_flat_producer_matches_jax(ptype):
    """Pooling an fc output: 49 features read as one 7 x 7 channel."""
    def build(dsl, mc):
        x = dsl.data(name="x", size=10)
        f = dsl.fc(input=x, size=49, act="tanh", name="f")
        return dsl.img_pool(input=f, pool_size=3, stride=2, pool_type=ptype,
                            name="p")

    _check(build, {"x": (np.random.default_rng(6).normal(
        size=(B, 10)).astype(np.float32), None)})


@pytest.mark.parametrize("ptype", ["max-projection", "avg-projection"])
def test_spp_matches_jax(ptype):
    """Three pyramid levels (1, 2, 4 bins a side) on a 7 x 5 image: the
    windows of the finer levels run past the edge (padded; the avg divides
    by the window's full area, as the reference's spp does)."""
    def build(dsl, mc):
        x = _data(dsl, "x", 3, 7, 5)
        return _layer(dsl, mc, "spp", [x], name="s", bias=False,
                      attrs={"pyramid_height": 3, "pool_type": ptype})

    out = _check(build, {"x": (_img(7, 3, 7, 5), None)})
    assert tuple(out.shape) == (B, 3 * 21)


# ------------------------------------------------------------ batch norm
@pytest.mark.parametrize("train,use_global", [(True, None), (False, None),
                                              (True, True), (False, False)])
def test_batch_norm_on_images_matches_jax(train, use_global):
    """Batch statistics in training, the moving ones at test, either
    forced by ``use_global_stats``; training with batch statistics records
    both EMA updates under ``_{layer}.w1`` / ``.w2``."""
    def build(dsl, mc):
        x = _data(dsl, "x", 5, 4, 3)
        return dsl.batch_norm(input=x, act="relu", name="bn",
                              use_global_stats=use_global)

    stats = train and not use_global
    _check(build, {"x": (_img(8, 5, 4, 3), None)}, train=train,
           updates=["_bn.w1", "_bn.w2"] if stats else None)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_on_flat_and_sequence_inputs_matches_jax(train):
    """A flat channel-major image row (to NHWC first) and a sequence
    [B, T, C] whose padded rows enter the statistics, as in JAX."""
    def build_flat(dsl, mc):
        return dsl.batch_norm(input=_data(dsl, "x", 3, 2, 2), name="bn")

    _check(build_flat, {"x": (_flat(9, 3, 2, 2), None)}, train=train,
           updates=["_bn.w1", "_bn.w2"] if train else None)

    def build_seq(dsl, mc):
        x = dsl.data(name="s", size=6, is_sequence=True)
        return dsl.batch_norm(input=x, name="bn")

    rng = np.random.default_rng(10)
    mask = (np.arange(5)[None, :] < np.array([5, 3, 1])[:, None]).astype(
        np.float32)
    _check(build_seq, {"s": (rng.normal(size=(B, 5, 6)).astype(np.float32),
                             mask)}, train=train,
           updates=["_bn.w1", "_bn.w2"] if train else None)


def test_batch_norm_registers_every_reference_name():
    for name in ("batch_norm", "cudnn_batch_norm", "batch_normalization",
                 "exconv", "cudnn_conv", "conv", "exconvt", "cudnn_convt",
                 "pool", "cudnn_pool", "spp", "norm", "cmrnorm-projection"):
        assert get_layer_impl(name) is not None


# --------------------------------------------------------- cross-map norm
@pytest.mark.parametrize("size", [5, 4])
def test_cmrnorm_matches_jax(size):
    """The channel window padded (size // 2, size - 1 - size // 2), the
    coefficient scale / size, on 7 channels."""
    def build(dsl, mc):
        x = _data(dsl, "x", 7, 3, 4)
        return dsl.img_cmrnorm(input=x, size=size, scale=0.5, power=0.75,
                               name="n")

    _check(build, {"x": (_img(11, 7, 3, 4), None)})


# ----------------------------------------------------------------- concat
def test_channel_concat_of_images_matches_jax():
    """Two convs and a flat channel-major data row of the same 6 x 5
    extent concatenate channel-wise (NHWC), then pool."""
    def build(dsl, mc):
        x = _data(dsl, "x", 3, 6, 5)
        a = dsl.conv(input=x, num_filters=4, filter_size=3, padding=1,
                     name="a")
        b = dsl.conv(input=x, num_filters=2, filter_size=1, name="b")
        r = _data(dsl, "r", 2, 6, 5)
        cat = dsl.concat([a, b, r], name="cat")
        return dsl.img_pool(input=cat, pool_size=2, stride=2, name="p")

    out = _check(build, {"x": (_img(12, 3, 6, 5), None),
                         "r": (_flat(13, 2, 6, 5), None)})
    assert tuple(out.shape) == (B, 3, 3, 8)


# ------------------------------------------------------ one layer alone
def test_apply_layer_gives_each_layer_what_the_graph_computes():
    """``Network.apply_layer`` from the outputs of the layers a layer
    reads gives that layer's output in ``apply_with_state`` exactly, its
    activation included, and its state updates in training."""
    tdsl.reset()
    x = _data(tdsl, "x", 3, 7, 7)
    c = tdsl.conv(input=x, num_filters=4, filter_size=3, stride=2,
                  padding=1, act="linear", name="c")
    bn = tdsl.batch_norm(input=c, act="relu", name="bn")
    tdsl.img_pool(input=bn, pool_size=2, stride=2, pool_type="max",
                  name="p")
    net = TNetwork(tdsl.current_graph(), outputs=["p"])
    params = net.init_params(torch.Generator().manual_seed(0), device="cpu")
    for train in (True, False):
        outs, upd = net.apply_with_state(
            params, {"x": TArgument(value=torch.from_numpy(_img(3, 3, 7, 7)))},
            train=train)
        got_upd = {}
        for name in ("c", "bn", "p"):
            reads = {i: outs[i] for i in net.model.layers[name].input_names()}
            out, u = net.apply_layer(name, params, reads, train=train)
            assert torch.equal(out.value, outs[name].value), name
            got_upd.update(u)
        assert sorted(got_upd) == sorted(upd) == (
            ["_bn.w1", "_bn.w2"] if train else [])
        assert all(torch.equal(got_upd[k], upd[k]) for k in upd)

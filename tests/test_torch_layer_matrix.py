"""The port twin of ``tests/test_layer_grad_matrix.py``: every layer type
the port registers, built from the JAX matrix's own ``_case_*`` functions
(the same layer configuration, names and numpy inputs), run through both
packages with the same parameters by name: the forward at rtol/atol 1e-5
and, for a differentiable output, the gradient of a fixed random weighting
of it with respect to every trained parameter and every float input at
rtol 1e-4 / atol 1e-5.

``NOT_YET_PORTED`` names the reference's types the port lacks; the closure
test holds the port's registry plus that set equal to the reference's, and
the set equal to the list ``ROADMAP.md`` keeps as still to port.

The JAX side runs its layers eagerly on the CPU (no Pallas kernel lies
under any of these types); the port's wrappers run their plain versions on
CPU tensors.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.layers  # noqa: F401
import paddle_tpu_torch.layers  # noqa: F401
from paddle_tpu.config import dsl as jdsl
from paddle_tpu.config import model_config as jmc
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.core.registry import _LAYER_REGISTRY as JREG
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.config import model_config as tmc
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.core.registry import _LAYER_REGISTRY as TREG

from test_layer_grad_matrix import FWD_CASES, GRAD_CASES

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ROADMAP = os.path.join(os.path.dirname(__file__), os.pardir, "ROADMAP.md")

# the reference's layer types the port does not register yet
NOT_YET_PORTED = set()

# ported types whose checks need more than a one-layer graph
PORT_COVERED_ELSEWHERE = {
    "data": "fed directly by every test",
    "recurrent_layer_group": "tests/test_torch_seq2seq.py",
    "beam_search_group": "tests/test_torch_generation.py",
    "group_output": "tests/test_torch_seq2seq.py",
    "get_output": "tests/test_torch_generation.py (lstm_step decoder)",
    "sub_nested_seq": "tests/test_torch_nested.py (nested selection)",
    "multibox_loss": "tests/test_torch_detection.py (detection stack)",
    "detection_output": "tests/test_torch_detection.py (detection stack)",
    "moe": "tests/test_torch_moe.py (routing boundaries break numeric "
           "differentiation)",
}

PORT_GRAD = sorted(t for t in GRAD_CASES if t not in NOT_YET_PORTED)
PORT_FWD = sorted(t for t in FWD_CASES if t not in NOT_YET_PORTED)
# forward-only rows whose output is random (sampling_id: its own test) or
# printed (print: its own test)
EXACT_FWD = [t for t in PORT_FWD if t not in ("sampling_id", "print")]


def test_registry_closure_against_reference_and_roadmap():
    """The port's registry and NOT_YET_PORTED make the reference's; the
    set is what ROADMAP.md lists as still to port; every canonical port
    type has a row here or a named test elsewhere."""
    assert set(TREG) | NOT_YET_PORTED == set(JREG)
    assert not set(TREG) & NOT_YET_PORTED
    line = next(ln for ln in open(ROADMAP).read().splitlines()
                if ln.startswith("Layer types still to port"))
    assert set(re.findall(r"`([^`]+)`", line)) == NOT_YET_PORTED
    canonical = {impl.type_name for impl in TREG.values()}
    covered = set(PORT_GRAD) | set(PORT_FWD) | set(PORT_COVERED_ELSEWHERE)
    assert canonical == covered


def _to_port_layer(ld):
    """The JAX LayerDef as the port's (param attrs and extras kept)."""
    ins = []
    for i in ld.inputs:
        pa = i.param_attr
        ins.append(tmc.Input(i.layer_name, extra=dict(i.extra),
                             param_attr=None if pa is None else tmc.ParamAttr(
                                 **{k: getattr(pa, k) for k in (
                                     "name", "init", "initial_mean",
                                     "initial_std", "is_static",
                                     "learning_rate")})))
    return tmc.LayerDef(name=ld.name, type=ld.type, inputs=ins, size=ld.size,
                        act=ld.act, bias=ld.bias, attrs=dict(ld.attrs))


def build_pair(case):
    """(JAX network, port network, layer name, numpy feed, params):
    ``case()`` is a matrix case function; params random by name (a moving
    variance positive)."""
    data_defs, ld, feed = case()
    jdsl.reset()
    tdsl.reset()
    for name, size, kw in data_defs:
        jdsl.data(name=name, size=size, **kw)
        tdsl.data(name=name, size=size, **kw)
    jdsl.current_graph().add(ld)
    tdsl.current_graph().add(_to_port_layer(ld))
    jnet = JNetwork(jdsl.current_graph(), outputs=[ld.name])
    tnet = TNetwork(tdsl.current_graph(), outputs=[ld.name])
    assert {k: tuple(s.shape) for k, s in jnet.param_specs.items()} == \
        {k: tuple(s.shape) for k, s in tnet.param_specs.items()}
    assert {k: s.is_static for k, s in jnet.param_specs.items()} == \
        {k: s.is_static for k, s in tnet.param_specs.items()}
    rng = np.random.default_rng(11)
    params = {}
    for k, s in sorted(jnet.param_specs.items()):
        p = (rng.normal(size=s.shape) * 0.5).astype(np.float32)
        params[k] = np.abs(p) + 0.5 if k.endswith(".w2") else p
    npfeed = {k: (np.array(a.value), None if a.mask is None
                  else np.array(a.mask)) for k, a in feed.items()}
    return jnet, tnet, ld.name, npfeed, params


def run_pair(jnet, tnet, name, npfeed, params, *, grads=True, seed=None):
    """The output of layer ``name`` in both packages, and with ``grads``
    the gradients (params, then float inputs, by name) of sum(out * w)."""
    trained = sorted(k for k in params if not tnet.param_specs[k].is_static)
    floats = sorted(k for k, (v, _) in npfeed.items()
                    if np.issubdtype(v.dtype, np.floating))
    tp = {k: torch.from_numpy(v).requires_grad_(grads and k in trained)
          for k, v in params.items()}
    tx = {k: torch.from_numpy(v).requires_grad_(grads and k in floats)
          for k, (v, _) in npfeed.items()}
    tfeed = {k: TArgument(value=tx[k], mask=None if m is None
                          else torch.from_numpy(m))
             for k, (_, m) in npfeed.items()}
    tout = tnet.apply(tp, tfeed, seed=seed)[name].value
    jfeed = {k: (jnp.asarray(v), None if m is None else jnp.asarray(m))
             for k, (v, m) in npfeed.items()}
    def jout(p, xs):
        f = {k: JArgument(value=xs.get(k, jfeed[k][0]), mask=jfeed[k][1])
             for k in jfeed}
        return jnet.apply(p, f, train=False,
                          rng=jax.random.PRNGKey(0))[name].value

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    if not grads:
        return tout, np.asarray(jout(jp, {}))
    w = np.random.default_rng(5).normal(size=tuple(tout.shape)).astype(
        np.float32)
    leaves = [tp[k] for k in trained] + [tx[k] for k in floats]
    tg = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), leaves,
                             allow_unused=True)
    (gp, gx) = jax.grad(
        lambda p, xs: jnp.sum(jout(p, xs) * w), argnums=(0, 1))(
            jp, {k: jfeed[k][0] for k in floats})
    jg = [gp[k] for k in trained] + [gx[k] for k in floats]
    names = trained + floats
    out = {}
    for n, g, want in zip(names, tg, jg):
        out[n] = (np.zeros(want.shape, np.float32) if g is None
                  else g.numpy(), np.asarray(want))
    return tout, np.asarray(jout(jp, {})), out


@pytest.mark.parametrize("type_name", PORT_GRAD)
def test_layer_matches_jax(type_name):
    jnet, tnet, name, feed, params = build_pair(GRAD_CASES[type_name])
    tout, jout, grads = run_pair(jnet, tnet, name, feed, params)
    assert tuple(tout.shape) == jout.shape
    np.testing.assert_allclose(tout.detach().numpy(), jout, **FWD_TOL)
    assert grads, f"{type_name}: nothing to differentiate"
    for n, (got, want) in grads.items():
        np.testing.assert_allclose(got, want, **GRAD_TOL,
                                   err_msg=f"{type_name} d/d {n}")


@pytest.mark.parametrize("type_name", EXACT_FWD)
def test_forward_only_layer_matches_jax(type_name):
    jnet, tnet, name, feed, params = build_pair(FWD_CASES[type_name])
    tout, jout = run_pair(jnet, tnet, name, feed, params, grads=False)
    assert tuple(tout.shape) == jout.shape
    np.testing.assert_allclose(tout.numpy().astype(np.float64),
                               jout.astype(np.float64), **FWD_TOL)


def test_print_passes_through_and_names_the_layer(capsys):
    jnet, tnet, name, feed, params = build_pair(FWD_CASES["print"])
    tout, jout = run_pair(jnet, tnet, name, feed, params, grads=False)
    np.testing.assert_array_equal(tout.numpy(), feed["x"][0])
    np.testing.assert_array_equal(jout, feed["x"][0])
    assert f"{name}: " in capsys.readouterr().out


def _sampling_net(dsl):
    dsl.reset()
    x = dsl.data(name="x", size=4)
    return dsl.sampling_id_layer(input=x, name="ids")


def _sample(p, seed):
    net = TNetwork(tdsl.current_graph(), outputs=["ids"])
    return net.apply({}, {"x": TArgument(value=torch.from_numpy(p))},
                     seed=seed)["ids"].value.numpy()


def test_sampling_id_one_hot_rows_draw_their_id():
    """On one-hot rows the draw is determined: both packages give the
    row's id."""
    ids = np.array([3, 0, 2, 1, 3])
    p = np.eye(4, dtype=np.float32)[ids]
    _sampling_net(jdsl)
    jnet = JNetwork(jdsl.current_graph(), outputs=["ids"])
    jids = np.asarray(jnet.apply({}, {"x": JArgument(value=jnp.asarray(p))},
                                 rng=jax.random.PRNGKey(3))["ids"].value)
    _sampling_net(tdsl)
    for seed in (0, 1, 2):
        np.testing.assert_array_equal(_sample(p, seed), ids)
    np.testing.assert_array_equal(jids, ids)


def test_sampling_id_frequencies_and_repeatability():
    """Over 20,000 draws of one distribution each id's frequency lies
    within 0.015 of its probability (more than 5 standard deviations at
    p = 0.5); the same seed repeats the draw bit for bit, another seed
    does not."""
    probs = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    p = np.tile(probs, (20000, 1))
    _sampling_net(tdsl)
    a = _sample(p, 7)
    freq = np.bincount(a, minlength=4) / a.size
    np.testing.assert_allclose(freq, probs, atol=0.015)
    np.testing.assert_array_equal(_sample(p, 7), a)
    assert not np.array_equal(_sample(p, 8), a)


@pytest.mark.parametrize("ties", [False, True])
def test_kmax_seq_score_order_with_ties(ties):
    """Best first, the lower index first among equal scores (lax.top_k's
    order), padded steps never chosen ahead of real ones."""
    rng = np.random.default_rng(4)
    s = rng.normal(size=(4, 9, 1)).astype(np.float32)
    if ties:
        s = np.round(s * 2) / 2  # few distinct values
        s[0, :, 0] = 1.0          # all equal
    mask = np.ones((4, 9), np.float32)
    mask[1, 6:] = 0
    mask[2, 3:] = 0

    def build(dsl, mc):
        dsl.reset()
        x = dsl.data(name="x", size=1, is_sequence=True)
        return dsl._add(mc.LayerDef(name="k", type="kmax_seq_score",
                                    inputs=[mc.Input(x.name)], bias=False,
                                    attrs={"beam_size": 3}))
    build(jdsl, jmc)
    jnet = JNetwork(jdsl.current_graph(), outputs=["k"])
    build(tdsl, tmc)
    tnet = TNetwork(tdsl.current_graph(), outputs=["k"])
    out_t, out_j = run_pair(jnet, tnet, "k", {"x": (s, mask)}, {},
                            grads=False)
    np.testing.assert_array_equal(out_t.numpy(), out_j)
    if ties:
        np.testing.assert_array_equal(out_t.numpy()[0], [0, 1, 2])


@pytest.mark.parametrize("ties", [False, True])
def test_lambda_cost_with_tied_relevance(ties):
    rng = np.random.default_rng(6)
    score = rng.normal(size=(3, 6, 1)).astype(np.float32)
    rel = rng.integers(0, 3 if ties else 100, size=(3, 6, 1)).astype(
        np.float32)
    mask = np.ones((3, 6), np.float32)
    mask[1, 4:] = 0

    def build(dsl, mc):
        dsl.reset()
        s = dsl.data(name="s", size=1, is_sequence=True)
        y = dsl.data(name="y", size=1, is_sequence=True)
        return dsl._add(mc.LayerDef(
            name="c", type="lambda_cost", inputs=[mc.Input(s.name),
                                                  mc.Input(y.name)],
            bias=False, attrs={"NDCG_num": 3}))
    build(jdsl, jmc)
    jnet = JNetwork(jdsl.current_graph(), outputs=["c"])
    build(tdsl, tmc)
    tnet = TNetwork(tdsl.current_graph(), outputs=["c"])
    tout, jout, grads = run_pair(jnet, tnet, "c", {"s": (score, mask),
                                                   "y": (rel, mask)}, {})
    np.testing.assert_allclose(tout.detach().numpy(), jout, **FWD_TOL)
    for n, (got, want) in grads.items():
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=n)


@pytest.mark.parametrize("shape,out", [((4, 4), (8, 8)), ((4, 6), (7, 9)),
                                       ((8, 8), (3, 3)), ((9, 7), (4, 5)),
                                       ((6, 6), (6, 3))])
def test_bilinear_interp_up_and_down(shape, out):
    """``jax.image.resize``'s bilinear (half-pixel centres, antialias when
    shrinking) against ``F.interpolate(antialias=True)``, growing and
    shrinking, forward and gradient."""
    h, w = shape
    rng = np.random.default_rng(h * 10 + w)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)

    def build(dsl):
        dsl.reset()
        d = dsl.data(name="x", size=3 * h * w, channels=3, height=h, width=w)
        return dsl.bilinear_interp_layer(input=d, out_size_x=out[1],
                                         out_size_y=out[0], name="y")
    build(jdsl)
    jnet = JNetwork(jdsl.current_graph(), outputs=["y"])
    build(tdsl)
    tnet = TNetwork(tdsl.current_graph(), outputs=["y"])
    tout, jout, grads = run_pair(jnet, tnet, "y", {"x": (x, None)}, {})
    assert jout.shape == (2, out[0], out[1], 3)
    np.testing.assert_allclose(tout.detach().numpy(), jout, **FWD_TOL)
    for n, (got, want) in grads.items():
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=n)


def test_feed_slot_agents_are_fed_by_name():
    """An input-less agent is a slot the executor feeds by name, with the
    JAX executor's KeyError when the feed lacks it."""
    tdsl.reset()
    g = tdsl.current_graph()
    g.add(tmc.LayerDef(name="slot", type="scatter_agent", size=4,
                       bias=False))
    g.add(tmc.LayerDef(name="y", type="slope_intercept",
                       inputs=[tmc.Input("slot")], bias=False,
                       attrs={"slope": 2.0, "intercept": 1.0}))
    net = TNetwork(g, outputs=["y"])
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    out = net.apply({}, {"slot": TArgument(value=x)})["y"].value
    torch.testing.assert_close(out, 2 * x + 1)
    with pytest.raises(KeyError, match="missing feed for scatter_agent "
                                       "feed slot 'slot'"):
        net.apply({}, {})


def test_every_reference_activation_matches_jax():
    """The 16 activations of the reference, each on values inside its
    domain, at 1e-5 against JAX."""
    from paddle_tpu.layers import activations as ja
    from paddle_tpu_torch.layers import activations as ta
    assert ta.activation_names() == ja.activation_names()
    assert len(ta.activation_names()) == 15  # and "" for linear
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(4, 6)) * 3).astype(np.float32)
    x[0, :3] = [0.0, 24.0, 30.0]  # brelu's kinks and clip
    pos = np.abs(x) + 0.1
    mask = np.ones((4, 6), np.float32)
    mask[2, 4:] = 0
    for name in ta.activation_names():
        v = pos if name in ("sqrt", "log", "reciprocal") else x
        m = mask if name == "sequence_softmax" else None
        got = ta.apply_activation(name, torch.from_numpy(v),
                                  None if m is None else torch.from_numpy(m))
        want = ja.apply_activation(name, jnp.asarray(v),
                                   None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL,
                                   err_msg=name)


# the canonical types the port registered before the layer plane: the
# card checks them in chip_smoke.py's earlier phases
EARLIER = {"addto", "average", "batch_norm", "beam_search_group", "concat",
           "crf", "crf_decoding", "ctc", "data", "embedding", "exconv",
           "exconvt", "expand", "fc", "gated_recurrent", "get_output",
           "group_output", "gru_step", "lstm_step", "lstmemory", "max",
           "multi-class-cross-entropy", "multi_head_attention", "norm",
           "pool", "recurrent_layer_group", "scaling", "seqlastins", "spp"}
# the last types without a matrix row: chip_smoke.py's phase 15 checks
# them on the card at full width
LAST_TYPES = {"sub_nested_seq", "multibox_loss", "detection_output", "moe"}


def test_chip_smoke_layer_cases_are_the_matrix_cases():
    """``chip_smoke.layer_cases`` (phase 14 (c), which imports no JAX)
    holds every type this slice ports at the JAX matrix's cases: the same
    data layers, layer configuration and inputs."""
    import chip_smoke
    cases = chip_smoke.layer_cases()
    canonical = {impl.type_name for impl in TREG.values()}
    assert set(cases) == canonical - EARLIER - LAST_TYPES
    for type_, (data, kw, feed) in cases.items():
        jdata, ld, jfeed = (GRAD_CASES.get(type_) or FWD_CASES[type_])()
        assert data == jdata, type_
        port = _to_port_layer(ld)
        got = chip_smoke.layer_case_net((data, kw, feed))[0].model.layers[
            kw["name"]]
        assert (got.name, got.type, got.size, got.act, got.bias,
                got.attrs) == (port.name, port.type, port.size, port.act,
                               port.bias, port.attrs), type_
        assert [(i.layer_name, i.extra, i.param_attr) for i in got.inputs] \
            == [(i.layer_name, i.extra, i.param_attr)
                for i in port.inputs], type_
        assert sorted(feed) == sorted(jfeed), type_
        for k, (v, m) in feed.items():
            want = jfeed[k]
            assert v.dtype == np.asarray(want.value).dtype, (type_, k)
            np.testing.assert_allclose(v, np.asarray(want.value), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{type_} {k}")
            assert (m is None) == (want.mask is None), (type_, k)
            if m is not None:
                np.testing.assert_array_equal(m, np.asarray(want.mask))

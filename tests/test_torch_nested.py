"""Two-level (nested) sequences in the port against the JAX package, on the
CPU: the feeder's nested and sparse slots, the TO_SEQUENCE sequence
layers, ``expand`` onto nested targets, ``subseq``, ``sub_nested_seq``,
nested recurrent groups (nested == flat in both packages, the mask, the
gradients, mixed-level alignment and its ``ValueError``, the nested
out-link and ``group_output``, ``auto`` in-links, the carried state under
``prev_batch_state``) and the predictor's refusal of nested slots.

Each check builds the same graph in both packages, gives both the same
parameters by name and the same numpy inputs from a seed. Tolerances:
values rtol 1e-5 / atol 1e-5, gradients rtol 1e-4 / atol 1e-5.
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
from paddle_tpu.data import types as JT
from paddle_tpu.data.feeder import DataFeeder as JFeeder
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.config import model_config as tmc
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.data import types as TT
from paddle_tpu_torch.data.feeder import DataFeeder as TFeeder

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, S, TS, D = 2, 3, 4, 5


def _nets(build, outputs=None):
    """(JAX network, port network, output names): ``build(dsl, mc)``
    returns the output handle(s)."""
    jdsl.reset()
    outs = build(jdsl, jmc)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    names = outputs or [o.name for o in outs]
    jnet = JNetwork(jdsl.current_graph(), outputs=names)
    tdsl.reset()
    build(tdsl, tmc)
    tnet = TNetwork(tdsl.current_graph(), outputs=names)
    assert {k: tuple(s.shape) for k, s in jnet.param_specs.items()} == \
        {k: tuple(s.shape) for k, s in tnet.param_specs.items()}
    return jnet, tnet, names


def _params(jnet, seed=1, scale=0.5):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s.shape) * scale).astype(np.float32)
            for k, s in sorted(jnet.param_specs.items())}


def _args(npfeed, lib):
    """{name: (value, mask[, sub_starts_mask])} as one package's
    Arguments."""
    if lib == "jax":
        return {k: JArgument(value=jnp.asarray(v[0]),
                             mask=None if v[1] is None else jnp.asarray(v[1]),
                             sub_starts_mask=None if len(v) < 3
                             else jnp.asarray(v[2]))
                for k, v in npfeed.items()}
    return {k: TArgument(value=torch.from_numpy(np.array(v[0])),
                         mask=None if v[1] is None
                         else torch.from_numpy(np.array(v[1])),
                         sub_starts_mask=None if len(v) < 3
                         else torch.from_numpy(np.array(v[2])))
            for k, v in npfeed.items()}


def _run(jnet, tnet, name, params, npfeed, grads=True, seed=3):
    """Layer ``name``'s output in both packages and, with ``grads``, the
    gradients of sum(out * w) with respect to every parameter and float
    input, as {leaf: (port, jax)}."""
    floats = sorted(k for k, v in npfeed.items()
                    if np.issubdtype(np.asarray(v[0]).dtype, np.floating))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(grads)
          for k, v in params.items()}
    tfeed = _args(npfeed, "torch")
    for k in floats:
        tfeed[k].value.requires_grad_(grads)
    tout = tnet.apply(tp, tfeed)[name]
    jfeed = _args(npfeed, "jax")

    def jout(p, xs):
        f = {k: a.replace(value=xs.get(k, a.value)) for k, a in jfeed.items()}
        return jnet.apply(p, f)[name].value

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jv = np.asarray(jout(jp, {}))
    if not grads:
        return tout, jv, {}
    w = np.random.default_rng(seed).normal(size=jv.shape).astype(np.float32)
    leaves = [tp[k] for k in sorted(tp)] + [tfeed[k].value for k in floats]
    tg = torch.autograd.grad((tout.value * torch.from_numpy(w)).sum(),
                             leaves, allow_unused=True)
    gp, gx = jax.grad(lambda p, xs: jnp.sum(jout(p, xs) * w), argnums=(0, 1))(
        jp, {k: jfeed[k].value for k in floats})
    want = [gp[k] for k in sorted(tp)] + [gx[k] for k in floats]
    out = {}
    for n, g, j in zip(sorted(tp) + floats, tg, want):
        out[n] = (np.zeros(np.shape(j), np.float32) if g is None
                  else g.numpy(), np.asarray(j))
    return tout, jv, out


def _check(tout, jv, grads):
    np.testing.assert_allclose(tout.value.detach().numpy(), jv, **FWD_TOL)
    for n, (got, want) in grads.items():
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=n)


def _nested_x(seed=0, ragged=True):
    rng = np.random.RandomState(seed)
    v = rng.randn(B, S, TS, D).astype(np.float32)
    m = np.ones((B, S, TS), np.float32)
    if ragged:
        m[0, 2] = 0.0          # row 0 has two sub-sequences
        m[1, 1, 2:] = 0.0      # a short sub-sequence
        m[0, 0, 3:] = 0.0
    return v * m[..., None], m


# ---------------------------------------------------- nested == flat
def _inner_step(dsl):
    def inner_step(xt):
        m = dsl.memory(name="h", size=D)
        return dsl.fc(input=[xt, m], size=D, act="tanh", name="h",
                      bias_attr=False)
    return inner_step


def _flat(dsl, mc):
    x = dsl.data(name="x", size=D, is_sequence=True)
    return dsl.recurrent_group(_inner_step(dsl), x, name="flat_rnn")


def _nested(dsl, mc):
    """``sequence_nest_rnn.conf``'s shape: an outer group over
    sub-sequences whose inner group boots from the outer memory, the
    outer memory the inner group's last output."""
    x = dsl.data(name="x", size=D, is_sequence=True)

    def outer_step(sub):
        outer_m = dsl.memory(name="outer_h", size=D)

        def inner_step(xt):
            m = dsl.memory(name="h", size=D, boot_layer=outer_m)
            return dsl.fc(input=[xt, m], size=D, act="tanh", name="h",
                          bias_attr=False)

        inner = dsl.recurrent_group(inner_step, sub, name="inner_rnn")
        return dsl.last_seq(inner, name="outer_h")

    return dsl.recurrent_group(outer_step, dsl.SubsequenceInput(x),
                               name="outer_rnn")


def _flatten_live(v, m):
    """The nested batch's live words concatenated per row, and the flat
    position of each sub-sequence's last word."""
    T = int(m.sum(axis=(1, 2)).max())
    flat = np.zeros((B, T, D), np.float32)
    fm = np.zeros((B, T), np.float32)
    ends = np.full((B, S), -1)
    for b in range(B):
        t = 0
        for s in range(S):
            n = int(m[b, s].sum())
            flat[b, t:t + n] = v[b, s, :n]
            fm[b, t:t + n] = 1.0
            t += n
            if n:
                ends[b, s] = t - 1
    return flat, fm, ends


def test_nested_equals_flat_in_both_packages():
    """The nested group's per-sub-sequence outputs are the flat group's
    hidden states at each sub-sequence's last word (the
    test_RecurrentGradientMachine property), in both packages, and the
    port's match JAX's."""
    v, m = _nested_x()
    jn, tn, (name,) = _nets(_nested)
    jf, tf, (fname,) = _nets(_flat)
    assert set(jn.param_specs) == set(jf.param_specs) == {"_h.w0", "_h.w1"}
    params = _params(jn)
    tout, jv, _ = _run(jn, tn, name, params, {"x": (v, m)}, grads=False)
    np.testing.assert_allclose(tout.value.numpy(), jv, **FWD_TOL)
    flat, fm, ends = _flatten_live(v, m)
    tflat, jflat, _ = _run(jf, tf, fname, params, {"x": (flat, fm)},
                           grads=False)
    for b in range(B):
        for s in range(S):
            if ends[b, s] < 0:
                assert np.all(jv[b, s] == 0) and np.all(
                    tout.value.numpy()[b, s] == 0)
                continue
            for got, f in ((tout.value.numpy(), tflat.value.numpy()),
                           (jv, jflat)):
                np.testing.assert_allclose(got[b, s], f[b, ends[b, s]],
                                           rtol=1e-5, atol=1e-6)


def test_nested_group_shapes_mask_and_grads():
    """[B, S, D] out with the live sub-sequences as its mask, zeros on a
    dead outer step; every gradient (the shared step weight hoisted
    through both groups, the input) as JAX's."""
    v, m = _nested_x(seed=1)
    jn, tn, (name,) = _nets(_nested)
    tout, jv, grads = _run(jn, tn, name, _params(jn, 2), {"x": (v, m)})
    assert tuple(tout.value.shape) == (B, S, D)
    np.testing.assert_array_equal(tout.mask.numpy(), [[1, 1, 0], [1, 1, 1]])
    assert np.all(tout.value.detach().numpy()[0, 2] == 0)
    assert set(grads) == {"_h.w0", "_h.w1", "x"}
    _check(tout, jv, grads)


# --------------------------------------------- the nested out-link
def _nested_outlink(dsl, mc):
    """The step returns its inner group's whole output (a sequence) and a
    per-sub-sequence extra: the group flattens the first to [B, S*Tq, D],
    group_output re-attaches the 2-level view; TO_SEQUENCE layers read
    it."""
    x = dsl.data(name="x", size=D, is_sequence=True)

    def outer_step(sub):
        outer_m = dsl.memory(name="last", size=D)

        def inner_step(xt):
            m = dsl.memory(name="h", size=D, boot_layer=outer_m)
            return dsl.fc(input=[xt, m], size=D, act="tanh", name="h",
                          bias_attr=False)

        inner = dsl.recurrent_group(inner_step, sub, name="inner")
        last = dsl.last_seq(inner, name="last")
        seq2 = dsl.fc(input=inner, size=D, act="linear", name="seq2",
                      bias_attr=False)
        return inner, last, seq2

    g, last, seq2 = dsl.recurrent_group(
        outer_step, dsl.SubsequenceInput(x), name="outer")
    outs = [g, last, seq2]
    for i, (src, t, kw) in enumerate([
            (g, "max", {}), (g, "average", {"average_strategy": "sum"}),
            (seq2, "seqlastins", {}),
            (seq2, "seqlastins", {"select_first": True}),
            (g, "average", {"average_strategy": "squarerootn"})]):
        outs.append(dsl._add(mc.LayerDef(
            name=f"agg{i}", type=t, inputs=[mc.Input(src.name)], bias=False,
            attrs=dict(kw, trans_type="seq"))))
    outs.append(dsl.expand(last, g, name="exp_sub"))
    outs.append(dsl.last_seq(g, name="flat_last"))
    return outs


@pytest.mark.parametrize("out", ["outer", "outer@out_last", "outer@out_seq2",
                                 "agg0", "agg1", "agg2", "agg3", "agg4",
                                 "exp_sub", "flat_last"])
def test_nested_outlink_group_output_and_to_sequence(out):
    v, m = _nested_x(seed=2)
    jn, tn, names = _nets(_nested_outlink)
    params = _params(jn, 3)
    jn, tn, _ = _nets(_nested_outlink, outputs=[out])
    tout, jv, grads = _run(jn, tn, out, params, {"x": (v, m)})
    _check(tout, jv, grads)
    jmask = jn.apply({k: jnp.asarray(p) for k, p in params.items()},
                     _args({"x": (v, m)}, "jax"))[out].mask
    if jmask is None:
        assert tout.mask is None
    else:
        np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jmask))
    if out == "outer":
        assert tuple(tout.value.shape) == (B, S * TS, D)
        assert tuple(tout.state["nested"].value.shape) == (B, S, TS, D)
        assert tout.state["nested_tq"] == TS


# ------------------------------------- TO_SEQUENCE on a nested input
@pytest.mark.parametrize("type_,attrs", [
    ("max", {}), ("average", {}), ("average", {"average_strategy": "sum"}),
    ("average", {"average_strategy": "squarerootn"}),
    ("seqlastins", {}), ("seqlastins", {"select_first": True})])
def test_to_sequence_layers_on_a_nested_input(type_, attrs):
    """Each sub-sequence reduced: [B, S, D] with the live sub-sequences as
    the mask, a dead one zero."""
    v, m = _nested_x(seed=4)

    def build(dsl, mc):
        x = dsl.data(name="x", size=D, is_sequence=True)
        return dsl._add(mc.LayerDef(name="y", type=type_,
                                    inputs=[mc.Input(x.name)], bias=False,
                                    attrs=dict(attrs, trans_type="seq")))
    jn, tn, (name,) = _nets(build)
    tout, jv, grads = _run(jn, tn, name, {}, {"x": (v, m)})
    _check(tout, jv, grads)
    np.testing.assert_array_equal(tout.mask.numpy(), (m.sum(-1) > 0))


# ---------------------------------------------- expand, nested target
def _expand_net(src_shape):
    def build(dsl, mc):
        x = dsl.data(name="x", size=D, is_sequence=True)
        s = dsl.data(name="s", size=D, is_sequence=len(src_shape) == 3)
        return dsl.expand(s, x, name="e")
    return build


@pytest.mark.parametrize("src", ["per_seq", "per_sub", "per_sub_longer_dead",
                                 "per_sub_shorter_dead"])
def test_expand_onto_a_nested_target(src):
    """A per-sequence vector over every word, a per-sub-sequence one over
    its sub-sequence's words; a source longer or shorter than S aligns
    where the extra entries are dead."""
    v, m = _nested_x(seed=5)
    rng = np.random.default_rng(6)
    if src == "per_seq":
        feed = {"s": (rng.normal(size=(B, D)).astype(np.float32), None)}
    else:
        n = {"per_sub": S, "per_sub_longer_dead": S + 2,
             "per_sub_shorter_dead": S - 1}[src]
        sv = rng.normal(size=(B, n, D)).astype(np.float32)
        sm = np.ones((B, n), np.float32)
        sm[:, S:] = 0.0
        if src == "per_sub_shorter_dead":
            m = m.copy()
            m[:, S - 1] = 0.0   # the outer steps past it are dead
            v = v * m[..., None]
        feed = {"s": (sv, sm)}
    feed["x"] = (v, m)
    jn, tn, (name,) = _nets(_expand_net(feed["s"][0].shape))
    tout, jv, grads = _run(jn, tn, name, {}, feed)
    _check(tout, jv, grads)


@pytest.mark.parametrize("case", ["longer_live", "shorter_live"])
def test_expand_misaligned_live_source_raises(case):
    """A trimmed or made-up entry that is live is real data: the port
    raises the JAX guard's ValueError."""
    v, m = _nested_x(seed=7, ragged=False)
    n = S + 1 if case == "longer_live" else S - 1
    sv = np.ones((B, n, D), np.float32)
    sm = np.ones((B, n), np.float32)
    tdsl.reset()
    _expand_net(sv.shape)(tdsl, tmc)
    net = TNetwork(tdsl.current_graph(), outputs=["e"])
    with pytest.raises(ValueError, match="live \\(unmasked\\) positions"):
        net.apply({}, _args({"x": (v, m), "s": (sv, sm)}, "torch"))


# ------------------------------------------------------------ subseq
@pytest.mark.parametrize("bias", [False, True])
def test_subseq_spans_with_clamp_and_bias(bias):
    """Offsets and sizes per row; a span past the source's true length is
    masked; the optional bias on kept positions only."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 6, D)).astype(np.float32)
    xm = np.ones((3, 6), np.float32)
    xm[1, 4:] = 0.0
    off = np.array([0, 2, 3], np.int32)
    n = np.array([3, 4, 6], np.int32)

    def build(dsl, mc):
        for name, size, kw in (("x", D, {"is_sequence": True}),
                               ("off", 1, {}), ("n", 1, {})):
            dsl.data(name=name, size=size, **kw)
        return dsl._add(mc.LayerDef(
            name="y", type="subseq", inputs=[mc.Input("x"), mc.Input("off"),
                                             mc.Input("n")], bias=bias))
    jn, tn, (name,) = _nets(build)
    params = _params(jn, 9)
    tout, jv, grads = _run(jn, tn, name, params, {
        "x": (x * xm[..., None], xm), "off": (off, None), "n": (n, None)})
    _check(tout, jv, grads)
    assert tout.mask.numpy()[1].sum() == 2   # clamped to the source


# ------------------------------------------------ mixed levels in a group
def _mixed_levels(dsl, mc):
    x = dsl.data(name="x", size=D, is_sequence=True)
    f = dsl.data(name="f", size=D, is_sequence=True)

    def step(sub, ft):
        outer_m = dsl.memory(name="o", size=D)
        last = dsl.last_seq(sub, name="sub_last")
        return dsl.fc(input=[last, ft, outer_m], size=D, act="tanh",
                      name="o")

    return dsl.recurrent_group(step, [dsl.SubsequenceInput(x), f],
                               name="mixed")


@pytest.mark.parametrize("flat_len", [S, S + 3, S - 1])
def test_mixed_level_group_aligns_flat_in_links(flat_len):
    """A flat per-sub-sequence in-link padded longer (dead tail) or shorter
    (the outer steps past it dead) aligns to S as in JAX."""
    v, m = _nested_x(seed=10)
    if flat_len < S:
        m = m.copy()
        m[:, S - 1] = 0.0
        v = v * m[..., None]
    rng = np.random.default_rng(11)
    fv = rng.normal(size=(B, flat_len, D)).astype(np.float32)
    fm = np.ones((B, flat_len), np.float32)
    fm[:, S:] = 0.0
    fv *= fm[..., None]
    jn, tn, (name,) = _nets(_mixed_levels)
    tout, jv, grads = _run(jn, tn, name, _params(jn, 12),
                           {"x": (v, m), "f": (fv, fm)})
    _check(tout, jv, grads)


@pytest.mark.parametrize("case", ["longer_live", "shorter_live",
                                  "longer_maskless"])
def test_mixed_level_misalignment_raises(case):
    """A live trimmed or made-up step is a ValueError with JAX's text
    (JAX raises it from a debug callback; the port from a host check); a
    maskless flat in-link longer than S fails before any step."""
    v, m = _nested_x(seed=13, ragged=False)
    n = S + 2 if case.startswith("longer") else S - 1
    fv = np.ones((B, n, D), np.float32)
    fm = None if case == "longer_maskless" else np.ones((B, n), np.float32)
    tdsl.reset()
    _mixed_levels(tdsl, tmc)
    tnet = TNetwork(tdsl.current_graph(), outputs=["mixed"])
    params = {k: torch.zeros(s.shape) for k, s in tnet.param_specs.items()}
    match = ("cannot align" if case == "longer_maskless"
             else "live \\(unmasked\\) positions")
    with pytest.raises(ValueError, match=match):
        tnet.apply(params, _args({"x": (v, m), "f": (fv, fm)}, "torch"))
    jdsl.reset()
    _mixed_levels(jdsl, jmc)
    jnet = JNetwork(jdsl.current_graph(), outputs=["mixed"])
    jparams = {k: jnp.zeros(s.shape) for k, s in jnet.param_specs.items()}
    with pytest.raises(Exception, match=match):
        jax.block_until_ready(jnet.apply(
            jparams, _args({"x": (v, m), "f": (fv, fm)}, "jax"))[
                "mixed"].value)


def test_auto_in_link_resolves_to_nested():
    """An in-link whose level the graph cannot know (a non-sequence data
    layer) is nested when fed a 3-D mask: the group walks its
    sub-sequences, as JAX's does."""
    v, m = _nested_x(seed=14)

    def build(dsl, mc):
        x = dsl.data(name="x", size=D)

        def step(sub):
            mem = dsl.memory(name="o", size=D)
            return dsl.fc(input=[dsl.last_seq(sub, name="sl"), mem], size=D,
                          act="tanh", name="o")
        return dsl.recurrent_group(step, x, name="g")
    jn, tn, (name,) = _nets(build)
    assert tn.model.layers["g"].attrs["ins"][0]["kind"] == "auto"
    tout, jv, grads = _run(jn, tn, name, _params(jn, 15), {"x": (v, m)})
    assert tuple(tout.value.shape) == (B, S, D)
    _check(tout, jv, grads)


# ----------------------------------------------------- sub_nested_seq
def test_sub_nested_seq_selects_like_jax():
    """Twin of ``tests/test_misc_layers.py``'s selection: the chosen
    sub-sequence compacted to the front, value and gradient as JAX's."""
    T = 6
    xv = np.arange(B * T * 2, dtype=np.float32).reshape(B, T, 2) / 10.0
    mask = np.ones((B, T), np.float32)
    mask[1, 4:] = 0
    starts = np.zeros((B, T), np.float32)
    starts[0, 0] = starts[0, 3] = 1
    starts[1, 0] = starts[1, 2] = 1
    selv = np.array([[1], [0]], np.float32)

    def build(dsl, mc):
        x = dsl.data("x", size=2, is_sequence=True)
        sel = dsl.data("sel", size=1)
        return dsl.sub_nested_seq_layer(x, sel, name="s")
    jn, tn, (name,) = _nets(build)
    feed = {"x": (xv, mask, starts), "sel": (selv, None)}
    tout, jv, grads = _run(jn, tn, name, {}, feed)
    _check(tout, jv, {k: g for k, g in grads.items() if k == "x"})
    np.testing.assert_allclose(jv[0, :3], xv[0, 3:6])
    np.testing.assert_array_equal(tout.mask.numpy().sum(1), [3, 2])


def test_sub_nested_seq_refuses_the_feeders_nested_layout():
    """The reference's behaviour: without ``sub_starts_mask`` (the
    feeder's [B, S, T, D] layout has none) both packages raise the same
    ValueError."""
    v, m = _nested_x()
    # JAX's executor wraps the layer's ValueError in its LayerStackError
    for dsl, Net, lib, exc in ((jdsl, JNetwork, "jax", Exception),
                               (tdsl, TNetwork, "torch", ValueError)):
        dsl.reset()
        x = dsl.data("x", size=D, is_sequence=True)
        sel = dsl.data("sel", size=1)
        dsl.sub_nested_seq_layer(x, sel, name="s")
        net = Net(dsl.current_graph(), outputs=["s"])
        with pytest.raises(exc, match="must be a nested sequence"):
            net.apply({}, _args({"x": (v, m),
                                 "sel": (np.zeros((B, 1), np.float32),
                                         None)}, lib))


# --------------------------------------------------------------- feeder
def _slot_samples(kind, level, rng, n=3, dim=7):
    def one():
        if kind == "index":
            return int(rng.integers(0, dim))
        if kind == "dense":
            return rng.normal(size=dim).astype(np.float32)
        ids = sorted(rng.choice(dim, size=int(rng.integers(0, 4)),
                                replace=False).tolist())
        if kind == "sparse_binary":
            return ids
        return [(i, float(rng.normal())) for i in ids]

    def seq():
        return [one() for _ in range(int(rng.integers(1, 5)))]
    if level == "flat":
        return [one() for _ in range(n)]
    if level == "seq":
        return [seq() for _ in range(n)]
    return [[seq() for _ in range(int(rng.integers(1, 4)))]
            for _ in range(n)]


_TYPE_FN = {
    ("index", "flat"): "integer_value", ("index", "seq"):
    "integer_value_sequence", ("index", "nested"):
    "integer_value_sub_sequence",
    ("dense", "flat"): "dense_vector", ("dense", "seq"):
    "dense_vector_sequence", ("dense", "nested"): "dense_vector_sub_sequence",
    ("sparse_binary", "flat"): "sparse_binary_vector",
    ("sparse_binary", "seq"): "sparse_binary_vector_sequence",
    ("sparse_binary", "nested"): "sparse_binary_vector_sub_sequence",
    ("sparse_float", "flat"): "sparse_float_vector",
    ("sparse_float", "seq"): "sparse_float_vector_sequence",
    ("sparse_float", "nested"): "sparse_float_vector_sub_sequence"}


@pytest.mark.parametrize("kind,level", sorted(_TYPE_FN))
def test_feeder_slot_matches_jax(kind, level):
    """Every slot type at every level: the same values, masks, dtypes and
    shapes as JAX's feeder (nested T through the same padding rule)."""
    fn = _TYPE_FN[(kind, level)]
    t, j = getattr(TT, fn)(7), getattr(JT, fn)(7)
    assert (t.dim, t.seq_type, t.type) == (j.dim, j.seq_type, j.type)
    col = _slot_samples(kind, level, np.random.default_rng(16))
    batch = [(s, 1) for s in col]
    feeding_j = {"a": getattr(JT, fn)(7), "y": JT.integer_value(3)}
    feeding_t = {"a": getattr(TT, fn)(7), "y": TT.integer_value(3)}
    for kw in ({}, {"pad_multiple": 4}, {"batch_buckets": [4]}):
        jf = JFeeder(feeding_j, **kw)(batch)
        tf = TFeeder(feeding_t, device="cpu", **kw)(batch)
        assert sorted(jf) == sorted(tf)
        for k, ja in jf.items():
            ta = tf[k]
            assert ta.value.numpy().dtype == np.asarray(ja.value).dtype
            np.testing.assert_array_equal(ta.value.numpy(),
                                          np.asarray(ja.value))
            if ja.mask is None:
                assert ta.mask is None
            else:
                np.testing.assert_array_equal(ta.mask.numpy(),
                                              np.asarray(ja.mask))


def test_feeder_validates_nested_ids_like_jax():
    """An out-of-range id in a live nested position raises (the message
    names the input, the id and its position); one in padding does
    not."""
    col = [[[1, 2], [3]], [[9]]]
    batch = [(s,) for s in col]
    for T, F, kw in ((JT, JFeeder, {}), (TT, TFeeder, {"device": "cpu"})):
        f = F({"w": T.integer_value_sub_sequence(5)}, validate_ids=True, **kw)
        with pytest.raises(ValueError, match=r"id 9 at position \(1, 0, 0\)"):
            f(batch)
        f([(s,) for s in [[[1, 2], [3]], [[4]]]])


def test_feeder_nested_slot_drives_a_nested_group():
    """A nested index slot through the feeder, embedding and a nested
    group: the port's output is JAX's."""
    rng = np.random.default_rng(17)
    col = [[rng.integers(0, 11, size=int(rng.integers(1, 6))).tolist()
            for _ in range(int(rng.integers(1, 4)))] for _ in range(3)]

    def build(dsl, mc):
        w = dsl.data(name="w", size=11, is_sequence=True)
        e = dsl.embedding(w, size=D, name="emb")

        def outer_step(sub):
            om = dsl.memory(name="oh", size=D)

            def inner_step(xt):
                m = dsl.memory(name="ih", size=D, boot_layer=om)
                return dsl.fc(input=[xt, m], size=D, act="tanh", name="ih")
            return dsl.last_seq(dsl.recurrent_group(inner_step, sub,
                                                    name="inner"), name="oh")
        g = dsl.recurrent_group(outer_step, dsl.SubsequenceInput(e),
                                name="outer")
        return dsl.last_seq(g, name="doc")
    jn, tn, (name,) = _nets(build)
    params = _params(jn, 18)
    jf = JFeeder({"w": JT.integer_value_sub_sequence(11)}, pad_multiple=4)
    tf = TFeeder({"w": TT.integer_value_sub_sequence(11)}, pad_multiple=4,
                 device="cpu")
    jfeed, tfeed = jf([(c,) for c in col]), tf([(c,) for c in col])
    jv = jn.apply({k: jnp.asarray(v) for k, v in params.items()},
                  jfeed)[name].value
    tv = tn.apply({k: torch.from_numpy(v) for k, v in params.items()},
                  tfeed)[name].value
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **FWD_TOL)


# ------------------------------------------------------------ predictor
def test_predictor_refuses_nested_slots_like_jax():
    """Serving refuses a SUB_SEQUENCE slot at build time with JAX's
    ValueError (the outer count is a shape axis the bucket menu does not
    close)."""
    from paddle_tpu.serving.predictor import ServingPredictor as JPred
    from paddle_tpu_torch.serving.predictor import ServingPredictor as TPred
    msgs = []
    for dsl, Pred, T, kw in ((jdsl, JPred, JT, {}),
                             (tdsl, TPred, TT, {"device": "cpu"})):
        dsl.reset()
        x = dsl.data(name="w", size=5, is_sequence=True)
        out = dsl.fc(input=dsl.last_seq(x), size=2, act="softmax", name="o")
        with pytest.raises(ValueError, match="SUB_SEQUENCE") as err:
            Pred(dsl.current_graph(), {}, [out],
                 {"w": T.dense_vector_sub_sequence(5)}, batch_buckets=[1],
                 length_buckets=[8], **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------- prev_batch_state
def test_nested_group_prev_batch_state_matches_jax():
    """Three batches through a nested group with ``prev_batch_state``:
    each batch's cost, the final parameters and the carried outer memory
    as JAX's."""
    from test_torch_train_state import RUN_TOL, _assert_params, _pair

    def build(dsl):
        lab = dsl.data(name="label", size=3)
        g = _nested(dsl, None)   # declares x
        out = dsl.fc(input=dsl.last_seq(g), size=3, act="softmax",
                     name="out")
        return dsl.classification_cost(input=out, label=lab, name="cost")

    batches = []
    for seed in range(3):
        v, m = _nested_x(seed=20 + seed)
        y = np.random.default_rng(seed).integers(0, 3, size=B).astype(
            np.int32)
        batches.append((v, m, y))
    jtr, ttr = _pair(build, jkw={"prev_batch_state": True},
                     tkw={"prev_batch_state": True}, lr=0.1)
    assert ttr._carry_layers == jtr._carry_layers == ["outer_rnn"]
    jc, tc = [], []
    jtr.train(lambda: iter([{"x": JArgument(jnp.asarray(v), jnp.asarray(m)),
                             "label": JArgument(jnp.asarray(y))}
                            for v, m, y in batches]), num_passes=1,
              event_handler=lambda e: jc.append(e.cost)
              if hasattr(e, "cost") else None)
    ttr.train(lambda: iter([{"x": TArgument(torch.from_numpy(v),
                                            torch.from_numpy(m)),
                             "label": TArgument(torch.from_numpy(y))}
                            for v, m, y in batches]), num_passes=1,
              event_handler=lambda e: tc.append(e.cost)
              if hasattr(e, "cost") else None)
    np.testing.assert_allclose(tc, jc, **RUN_TOL)
    _assert_params(ttr, jtr, RUN_TOL)
    jcar, tcar = jtr._carried["outer_rnn"], ttr._carried["outer_rnn"]
    assert sorted(jcar) == sorted(tcar) == ["outer_rnn@mem_outer_h"]
    np.testing.assert_allclose(tcar["outer_rnn@mem_outer_h"].numpy(),
                               np.asarray(jcar["outer_rnn@mem_outer_h"]),
                               **RUN_TOL)

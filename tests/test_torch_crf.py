"""The port's linear-chain CRF (``paddle_tpu_torch/ops/crf.py``,
``layers/chain.py``) against the JAX package's, on the CPU, where the
port's wrappers run their plain versions (the forward loop, the analytic
backward, the Viterbi loop) and the JAX side runs both ``crf_log_z_ref``
(autodiff through its ``lax.scan``) and the Pallas kernel in interpret mode
with its ``custom_vjp`` (``_crf_bwd``), as ``tests/test_ops_pallas.py``
runs them.

Inputs come from numpy with a seed (B <= 4, T <= 7, C <= 9): ragged masks,
a length-1 row, an all-padding row (as a batch bucket pads it) and
forbidden transitions (trans = -1e4). Tolerances: log Z and Viterbi scores
1e-5; gradients rtol 1e-4 / atol 1e-5 (f32 sums in other orders); paths
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.config.model_config import ParamAttr as JParamAttr
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.layers.chain import crf_decode as j_crf_decode
from paddle_tpu.layers.chain import crf_log_likelihood as j_crf_ll
from paddle_tpu.ops import common
from paddle_tpu.ops.crf import crf_log_z as j_crf_log_z
from paddle_tpu.ops.crf import crf_log_z_ref as j_crf_log_z_ref
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.config.model_config import ParamAttr as TParamAttr
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.layers.chain import crf_decode as t_crf_decode
from paddle_tpu_torch.layers.chain import crf_log_likelihood as t_crf_ll
from paddle_tpu_torch.ops import crf as tcrf

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# (B, T, C, lengths, forbidden transitions)
CASES = {
    "full": (3, 5, 6, [5, 5, 5], False),
    "ragged": (4, 7, 9, [7, 3, 1, 5], False),
    "padding_row": (4, 6, 5, [6, 1, 4, 0], False),
    "forbidden": (3, 6, 5, [6, 2, 4], True),
}


def _inputs(case, seed=0):
    B, T, C, lengths, forbidden = CASES[case]
    rng = np.random.default_rng(seed + B * T * C)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array(lengths)[:, None]).astype(
        np.float32)
    trans = rng.normal(size=(C, C)).astype(np.float32)
    if forbidden:
        trans[0, 1] = trans[2, 3] = -1e4
    a, b = (rng.normal(size=C).astype(np.float32) for _ in range(2))
    g = rng.normal(size=B).astype(np.float32)
    return x, mask, trans, a, b, g


def _jax_log_z_and_grads(fn, x, mask, trans, a, b, g):
    def loss(x_, t_, a_, b_):
        return jnp.sum(fn(x_, jnp.asarray(mask), t_, a_, b_) * g)
    args = tuple(jnp.asarray(v) for v in (x, trans, a, b))
    z = fn(args[0], jnp.asarray(mask), *args[1:])
    return np.asarray(z), [np.asarray(v) for v in
                           jax.grad(loss, argnums=(0, 1, 2, 3))(*args)]


@pytest.mark.parametrize("case,jax_path", [
    ("ragged", "ref"), ("forbidden", "ref"), ("full", "interpret"),
    ("ragged", "interpret"), ("padding_row", "interpret"),
    ("forbidden", "interpret")])
def test_log_z_and_gradients_match_jax(case, jax_path):
    """log Z and d(sum g log Z) / d(x, trans, a, b): the port's forward and
    analytic backward (through ``CrfFunction``) against the JAX scan
    reference (autodiff) and the JAX Pallas kernel's custom_vjp
    (``_crf_bwd``, the backward the port transcribes). The two JAX paths
    differ on an all-padding row, where the analytic backward masks the
    unary marginal of step 0 and autodiff does not (the row's cost is
    weighted 0 by the trainer's row mask either way), so that row is held
    against the custom_vjp only."""
    x, mask, trans, a, b, g = _inputs(case)
    if jax_path == "ref":
        jz, jg = _jax_log_z_and_grads(j_crf_log_z_ref, x, mask, trans, a, b,
                                      g)
    else:
        with common.force_mode("interpret"):
            jz, jg = _jax_log_z_and_grads(j_crf_log_z, x, mask, trans, a, b,
                                          g)
    leaves = [torch.from_numpy(v).requires_grad_(True)
              for v in (x, trans, a, b)]
    tz = tcrf.crf_log_z(leaves[0], torch.from_numpy(mask), *leaves[1:])
    np.testing.assert_allclose(tz.detach().numpy(), jz, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tcrf.crf_log_z_plain(
        *(torch.from_numpy(v) for v in (x, mask, trans, a, b))).numpy(), jz,
        rtol=1e-5, atol=1e-5)
    tg = torch.autograd.grad((tz * torch.from_numpy(g)).sum(), leaves)
    for name, got, want in zip(("x", "trans", "a", "b"), tg, jg):
        assert np.isfinite(got.numpy()).all(), name
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL,
                                   err_msg=name)
    if CASES[case][4]:  # forbidden transitions take no marginal
        assert abs(float(tg[1][0, 1])) < 1e-6
        assert abs(float(tg[1][2, 3])) < 1e-6
    if 0 in CASES[case][3]:  # the all-padding row takes no unary marginal
        assert float(tg[0][-1].abs().max()) == 0.0


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """``crf_bwd_plain`` (the analytic backward the kernel transcribes)
    equals autograd through ``crf_forward_plain`` in float64."""
    x, mask, trans, a, b, g = (torch.from_numpy(v).double()
                               for v in _inputs("ragged", seed=3))
    leaves = [v.clone().requires_grad_(True) for v in (x, trans, a, b)]
    alphas, log_z = tcrf.crf_forward_plain(leaves[0], mask, *leaves[1:])
    want = torch.autograd.grad((log_z * g).sum(), leaves)
    got = tcrf.crf_bwd_plain(x, mask, trans, b, alphas.detach(),
                             log_z.detach(), g)
    for name, gk, gw in zip(("x", "trans", "a", "b"), got, want):
        torch.testing.assert_close(gk, gw, rtol=1e-10, atol=1e-10,
                                   msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_viterbi_matches_jax(case):
    """Paths equal to ``paddle_tpu.layers.chain.crf_decode``'s, scores at
    1e-5; the identity pointer holds the last state over padded steps."""
    x, mask, trans, a, b, _ = _inputs(case, seed=1)
    w = np.concatenate([a[None], b[None], trans], axis=0)
    jpath, jscore = j_crf_decode(jnp.asarray(x), jnp.asarray(mask),
                                 jnp.asarray(w))
    before = tops.kernel_counts()["crf_viterbi"]["launches"]
    tpath, tscore = t_crf_decode(torch.from_numpy(x), torch.from_numpy(mask),
                                 torch.from_numpy(w))
    # the CPU runs the plain version: no kernel launch is counted
    assert tops.kernel_counts()["crf_viterbi"]["launches"] == before
    assert tpath.dtype == torch.int32
    np.testing.assert_array_equal(tpath.numpy(), np.asarray(jpath))
    np.testing.assert_allclose(tscore.numpy(), np.asarray(jscore),
                               rtol=1e-5, atol=1e-5)


def test_viterbi_ties_take_the_first_index():
    """Equal scores everywhere: every step and the final argmax pick class
    0, as jnp.argmax does."""
    x = np.zeros((2, 4, 3), np.float32)
    mask = np.ones((2, 4), np.float32)
    w = np.zeros((5, 3), np.float32)
    jpath, _ = j_crf_decode(jnp.asarray(x), jnp.asarray(mask),
                            jnp.asarray(w))
    tpath, _ = t_crf_decode(*(torch.from_numpy(v) for v in (x, mask, w)))
    np.testing.assert_array_equal(tpath.numpy(), np.asarray(jpath))
    assert not tpath.numpy().any()


def test_log_likelihood_matches_jax():
    """Gold-path score minus log Z and its gradients in x and the packed
    (C+2, C) parameter."""
    x, mask, trans, a, b, g = _inputs("ragged", seed=2)
    B, T, C = x.shape
    labels = np.random.default_rng(5).integers(0, C, size=(B, T)).astype(
        np.int32)
    w = np.concatenate([a[None], b[None], trans], axis=0)

    def jloss(x_, w_):
        ll = j_crf_ll(x_, jnp.asarray(labels), jnp.asarray(mask), w_)
        return jnp.sum(ll * g), ll

    with common.force_mode("interpret"):
        (_, jll), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                          has_aux=True)(jnp.asarray(x),
                                                        jnp.asarray(w))
    tx, tw = (torch.from_numpy(v).requires_grad_(True) for v in (x, w))
    tll = t_crf_ll(tx, torch.from_numpy(labels), torch.from_numpy(mask), tw)
    np.testing.assert_allclose(tll.detach().numpy(), np.asarray(jll),
                               rtol=1e-5, atol=1e-5)
    assert (tll.detach().numpy() <= 1e-5).all()  # log-probabilities
    for got, want in zip(torch.autograd.grad((tll * torch.from_numpy(g))
                                             .sum(), (tx, tw)), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def _crf_graph(dsl, attr_cls, weighted):
    x = dsl.data(name="x", size=5, is_sequence=True)
    y = dsl.data(name="y", size=5, is_sequence=True)
    emission = dsl.fc(input=x, size=5, act="linear", bias_attr=False)
    shared = attr_cls(name="crfw")
    wt = dsl.data(name="wt", size=1) if weighted else None
    cost = dsl.crf_layer(input=emission, label=y, size=5, weight=wt,
                         param_attr=shared)
    path = dsl.crf_decoding_layer(input=emission, size=5, param_attr=shared)
    err = dsl.crf_decoding_layer(input=emission, size=5, label=y,
                                 param_attr=shared)
    dsl.evaluator("sum", err, name="error")
    dsl.evaluator("chunk", err, label=y, chunk_scheme="IOB",
                  num_chunk_types=2)
    return cost, path, err


@pytest.mark.parametrize("weighted", [False, True])
def test_crf_layers_match_jax(weighted):
    """The DSL emits the JAX package's LayerDefs, auto-names, shared
    parameter and evaluator entries; ``crf`` (with the optional weight
    input) and both ``crf_decoding`` forms agree with the JAX layers, the
    labelled form's ``ids`` view included; the cost's gradients match."""
    jdsl.reset()
    jout = _crf_graph(jdsl, JParamAttr, weighted)
    tdsl.reset()
    tout = _crf_graph(tdsl, TParamAttr, weighted)
    jg, tg = jout[0].graph, tout[0].graph
    assert [o.name for o in tout] == [o.name for o in jout] == [
        "__crf_layer_0__", "__crf_decoding_layer_0__",
        "__crf_decoding_layer_1__"]
    assert list(tg.layers) == list(jg.layers)
    for name, jl in jg.layers.items():
        tl = tg.layers[name]
        assert (tl.type, tl.size, tl.input_names(), tl.bias) == (
            jl.type, jl.size, jl.input_names(), jl.bias), name
    assert tg.evaluators == jg.evaluators
    assert [e["name"] for e in tg.evaluators] == ["error",
                                                   "__chunk_evaluator_0__"]
    names = [o.name for o in jout]
    jnet, tnet = JNetwork(jg, outputs=names), TNetwork(tg, outputs=names)
    assert sorted(tnet.param_specs) == sorted(jnet.param_specs) == [
        "___fc_layer_0__.w0", "crfw"]
    assert tnet.param_specs["crfw"].shape == (7, 5)
    rng = np.random.default_rng(int(weighted))
    params = {k: rng.normal(size=s.shape).astype(np.float32)
              for k, s in jnet.param_specs.items()}
    x = rng.normal(size=(4, 6, 5)).astype(np.float32)
    y = rng.integers(0, 5, size=(4, 6)).astype(np.int32)
    mask = (np.arange(6)[None, :] < np.array([6, 1, 3, 0])[:, None]).astype(
        np.float32)
    wt = rng.uniform(0.5, 2.0, size=(4, 1)).astype(np.float32)

    def feed(arg, to):
        f = {"x": arg(to(x), to(mask)), "y": arg(to(y), to(mask))}
        if weighted:
            f["wt"] = arg(to(wt))
        return f

    def jloss(p):
        outs = jnet.apply(p, feed(JArgument, jnp.asarray))
        return jnp.sum(outs[names[0]].value), outs

    with common.force_mode("interpret"):
        (_, jouts), jgrads = jax.value_and_grad(jloss, has_aux=True)(
            {k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    touts = tnet.apply(tp, feed(TArgument, torch.from_numpy))
    np.testing.assert_allclose(touts[names[0]].value.detach().numpy(),
                               np.asarray(jouts[names[0]].value), rtol=1e-5,
                               atol=1e-5)
    for name in names[1:]:
        assert touts[name].value.dtype in (torch.int32, torch.float32)
        np.testing.assert_array_equal(touts[name].value.numpy(),
                                      np.asarray(jouts[name].value))
    np.testing.assert_array_equal(touts[names[1]].mask.numpy(), mask)
    tstate, jstate = touts[names[2]].state, jouts[names[2]].state
    np.testing.assert_array_equal(tstate["ids"].numpy(),
                                  np.asarray(jstate["ids"]))
    np.testing.assert_array_equal(tstate["ids_mask"].numpy(),
                                  np.asarray(jstate["ids_mask"]))
    tgrads = torch.autograd.grad(touts[names[0]].value.sum(),
                                 list(tp.values()))
    for k, got in zip(tp, tgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(jgrads[k]),
                                   **GRAD_TOL, err_msg=k)

"""The port's CTC (``paddle_tpu_torch/ops/ctc.py``, the ``ctc`` and
``warp_ctc`` layers of ``layers/chain.py``, the ``ctc_edit_distance``
evaluator) against the JAX package's, on the CPU, where the port's
wrappers run their plain versions (the alpha loop and the beta recursion
of ``_ctc_bwd``) and the JAX side runs both ``ctc_ll_ref`` (autodiff
through its ``lax.scan``) and the Pallas kernel in interpret mode with its
``custom_vjp`` (``_ctc_bwd``), as ``tests/test_ops_pallas.py`` runs them.

Inputs come from numpy with a seed (B <= 4, T <= 12, C <= 6, L <= 4):
ragged frames and transcripts, an empty transcript, repeated labels, T =
2 L + 1, an infeasible row (fewer frames than its labels need: ll about
-1e30, finite gradients), padded frames and B = 1. Tolerances: values
rtol 1e-5 / atol 1e-5; gradients rtol 1e-4 / atol 1e-5 against the
kernel's VJP (the same recursion, f32 sums in another order) and JAX's
own 2e-4 / 2e-5 against autodiff of the scan; the infeasible row's
gradient only against the kernel's VJP, the only JAX path that clamps
the posterior at exp(30).

The slice test: the DeepSpeech2-shaped acoustic model of ``chip_smoke.py``
at a small width (10 features, 2 bidirectional GRU layers of 8, 6
outputs, ``warp_ctc_layer(blank=5, norm_by_times=True)``, the
``ctc_edit_distance`` evaluator): loss and every parameter gradient, 3
Adam steps, then ``test()``'s cost and CTC error, against the JAX
package's ``SGD``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.data import DataFeeder as JFeeder
from paddle_tpu.data import types as jtypes
from paddle_tpu.ops import common
from paddle_tpu.ops.ctc import _ctc_core, ctc_ll_ref
from paddle_tpu.optim import Adam as JAdam
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu.trainer import events as jev
from paddle_tpu.trainer import metrics as jmetrics
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.compat.from_jax import params_from_numpy
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.data import types as ttypes
from paddle_tpu_torch.data.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.layers.chain import ctc_loss as t_ctc_loss
from paddle_tpu_torch.layers.chain import extended_labels
from paddle_tpu_torch.ops import ctc as tctc
from paddle_tpu_torch.optim import Adam as TAdam
from paddle_tpu_torch.trainer import events as tev
from paddle_tpu_torch.trainer import metrics as tmetrics
from paddle_tpu_torch.trainer.trainer import SGD as TSGD

VAL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
REF_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_ops_pallas.py's
RUN_TOL = dict(rtol=1e-4, atol=1e-4)

# (B, T, C, labels per row (blank C-1 never among them), frames per row);
# "infeasible" has rows with fewer frames than their labels need
CASES = {
    "ragged": (4, 12, 6, [[0, 3, 1, 2], [4, 1], [2], [3, 0, 4]],
               [12, 9, 5, 10]),
    "empty": (3, 8, 6, [[1, 2], [], [4]], [8, 6, 3]),
    "repeats": (3, 12, 6, [[1, 1, 2, 2], [3, 3, 3], [0, 4, 4]],
                [12, 10, 7]),
    "tight": (2, 9, 6, [[0, 1, 2, 3], [2, 2, 1, 1]], [9, 9]),
    "infeasible": (3, 10, 6, [[0, 1, 2, 3], [1, 1, 1, 1], [2, 3]],
                   [3, 6, 10]),
    "padded": (4, 12, 5, [[0, 1], [2, 3, 0], [1], [3, 3]],
               [4, 7, 2, 12]),
    "b1": (1, 11, 6, [[4, 0, 4, 2]], [11]),
}


def _feasible(labels, frames):
    return frames >= len(labels) + sum(
        a == b for a, b in zip(labels, labels[1:]))


def _inputs(case, seed=0):
    """log_probs [B,T,C], labels [B,L] (padded with 0), in_mask [B,T],
    label_mask [B,L], the cotangent g [B], blank C-1 and the rows that are
    feasible."""
    B, T, C, labs, frames = CASES[case]
    rng = np.random.default_rng(seed + 7 * B + T)
    L = max(max(len(x) for x in labs), 1)
    logits = rng.normal(size=(B, T, C)).astype(np.float32)
    log_probs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    labels = np.zeros((B, L), np.int32)
    label_mask = np.zeros((B, L), np.float32)
    for b, x in enumerate(labs):
        labels[b, :len(x)] = x
        label_mask[b, :len(x)] = 1.0
    in_mask = (np.arange(T)[None, :] < np.array(frames)[:, None]).astype(
        np.float32)
    g = rng.normal(size=B).astype(np.float32)
    feasible = np.array([_feasible(x, n) for x, n in zip(labs, frames)])
    return log_probs, labels, in_mask, label_mask, g, C - 1, feasible


def _operands(log_probs, labels, label_mask, blank):
    """ctc_ll's operands as numpy, through the port's extended labels."""
    ext, ext_lens, valid_s, can_skip = extended_labels(
        torch.from_numpy(labels), torch.from_numpy(label_mask), blank)
    B, T, _ = log_probs.shape
    emit = np.take_along_axis(
        log_probs, np.broadcast_to(ext.numpy()[:, None, :],
                                   (B, T, ext.shape[1])), axis=2)
    return (np.ascontiguousarray(emit), valid_s.float().numpy(),
            can_skip.float().numpy(), ext_lens.numpy())


def _jax_value_and_grad(fn, emit, in_mask, valid_s, can_skip, ext_lens, g):
    """(ll, d(sum g ll) / d emit) of ``fn``, jitted (one compile: faster
    than the scan's eager dispatch)."""
    @jax.jit
    def run(e, *rest):
        ll, vjp = jax.vjp(lambda e_: fn(e_, *rest[:-1]), e)
        return ll, vjp(rest[-1])[0]

    ll, de = run(*(jnp.asarray(v) for v in (emit, in_mask, valid_s,
                                            can_skip, ext_lens, g)))
    return np.asarray(ll), np.asarray(de)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ctc_ll_and_gradient_match_jax(case):
    """ll and d(sum g ll) / d emit through ``CtcFunction`` against JAX's
    ``ctc_ll_ref`` (autodiff of the scan) and ``_ctc_core`` in interpret
    mode (the Pallas kernel and ``_ctc_bwd``)."""
    log_probs, labels, in_mask, label_mask, g, blank, ok = _inputs(case)
    emit, valid_s, can_skip, ext_lens = _operands(log_probs, labels,
                                                  label_mask, blank)
    ops = (emit, in_mask, valid_s, can_skip, ext_lens, g)
    ref_ll, ref_g = _jax_value_and_grad(ctc_ll_ref, *ops)
    with common.force_mode("interpret"):
        k_ll, k_g = _jax_value_and_grad(_ctc_core, *ops)
    leaf = torch.from_numpy(emit).requires_grad_(True)
    before = tops.kernel_counts()["ctc_alpha_fwd"]["launches"]
    ll = tctc.ctc_ll(leaf, *(torch.from_numpy(v) for v in ops[1:5]))
    # the CPU runs the plain versions: no kernel launch is counted
    assert tops.kernel_counts()["ctc_alpha_fwd"]["launches"] == before
    got_g, = torch.autograd.grad((ll * torch.from_numpy(g)).sum(), leaf)
    ll, got_g = ll.detach().numpy(), got_g.numpy()
    np.testing.assert_allclose(ll, ref_ll, **VAL_TOL)
    np.testing.assert_allclose(ll, k_ll, **VAL_TOL)
    assert np.isfinite(ll).all() and np.isfinite(got_g).all()
    np.testing.assert_allclose(got_g, k_g, **GRAD_TOL)
    np.testing.assert_allclose(got_g[ok], ref_g[ok], **REF_TOL)
    if not ok.all():  # infeasible: ll about -1e30, not -inf
        assert (ll[~ok] < -1e29).all() and (ll[ok] > -1e3).all()


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """``ctc_bwd_plain`` (the recursion the backward kernel transcribes)
    equals autograd through ``ctc_forward_plain`` in float64, on feasible
    rows."""
    log_probs, labels, in_mask, label_mask, g, blank, ok = _inputs("ragged",
                                                                   seed=3)
    emit, valid_s, can_skip, ext_lens = (
        torch.from_numpy(v) for v in _operands(log_probs, labels,
                                               label_mask, blank))
    emit, in_mask, valid_s, can_skip, g = (
        t.double() for t in (emit, torch.from_numpy(in_mask), valid_s,
                             can_skip, torch.from_numpy(g)))
    leaf = emit.clone().requires_grad_(True)
    alphas, ll = tctc.ctc_forward_plain(leaf, in_mask, valid_s, can_skip,
                                        ext_lens)
    want, = torch.autograd.grad((ll * g).sum(), leaf)
    got = tctc.ctc_bwd_plain(emit, in_mask, valid_s, can_skip, ext_lens,
                             alphas.detach(), ll.detach(), g)
    assert ok.all()
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def _brute_ctc(lp, label, blank):
    """-log of the sum over every alignment of length T collapsing to
    ``label``."""
    T, C = lp.shape

    def collapse(path):
        out, prev = [], -1
        for p in path:
            if p != prev and p != blank:
                out.append(p)
            prev = p
        return tuple(out)

    tot = -np.inf
    for path in itertools.product(range(C), repeat=T):
        if collapse(path) == tuple(label):
            tot = np.logaddexp(tot, sum(lp[t, path[t]] for t in range(T)))
    return -tot


def test_ctc_loss_matches_bruteforce():
    """``ctc_loss`` against enumeration of every alignment (as
    ``tests/test_chain.py`` checks JAX's): ragged frames and labels, a
    repeat, an empty transcript."""
    rng = np.random.default_rng(3)
    B, T, C = 4, 5, 3
    blank = C - 1
    lp = torch.log_softmax(torch.from_numpy(
        rng.normal(size=(B, T, C)).astype(np.float32)), dim=-1)
    labels = torch.tensor([[0, 1], [1, 0], [1, 1], [0, 0]])
    frames, lens = [5, 3, 5, 4], [2, 1, 2, 0]
    in_mask = (torch.arange(T)[None, :] < torch.tensor(frames)[:, None]) \
        .float()
    label_mask = (torch.arange(2)[None, :] < torch.tensor(lens)[:, None]) \
        .float()
    got = t_ctc_loss(lp, labels, in_mask, label_mask, blank).numpy()
    want = [_brute_ctc(lp[b, :frames[b]].double().numpy(),
                       labels[b, :lens[b]].tolist(), blank)
            for b in range(B)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _ctc_graph(dsl, kind, attrs):
    x = dsl.data(name="x", size=4, is_sequence=True)
    y = dsl.data(name="y", size=5, is_sequence=True)
    scores = dsl.fc(input=x, size=6, act="linear")
    layer = dsl.ctc_layer if kind == "ctc" else dsl.warp_ctc_layer
    return layer(input=scores, label=y, size=6, **attrs), scores


@pytest.mark.parametrize("kind,attrs", [
    ("ctc", {}),                                   # blank C - 1
    ("ctc", {"blank": 0, "norm_by_times": True}),
    ("warp_ctc", {}),                              # blank 0
    ("warp_ctc", {"blank": 5, "norm_by_times": True})])
def test_ctc_layers_match_jax(kind, attrs):
    """Both DSLs record the same LayerDef (``ctc_layer`` no blank, so the
    layer takes C - 1; ``warp_ctc_layer`` blank 0) and the layers' costs
    and gradients (the fc parameters, and the data through the
    pre-softmax scores) match JAX's in interpret mode, with a [B, L, 1]
    label."""
    jdsl.reset()
    jcost, _ = _ctc_graph(jdsl, kind, attrs)
    tdsl.reset()
    tcost, _ = _ctc_graph(tdsl, kind, attrs)
    jl, tl = jcost.graph.layers[jcost.name], tcost.graph.layers[tcost.name]
    assert tcost.name == jcost.name == f"__{kind}_layer_0__"
    assert (tl.type, tl.attrs, tl.input_names(), tl.bias) == (
        jl.type, jl.attrs, jl.input_names(), jl.bias)
    assert ("blank" in tl.attrs) == (kind == "warp_ctc" or "blank" in attrs)
    jnet = JNetwork(jcost.graph, outputs=[jcost.name])
    tnet = TNetwork(tcost.graph, outputs=[tcost.name])
    assert sorted(tnet.param_specs) == sorted(jnet.param_specs)
    rng = np.random.default_rng(len(attrs) + len(kind))
    params = {k: rng.normal(size=s.shape).astype(np.float32)
              for k, s in jnet.param_specs.items()}
    blank = tl.attrs.get("blank", 5)
    B, T, L = 4, 10, 3
    x = rng.normal(size=(B, T, 4)).astype(np.float32)
    xm = (np.arange(T)[None, :] < np.array([10, 7, 3, 9])[:, None]).astype(
        np.float32)
    y = rng.integers(0, 5, size=(B, L, 1)).astype(np.int32)
    y[y >= blank] += 1  # no label is the blank
    ym = (np.arange(L)[None, :] < np.array([3, 2, 3, 0])[:, None]).astype(
        np.float32)

    def jloss(p, xv):
        out = jnet.apply(p, {"x": JArgument(xv, jnp.asarray(xm)),
                             "y": JArgument(jnp.asarray(y),
                                            jnp.asarray(ym))})
        return jnp.sum(out[jcost.name].value), out[jcost.name].value

    with common.force_mode("interpret"):
        (_, jval), (jgp, jgx) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = params_from_numpy(params, device="cpu")
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tval = tnet.apply(tp, {"x": TArgument(tx, torch.from_numpy(xm)),
                           "y": TArgument(torch.from_numpy(y),
                                          torch.from_numpy(ym))})[
        tcost.name].value
    np.testing.assert_allclose(tval.detach().numpy(), np.asarray(jval),
                               **VAL_TOL)
    assert tval.shape == (B, 1)
    grads = torch.autograd.grad(tval.sum(), list(tp.values()) + [tx])
    for k, got in zip(list(tp) + ["x"], grads):
        want = jgx if k == "x" else jgp[k]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL,
                                   err_msg=k)


def test_best_path_and_edit_distance_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        lp = rng.normal(size=(int(rng.integers(1, 15)), 5))
        assert tmetrics.ctc_best_path(lp, 4) == jmetrics.ctc_best_path(lp, 4)
        a, b = (rng.integers(0, 4, size=int(rng.integers(0, 9))).tolist()
                for _ in range(2))
        assert tmetrics.edit_distance(a, b) == jmetrics.edit_distance(a, b)
    assert tmetrics.edit_distance([1, 2, 3], [2, 3, 4]) == 2
    assert tmetrics.ctc_best_path(np.log(np.eye(3)[[0, 0, 2, 1, 1, 2, 0]]
                                         + 1e-9), 2) == [0, 1, 0]


def test_ctc_error_evaluator_matches_jax():
    """Built from its config entry (no longer ``NOT_PORTED``), fed ragged
    rows as the trainer feeds them (the output's mask and the label, no
    label mask: a padded label row's tail counts), and with a label mask;
    a blank given explicitly too."""
    assert "ctc_edit_distance" not in tmetrics.NOT_PORTED
    rng = np.random.default_rng(5)
    out = rng.normal(size=(4, 9, 6)).astype(np.float32)
    mask = (np.arange(9)[None, :] < np.array([9, 4, 1, 7])[:, None]).astype(
        np.float32)
    lab = rng.integers(0, 5, size=(4, 3)).astype(np.int32)
    lab_mask = (np.arange(3)[None, :] < np.array([3, 1, 0, 2])[:, None]) \
        .astype(np.float32)
    for cfg, kwargs in (({}, {}), ({}, {"label_mask": lab_mask}),
                        ({"blank": 0}, {})):
        entry = {"type": "ctc_edit_distance", "name": "cer",
                 "input_layers": ["o", "l"],
                 "_roles": {"n_outputs": 1, "has_label": True,
                            "has_weight": False}, **cfg}
        (te, _, _), = tmetrics.build_from_configs([entry])
        je = jmetrics.create_evaluator("ctc_edit_distance", name="cer",
                                       **cfg)
        for e in (te, je):
            e.start()
            e.eval_batch(out[:2], label=lab[:2], mask=mask[:2],
                         **{k: v[:2] for k, v in kwargs.items()})
            e.eval_batch(out[2:], label=lab[2:], mask=mask[2:],
                         **{k: v[2:] for k, v in kwargs.items()})
        assert te.value() == je.value() > 0


# ------------------------------------------------------------ the slice
F, H, NL, C = 10, 8, 2, 6  # features, GRU width, bi-GRU layers, outputs
T = 12


def _vehicle(dsl):
    """chip_smoke.py's acoustic model at a small width: per layer, fc(3H,
    linear) -> grumemory forward and fc(3H, linear) -> grumemory reverse,
    concatenated; then fc(C, linear) -> warp_ctc(blank C-1,
    norm_by_times), and the ctc_edit_distance evaluator on the scores."""
    audio = dsl.data(name="audio", size=F, is_sequence=True)
    text = dsl.data(name="text", size=C - 1, is_sequence=True)
    x = audio
    for _ in range(NL):
        fwd = dsl.grumemory(input=dsl.fc(input=x, size=3 * H, act="linear"))
        bwd = dsl.grumemory(input=dsl.fc(input=x, size=3 * H, act="linear"),
                            reverse=True)
        x = dsl.concat([fwd, bwd])
    scores = dsl.fc(input=x, size=C, act="linear")
    cost = dsl.warp_ctc_layer(input=scores, label=text, size=C,
                              blank=C - 1, norm_by_times=True)
    dsl.evaluator("ctc_edit_distance", input=scores, label=text)
    return cost


def _samples(rng, n):
    """(frames [t, F], transcript): t in 5..T frames, 1..t//3 characters,
    each frame its character's prototype plus noise."""
    protos = np.random.default_rng(99).normal(size=(C, F))
    out = []
    for _ in range(n):
        t = int(rng.integers(5, T + 1))
        lab = rng.integers(0, C - 1, size=int(rng.integers(1, t // 3 + 1)))
        seq = np.repeat(np.append(lab, C - 1), -(-t // (len(lab) + 1)))[:t]
        frames = protos[seq] + 0.3 * rng.normal(size=(t, F))
        out.append((frames.astype(np.float32).tolist(), lab.tolist()))
    return out


def _feeding(types):
    return {"audio": types.dense_vector_sequence(F),
            "text": types.integer_value_sequence(C - 1)}


@pytest.fixture(scope="module")
def vehicle():
    jdsl.reset()
    jcost = _vehicle(jdsl)
    tdsl.reset()
    tcost = _vehicle(tdsl)
    rng = np.random.default_rng(0)
    specs = JNetwork(jcost.graph, outputs=[jcost.name]).param_specs
    params = {k: (rng.normal(size=s.shape) * 0.3).astype(np.float32)
              for k, s in specs.items()}
    return jcost, tcost, params


def _trainers(vehicle, lr):
    jcost, tcost, params = vehicle
    jtr = JSGD(cost=jcost, update_equation=JAdam(learning_rate=lr),
               parameters={k: jnp.asarray(v) for k, v in params.items()})
    ttr = TSGD(cost=tcost, update_equation=TAdam(learning_rate=lr),
               parameters=params_from_numpy(params, device="cpu"),
               device="cpu")
    return jtr, ttr


def test_vehicle_loss_and_every_gradient_match_jax(vehicle):
    """The graphs agree layer by layer (the ctc layer has no parameter,
    so ``compat/from_jax.py`` carries every one by name), and the loss and
    every parameter gradient of one ragged batch match JAX's."""
    jcost, tcost, params = vehicle
    assert list(tcost.graph.layers) == list(jcost.graph.layers)
    assert tcost.graph.evaluators == jcost.graph.evaluators
    with common.force_mode("interpret"):
        jtr, ttr = _trainers(vehicle, 1e-3)
        batch = _samples(np.random.default_rng(1), 4)
        jfeed = JFeeder(_feeding(jtypes), pad_multiple=T)(batch)
        tfeed = TFeeder(_feeding(ttypes), pad_multiple=T, device="cpu")(batch)

        def jloss(p):
            return jtr._total_cost(jtr.network.apply(p, jfeed, train=True),
                                   jtr._row_mask(jfeed))

        jl, jg = jax.jit(jax.value_and_grad(jloss))(jtr.params)
    _, tl, tg, _ = ttr.loss_and_grads(tfeed)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert sorted(tg) == sorted(jg) == sorted(params)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   **GRAD_TOL, err_msg=k)


def test_vehicle_adam_trajectory_and_test_match_jax(vehicle):
    """3 Adam steps (costs and final parameters), then ``test()`` on 2
    batches: the cost and the ``ctc_edit_distance`` value equal JAX's."""
    rng = np.random.default_rng(4)
    # batches of one size: JAX compiles its step once
    batches = [_samples(rng, 4) for _ in range(3)]
    test_batches = [_samples(rng, 4) for _ in range(2)]
    jcosts, tcosts = [], []
    with common.force_mode("interpret"):
        jtr, ttr = _trainers(vehicle, 1e-2)
        jtr.train(lambda: iter(batches),
                  feeder=JFeeder(_feeding(jtypes), pad_multiple=T),
                  num_passes=1, event_handler=lambda e: jcosts.append(
                      e.cost) if isinstance(e, jev.EndIteration) else None)
        jres = jtr.test(lambda: iter(test_batches),
                        feeder=JFeeder(_feeding(jtypes), pad_multiple=T))
    tfeeder = TFeeder(_feeding(ttypes), pad_multiple=T, device="cpu")
    ttr.train(lambda: iter(batches), feeder=tfeeder, num_passes=1,
              event_handler=lambda e: tcosts.append(e.cost) if isinstance(
                  e, tev.EndIteration) else None)
    tres = ttr.test(lambda: iter(test_batches), feeder=tfeeder)
    assert len(tcosts) == 3
    np.testing.assert_allclose(tcosts, jcosts, **RUN_TOL)
    for k, v in jtr.params.items():
        np.testing.assert_allclose(ttr.params[k].numpy(), np.asarray(v),
                                   **RUN_TOL, err_msg=k)
    np.testing.assert_allclose(tres.cost, jres.cost, **RUN_TOL)
    name = "__ctc_edit_distance_evaluator_0__"
    assert set(tres.evaluator) == set(jres.evaluator) == {name}
    assert tres.evaluator[name] == pytest.approx(jres.evaluator[name],
                                                 abs=1e-6)

"""The rest of training against the JAX package, on the CPU: training-mode
dropout, cross-entropy over differently padded sequences, gradient
accumulation and truncated BPTT (``prev_batch_state``).

- dropout: JAX's keep mask (``jax.random.bernoulli`` under ``fold_in(key,
  crc32(name + "/drop"))``) replayed through the port's
  ``_dropout_mask``: the loss and every gradient as JAX's; the test-time
  scaling by 1 - rate; the port's own masks (one a layer, the same bits
  from one seed, the keep fraction within 4 sigma of the binomial mean);
- the cost layer with the label trimmed or padded to the output's padded
  length, value and gradient;
- ``grad_accum_steps`` 2 and 4 against JAX at the same k over 3 batches,
  a tail batch that takes gcd(k, B) microbatches, and the refusals (a
  first batch k does not divide; with ``prev_batch_state``; with a
  ``gradient_printer``);
- ``prev_batch_state`` for an LSTM, a GRU and a recurrent group against
  JAX over 3 batches of ragged sequences: every batch's cost, the final
  parameters and the carried state.

Tolerances: values rtol 1e-5 / atol 1e-5, gradients rtol 1e-4 / atol
1e-5 (float32 sums in other orders); 3-step trajectories rtol/atol 1e-4
(the gradient differences compounded over the updates).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.optim import Momentum as JMomentum
from paddle_tpu.trainer import SGD as JSGD
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core import network as tnetwork
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.optim import Momentum as TMomentum
from paddle_tpu_torch.trainer.trainer import SGD as TSGD

VAL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
RUN_TOL = dict(rtol=1e-4, atol=1e-4)
D, HID, C = 6, 10, 3


def _mlp(dsl, rate=0.0):
    """x -> fc(tanh) [-> dropout] -> fc(softmax) -> cross-entropy."""
    x = dsl.data(name="x", size=D)
    lab = dsl.data(name="label", size=C)
    h = dsl.fc(input=x, size=HID, act="tanh", name="hid")
    if rate:
        h = dsl.dropout(h, rate, name="drop")
    out = dsl.fc(input=h, size=C, act="softmax", name="out")
    return dsl.classification_cost(input=out, label=lab, name="cost")


def _params(jtr, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=np.shape(v)) * scale).astype(np.float32)
            for k, v in jtr.params.items()}


def _pair(build, seed=0, jkw=None, tkw=None, lr=0.05):
    jdsl.reset()
    jcost = build(jdsl)
    jtr = JSGD(cost=jcost, update_equation=JMomentum(learning_rate=lr,
                                                     momentum=0.9),
               seed=1, **(jkw or {}))
    params = _params(jtr, seed)
    jtr = JSGD(cost=jcost, update_equation=JMomentum(learning_rate=lr,
                                                     momentum=0.9),
               parameters={k: jnp.asarray(v) for k, v in params.items()},
               **(jkw or {}))
    tdsl.reset()
    tcost = build(tdsl)
    ttr = TSGD(tcost, parameters=params, device="cpu",
               update_equation=TMomentum(learning_rate=lr, momentum=0.9),
               **(tkw or {}))
    return jtr, ttr


def _dense_batches(sizes, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, D)).astype(np.float32),
             rng.integers(0, C, size=n).astype(np.int32)) for n in sizes]


def _dense_readers(batches):
    def jreader():
        for x, y in batches:
            yield {"x": JArgument(jnp.asarray(x)),
                   "label": JArgument(jnp.asarray(y))}

    def treader():
        for x, y in batches:
            yield {"x": TArgument(torch.from_numpy(x)),
                   "label": TArgument(torch.from_numpy(y))}
    return jreader, treader


def _assert_params(tr_t, tr_j, tol):
    assert sorted(tr_t.params) == sorted(tr_j.params)
    for k, v in tr_j.params.items():
        np.testing.assert_allclose(tr_t.params[k].detach().numpy(),
                                   np.asarray(v), **tol, err_msg=k)


# ------------------------------------------------------------- dropout
def _jax_keep(key, name, rate, shape):
    return np.asarray(jax.random.bernoulli(
        jax.random.fold_in(key, zlib.crc32((name + "/drop").encode())),
        1.0 - rate, shape)).astype(np.float32)


def test_dropout_with_jax_mask_replayed_matches_loss_and_grads(monkeypatch):
    """The loss and every gradient of a batch with dropout 0.5, JAX's keep
    mask replayed through ``_dropout_mask``; and the test forward scaled
    by 1 - rate in both."""
    rate = 0.5
    jtr, ttr = _pair(lambda dsl: _mlp(dsl, rate))
    (x, y), = _dense_batches([8])
    key = jax.random.PRNGKey(11)
    jfeed = {"x": JArgument(jnp.asarray(x)),
             "label": JArgument(jnp.asarray(y))}

    def jloss(p):
        outs, _ = jtr.network.apply_with_state(p, jfeed, train=True,
                                               rng=key)
        return jtr._total_cost(outs)

    jl, jg = jax.value_and_grad(jloss)(jtr.params)
    masks = {}

    def replay(shape, r, ctx, name, device):
        assert r == rate
        masks[name] = _jax_keep(key, name, rate, tuple(shape))
        return torch.from_numpy(masks[name])

    monkeypatch.setattr(tnetwork, "_dropout_mask", replay)
    tfeed = {"x": TArgument(torch.from_numpy(x)),
             "label": TArgument(torch.from_numpy(y))}
    _, tl, tg, _ = ttr.loss_and_grads(tfeed, seed=0)
    assert list(masks) == ["drop"] and 0 < masks["drop"].mean() < 1
    np.testing.assert_allclose(float(tl), float(jl), **VAL_TOL)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   **GRAD_TOL, err_msg=k)
    # test time: non-inverted dropout scales by 1 - rate
    jout = jtr.network.apply(jtr.params, jfeed, train=False)
    with torch.no_grad():
        tout = ttr.network.apply(ttr.params, tfeed, train=False)
    for name in ("drop", "out"):
        np.testing.assert_allclose(tout[name].value.numpy(),
                                   np.asarray(jout[name].value), **VAL_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(tout["drop"].value.numpy(),
                               tout["hid"].value.numpy() * (1 - rate),
                               **VAL_TOL)


def test_dropout_masks_per_layer_and_seed():
    """``_dropout_mask``: one stream a layer (two names, two masks), the
    same bits from the same seed, another seed another mask, the keep
    fraction within 4 sigma of the binomial mean; the gradient of a
    dropped layer is the mask times the upstream gradient."""
    ctx = tnetwork.Context(train=True, seed=1234)
    shape, rate = (64, 50), 0.3
    a = tnetwork._dropout_mask(shape, rate, ctx, "a", "cpu")
    assert torch.equal(a, tnetwork._dropout_mask(shape, rate, ctx, "a",
                                                 "cpu"))
    assert not torch.equal(a, tnetwork._dropout_mask(shape, rate, ctx, "b",
                                                     "cpu"))
    other = tnetwork.Context(train=True, seed=1235)
    assert not torch.equal(a, tnetwork._dropout_mask(shape, rate, other,
                                                     "a", "cpu"))
    n = a.numel()
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(float(a.sum()) - n * (1 - rate)) <= 4 * sigma
    assert set(torch.unique(a).tolist()) <= {0.0, 1.0}
    # the gradient through a dropout layer: the mask times the upstream
    tdsl.reset()
    x = tdsl.data(name="x", size=50)
    d = tdsl.dropout(x, rate, name="d")
    net = tnetwork.Network(tdsl.current_graph(), outputs=[d.name])
    xv = torch.randn(64, 50, requires_grad=True)
    up = torch.randn(64, 50)
    out = net.apply({}, {"x": TArgument(xv)}, train=True, seed=77)["d"]
    keep = tnetwork._dropout_mask(
        shape, rate, tnetwork.Context(train=True, seed=77), "d", "cpu")
    assert torch.equal(out.value, xv.detach() * keep)
    (gx,) = torch.autograd.grad((out.value * up).sum(), [xv])
    assert torch.equal(gx, keep * up)
    with pytest.raises(ValueError, match="step seed"):
        net.apply({}, {"x": TArgument(xv)}, train=True)


# ------------------------------------------------ padded cross-entropy
@pytest.mark.parametrize("label_len", [4, 9])
def test_cross_entropy_of_differently_padded_sequences(label_len):
    """An output sequence padded to 6 steps against labels padded to 4
    (padded up to 6) and to 9 (trimmed to 6): the per-row cost and its
    gradient as JAX's."""
    B, T = 3, 6
    rng = np.random.default_rng(label_len)
    lens = np.array([6, 4, 2])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    probs = rng.uniform(0.05, 1.0, size=(B, T, C)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    lab = rng.integers(0, C, size=(B, label_len)).astype(np.int32)
    lab_mask = (np.arange(label_len)[None]
                < np.minimum(lens, label_len)[:, None]).astype(np.float32)

    def build(dsl):
        p = dsl.data(name="p", size=C, is_sequence=True)
        y = dsl.data(name="y", size=C, is_sequence=True)
        return dsl.classification_cost(input=p, label=y, name="cost")

    jdsl.reset()
    jc = build(jdsl)
    from paddle_tpu.core.network import Network as JNetwork
    jnet = JNetwork(jc.graph, outputs=[jc.name])

    def jcost(pv):
        return jnet.apply({}, {"p": JArgument(pv, jnp.asarray(mask)),
                               "y": JArgument(jnp.asarray(lab),
                                              jnp.asarray(lab_mask))}
                          )["cost"].value

    jv = jcost(jnp.asarray(probs))
    jg = jax.grad(lambda pv: jnp.sum(jcost(pv)))(jnp.asarray(probs))
    tdsl.reset()
    tc = build(tdsl)
    tnet = tnetwork.Network(tdsl.current_graph(), outputs=[tc.name])
    tp = torch.from_numpy(probs).requires_grad_(True)
    tv = tnet.apply({}, {"p": TArgument(tp, torch.from_numpy(mask)),
                         "y": TArgument(torch.from_numpy(lab),
                                        torch.from_numpy(lab_mask))}
                    )["cost"].value
    assert tv.shape == (B, 1)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               **VAL_TOL)
    (tg,) = torch.autograd.grad(tv.sum(), [tp])
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD_TOL)


# --------------------------------------------- gradient accumulation
@pytest.mark.parametrize("k", [2, 4])
def test_grad_accum_matches_jax(k):
    """Three batches of 8 rows then a tail of 6 (gcd(k, 6) microbatches)
    at ``grad_accum_steps=k``: each step's cost and the final parameters
    as JAX's at the same k, and as the port's own k = 1 run."""
    batches = _dense_batches([8, 8, 8, 6])
    jreader, treader = _dense_readers(batches)
    jtr, ttr = _pair(_mlp)
    jcosts, tcosts = [], []
    jtr.train(jreader, num_passes=1, grad_accum_steps=k,
              event_handler=lambda e: jcosts.append(e.cost)
              if hasattr(e, "cost") else None)
    ttr.train(treader, num_passes=1, grad_accum_steps=k,
              event_handler=lambda e: tcosts.append(e.cost)
              if hasattr(e, "cost") else None)
    assert ttr.grad_accum_steps == k
    np.testing.assert_allclose(tcosts, jcosts, **RUN_TOL)
    _assert_params(ttr, jtr, RUN_TOL)
    _, whole = _pair(_mlp)
    whole.train(treader, num_passes=1)
    for name, v in whole.params.items():
        np.testing.assert_allclose(ttr.params[name].numpy(), v.numpy(),
                                   **RUN_TOL, err_msg=name)
    # sticky: a later train() without the argument keeps k
    ttr.train(treader, num_passes=1)
    assert ttr.grad_accum_steps == k


def test_grad_accum_refusals():
    """A first batch k does not divide; k > 1 with ``prev_batch_state``
    and with a ``gradient_printer`` (as the JAX package refuses them)."""
    _, treader = _dense_readers(_dense_batches([6, 8]))
    _, ttr = _pair(_mlp)
    with pytest.raises(ValueError, match="does not divide"):
        ttr.train(treader, num_passes=1, grad_accum_steps=4)
    _, ttr = _pair(_seq_lstm, tkw={"prev_batch_state": True})
    with pytest.raises(ValueError, match="prev_batch_state"):
        ttr.train(lambda: iter(()), num_passes=1, grad_accum_steps=2)

    def printed(dsl):
        x = dsl.data(name="x", size=D)
        lab = dsl.data(name="label", size=C)
        h = dsl.fc(input=x, size=HID, act="tanh", name="hid")
        out = dsl.fc(input=h, size=C, act="softmax", name="out")
        dsl.evaluator("gradient_printer", h)
        return dsl.classification_cost(input=out, label=lab, name="cost")

    _, ttr = _pair(printed)
    with pytest.raises(ValueError, match="gradient_printer"):
        ttr.train(treader, num_passes=1, grad_accum_steps=2)


# -------------------------------------------------- prev_batch_state
SEQ_T, SEQ_D, SEQ_H = 7, 5, 4


def _seq_lstm(dsl):
    x = dsl.data(name="x", size=SEQ_D, is_sequence=True)
    lab = dsl.data(name="label", size=C)
    proj = dsl.fc(input=x, size=4 * SEQ_H, act="linear", name="proj")
    r = dsl.lstmemory(input=proj, name="rnn")
    out = dsl.fc(input=dsl.last_seq(r), size=C, act="softmax", name="out")
    return dsl.classification_cost(input=out, label=lab, name="cost")


def _seq_gru(dsl):
    x = dsl.data(name="x", size=SEQ_D, is_sequence=True)
    lab = dsl.data(name="label", size=C)
    proj = dsl.fc(input=x, size=3 * SEQ_H, act="linear", name="proj")
    r = dsl.grumemory(input=proj, name="rnn")
    out = dsl.fc(input=dsl.last_seq(r), size=C, act="softmax", name="out")
    return dsl.classification_cost(input=out, label=lab, name="cost")


def _seq_group(dsl):
    x = dsl.data(name="x", size=SEQ_D, is_sequence=True)
    lab = dsl.data(name="label", size=C)

    def step(x_t):
        mem = dsl.memory(name="h", size=SEQ_H)
        return dsl.fc(input=[x_t, mem], size=SEQ_H, act="tanh", name="h")

    r = dsl.recurrent_group(step, [x], name="rnn")
    out = dsl.fc(input=dsl.last_seq(r), size=C, act="softmax", name="out")
    return dsl.classification_cost(input=out, label=lab, name="cost")


def _seq_batches(n_batches=3, B=4, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        lens = rng.integers(1, SEQ_T + 1, size=B)
        lens[0] = SEQ_T
        mask = (np.arange(SEQ_T)[None] < lens[:, None]).astype(np.float32)
        x = (rng.normal(size=(B, SEQ_T, SEQ_D)) * mask[..., None]).astype(
            np.float32)
        y = rng.integers(0, C, size=B).astype(np.int32)
        out.append((x, mask, y))
    return out


@pytest.mark.parametrize("build", [_seq_lstm, _seq_gru, _seq_group],
                         ids=["lstm", "gru", "group"])
def test_prev_batch_state_matches_jax(build):
    """Three batches of ragged sequences with ``prev_batch_state``: each
    batch's cost, the final parameters and the carried state (each row's
    last live state) as JAX's; the carried state differs from a run
    without the carry, whose costs differ after the first batch."""
    batches = _seq_batches()

    def jreader():
        for x, m, y in batches:
            yield {"x": JArgument(jnp.asarray(x), jnp.asarray(m)),
                   "label": JArgument(jnp.asarray(y))}

    def treader():
        for x, m, y in batches:
            yield {"x": TArgument(torch.from_numpy(x), torch.from_numpy(m)),
                   "label": TArgument(torch.from_numpy(y))}

    jtr, ttr = _pair(build, jkw={"prev_batch_state": True},
                     tkw={"prev_batch_state": True}, lr=0.1)
    assert ttr._carry_layers == jtr._carry_layers == ["rnn"]
    jcosts, tcosts = [], []
    jtr.train(jreader, num_passes=1,
              event_handler=lambda e: jcosts.append(e.cost)
              if hasattr(e, "cost") else None)
    ttr.train(treader, num_passes=1,
              event_handler=lambda e: tcosts.append(e.cost)
              if hasattr(e, "cost") else None)
    np.testing.assert_allclose(tcosts, jcosts, **RUN_TOL)
    _assert_params(ttr, jtr, RUN_TOL)
    jflat = jax.tree_util.tree_leaves(jtr._carried["rnn"])
    tflat = jax.tree_util.tree_leaves(
        {k: v.numpy() for k, v in ttr._carried["rnn"].items()}
        if isinstance(ttr._carried["rnn"], dict)
        else [t.numpy() for t in (ttr._carried["rnn"]
                                  if isinstance(ttr._carried["rnn"], tuple)
                                  else (ttr._carried["rnn"],))])
    assert len(jflat) == len(tflat)
    for got, want in zip(tflat, jflat):
        np.testing.assert_allclose(got, np.asarray(want), **RUN_TOL)
    _, plain = _pair(build, lr=0.1)
    plain_costs = []
    plain.train(treader, num_passes=1,
                event_handler=lambda e: plain_costs.append(e.cost)
                if hasattr(e, "cost") else None)
    assert plain_costs[0] == pytest.approx(tcosts[0], rel=1e-6)
    assert abs(plain_costs[1] - tcosts[1]) > 1e-6

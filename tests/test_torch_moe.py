"""The top-1 MoE FFN and the ``moe`` layer in the port against the JAX
package, on the CPU: the twin of ``tests/test_moe.py``'s single-device
checks (the sharded form waits for the parallel plane).

``moe_ffn`` against JAX's with and without a live mask, at a capacity
that drops tokens and at the token count; the routing gradient flows
through the gates and the experts; capacity clipping; padded tokens claim
no slot; the layer over a padded sequence batch; a training run. Values
rtol 1e-5 / atol 1e-5, gradients rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import dsl as jdsl
from paddle_tpu.core.argument import Argument as JArgument
from paddle_tpu.core.network import Network as JNetwork
from paddle_tpu.parallel.moe import init_moe_params, moe_ffn as jmoe_ffn
from paddle_tpu_torch.config import dsl as tdsl
from paddle_tpu_torch.core.argument import Argument as TArgument
from paddle_tpu_torch.core.network import Network as TNetwork
from paddle_tpu_torch.parallel import moe as tmoe

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
D, H, E, CAP, B = 16, 32, 4, 16, 32


def _setup(seed=0):
    params = {k: np.array(v) for k, v in init_moe_params(
        jax.random.PRNGKey(seed), D, H, E).items()}
    params["b1"] = np.random.default_rng(seed).normal(
        size=(E, H)).astype(np.float32) * 0.1
    params["b2"] = np.random.default_rng(seed + 1).normal(
        size=(E, D)).astype(np.float32) * 0.1
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed + 1), (B, D)))
    return params, x


@pytest.mark.parametrize("cap", [3, CAP, B])
@pytest.mark.parametrize("with_live", [False, True])
def test_moe_ffn_matches_jax(cap, with_live):
    """Forward and every gradient (the gates' through wg too), at a
    capacity that drops tokens and at the token count."""
    params, x = _setup()
    live = (np.arange(B) % 3 != 0).astype(np.float32) if with_live else None
    w = np.random.default_rng(2).normal(size=(B, D)).astype(np.float32)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    ty = tmoe.moe_ffn(tp, tx, cap,
                      None if live is None else torch.from_numpy(live))

    def jf(p, xx):
        return jmoe_ffn(p, xx, cap, None if live is None
                        else jnp.asarray(live))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    np.testing.assert_allclose(ty.detach().numpy(),
                               np.asarray(jax.jit(jf)(jp, x)), **FWD_TOL)
    names = sorted(tp)
    tg = torch.autograd.grad((ty * torch.from_numpy(w)).sum(),
                             [tp[k] for k in names] + [tx])
    gp, gx = jax.jit(jax.grad(lambda p, xx: jnp.sum(jf(p, xx) * w),
                              argnums=(0, 1)))(jp, jnp.asarray(x))
    for n, g, want in zip(names + ["x"], tg, [gp[k] for k in names] + [gx]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **GRAD_TOL,
                                   err_msg=n)
    if cap == 3:
        kept = np.any(ty.detach().numpy() != 0, axis=-1)
        assert kept.sum() < B   # tokens were dropped


def test_moe_gradients_flow_and_train():
    params, x = _setup()
    y_target = np.array(jax.random.normal(jax.random.PRNGKey(2), (B, D)))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}

    def loss(p):
        return ((tmoe.moe_ffn(p, torch.from_numpy(x), CAP)
                 - torch.from_numpy(y_target)) ** 2).mean()
    l0 = loss(tp)
    grads = dict(zip(sorted(tp), torch.autograd.grad(
        l0, [tp[k] for k in sorted(tp)])))
    assert grads["wg"].abs().sum() > 0       # the router learns
    assert grads["w1"].abs().sum() > 0       # the experts learn
    p2 = {k: (tp[k] - 0.1 * grads[k]).detach() for k in tp}
    assert loss(p2) < l0


def test_capacity_clipping_is_effective():
    params, _ = _setup()
    params["wg"] = params["wg"] * 0.0 + np.eye(D, E, dtype=np.float32) * 100
    y = tmoe.moe_ffn({k: torch.from_numpy(v) for k, v in params.items()},
                     torch.ones(B, D), capacity=4)
    assert int(torch.any(y != 0, dim=-1).sum()) == 4


def test_masked_tokens_claim_no_capacity():
    """Live tokens' outputs are the same whatever padding precedes them;
    dead rows give zeros."""
    params, _ = _setup()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(2), (8, D))))
    y_ref = tmoe.moe_ffn(tp, x, 3, live=torch.ones(8))
    pad = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(3), (24, D))))
    live = torch.cat([torch.zeros(24), torch.ones(8)])
    y_pad = tmoe.moe_ffn(tp, torch.cat([pad, x]), 3, live=live)
    torch.testing.assert_close(y_pad[24:], y_ref, rtol=1e-6, atol=1e-6)
    assert not torch.any(y_pad[:24])


def _moe_net(dsl, capacity):
    x = dsl.data(name="x", size=D, is_sequence=True)
    return dsl.moe(input=x, expert_hidden=H, num_experts=E,
                   capacity=capacity, name="mx")


@pytest.mark.parametrize("capacity", [None, 6])
def test_moe_layer_matches_jax_on_a_padded_sequence(capacity):
    """The layer over [B, T, D] with padded rows: output, mask and every
    gradient as JAX's; the live outputs unchanged by more padding."""
    rng = np.random.default_rng(4)
    v = rng.normal(size=(3, 5, D)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]],
                    np.float32)
    outs = []
    for dsl, Net in ((jdsl, JNetwork), (tdsl, TNetwork)):
        dsl.reset()
        _moe_net(dsl, capacity)
        outs.append(Net(dsl.current_graph(), outputs=["mx"]))
    jnet, tnet = outs
    params = {k: (rng.normal(size=s.shape) * 0.3).astype(np.float32)
              for k, s in sorted(jnet.param_specs.items())}
    w = rng.normal(size=v.shape).astype(np.float32)
    tp = {k: torch.from_numpy(p.copy()).requires_grad_()
          for k, p in params.items()}
    tx = torch.from_numpy(v.copy()).requires_grad_()
    ty = tnet.apply(tp, {"x": TArgument(tx, torch.from_numpy(mask))})["mx"]

    def jf(p, xx):
        return jnet.apply(p, {"x": JArgument(xx, jnp.asarray(mask))})[
            "mx"].value
    jp = {k: jnp.asarray(p) for k, p in params.items()}
    np.testing.assert_allclose(ty.value.detach().numpy(),
                               np.asarray(jf(jp, v)), **FWD_TOL)
    np.testing.assert_array_equal(ty.mask.numpy(), mask)
    names = sorted(tp)
    tg = torch.autograd.grad((ty.value * torch.from_numpy(w)).sum(),
                             [tp[k] for k in names] + [tx])
    gp, gx = jax.grad(lambda p, xx: jnp.sum(jf(p, xx) * w),
                      argnums=(0, 1))(jp, jnp.asarray(v))
    for n, g, want in zip(names + ["x"], tg, [gp[k] for k in names] + [gx]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **GRAD_TOL,
                                   err_msg=n)
    # re-padded to T = 9 with garbage in the dead tail
    v_long = np.concatenate([v, rng.normal(size=(3, 4, D)).astype(
        np.float32)], axis=1)
    m_long = np.concatenate([mask, np.zeros((3, 4), np.float32)], axis=1)
    y_long = tnet.apply({k: t.detach() for k, t in tp.items()},
                        {"x": TArgument(torch.from_numpy(v_long),
                                        torch.from_numpy(m_long))})["mx"]
    if capacity is not None:    # the default capacity grows with T
        torch.testing.assert_close(y_long.value[:, :5], ty.value.detach(),
                                   rtol=1e-5, atol=1e-5)


def test_moe_layer_trains():
    """``dsl.moe`` in a classifier trains through the port's SGD."""
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.types import dense_vector, integer_value
    from paddle_tpu_torch.optim import Momentum
    from paddle_tpu_torch.trainer.trainer import SGD
    tdsl.reset()
    x = tdsl.data(name="x", size=D)
    lab = tdsl.data(name="label", size=4)
    m = tdsl.moe(input=x, expert_hidden=H, num_experts=E, capacity=CAP,
                 name="mx")
    out = tdsl.fc(input=m, size=4, act="softmax", name="out")
    cost = tdsl.classification_cost(input=out, label=lab)
    rng = np.random.RandomState(0)
    X = rng.randn(64, D).astype(np.float32)
    Y = rng.randint(0, 4, 64)
    feeder = DataFeeder({"x": dense_vector(D), "label": integer_value(4)},
                        device="cpu")
    tr = SGD(cost, update_equation=Momentum(learning_rate=0.1),
             device="cpu")
    costs = []
    tr.train(lambda: iter([[(X[i], int(Y[i])) for i in range(64)]]),
             feeder=feeder, num_passes=4,
             event_handler=lambda e: costs.append(e.cost)
             if hasattr(e, "cost") else None)
    assert costs[-1] < costs[0]

"""Parity of the port's optimizers (``paddle_tpu_torch/optim``) and its
fused-update routing (``kernels/opt_update.py``) with the JAX package, on
the CPU.

Every optimizer of ``_BY_NAME`` runs three ``update`` calls from the same
parameters, gradients and state in both packages, with L1/L2 (global and
per parameter), clipping, a non-constant schedule, a per-parameter lr
multiplier, a static parameter, a prune mask, ``sum_gradients`` and, for
Momentum, the lazy sparse-row path and ``catch_up``. The case table is
closure-enforced against both registries. The port's ``apply_one`` CPU
route is held against the JAX Pallas kernels ``_momentum_fused`` and
``_adam_fused`` in interpret mode.

Tolerance rtol 1e-5 / atol 1e-6: the port computes the learning rate and
Adam's bias correction in float32 on the host, as JAX does on the device,
and the elementwise chains in the same order; what remains is the last
bit of ``pow``, ``sqrt`` and ``rsqrt``, compounded over three steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import ParamSpec as JSpec
from paddle_tpu.kernels import opt_update as j_fused
from paddle_tpu.ops import common
from paddle_tpu.optim import optimizers as jopt
from paddle_tpu_torch.compat.from_jax import opt_state_from_numpy
from paddle_tpu_torch.core.registry import ParamSpec as TSpec
from paddle_tpu_torch.kernels import opt_update as t_fused
from paddle_tpu_torch.optim import optimizers as topt

TOL = dict(rtol=1e-5, atol=1e-6)

_SCHEDULE = dict(learning_rate_schedule="poly", learning_rate_decay_a=0.1,
                 learning_rate_decay_b=0.5)

# optimizer-registry name -> constructor kwargs exercising its knobs
CASES = {
    "momentum": dict(learning_rate=0.1, momentum=0.9,
                     gradient_clipping_threshold=0.4, l2_rate=1e-2,
                     **_SCHEDULE),
    "sgd": dict(learning_rate=0.05, momentum=0.5, l1_rate=1e-3,
                sum_gradients=True),
    "adagrad": dict(learning_rate=0.1, momentum=0.5, l1_rate=1e-3,
                    **_SCHEDULE),
    "adadelta": dict(learning_rate=0.5, rou=0.9, l2_rate=1e-3),
    "rmsprop": dict(learning_rate=0.05, rou=0.9, momentum=0.3,
                    gradient_clipping_threshold=0.5),
    "decayed_adagrad": dict(learning_rate=0.1, rou=0.9,
                            learning_rate_schedule="discexp",
                            learning_rate_decay_a=0.5,
                            learning_rate_decay_b=8.0),
    "adam": dict(learning_rate=0.01, l2_rate=1e-3,
                 gradient_clipping_threshold=0.3, **_SCHEDULE),
    "adamax": dict(learning_rate=0.01, beta1=0.8, sum_gradients=True),
}

# name -> (shape, spec fields): a per-param lr and l2, a sparse table, a
# pruned matrix and a static vector
PARAMS = {
    "w": ((5, 4), dict(learning_rate=0.5, l2_rate=2e-3)),
    "emb": ((6, 3), dict(sparse_grad=True)),
    "pruned": ((4, 4), dict(sparsity_ratio=0.5)),
    "static": ((3,), dict(is_static=True)),
    "bias": ((4,), dict(l1_rate=1e-2)),
}


def test_optimizer_cases_cover_both_registries():
    """Closure: every optimizer either package can build has a parity case,
    and the two registries name the same optimizers."""
    assert sorted(topt._BY_NAME) == sorted(jopt._BY_NAME)
    missing = sorted(set(topt._BY_NAME) - set(CASES))
    assert not missing, f"optimizers {missing} have no parity case"
    stale = sorted(set(CASES) - set(topt._BY_NAME))
    assert not stale, f"parity cases for unregistered optimizers: {stale}"


def _np_params(seed):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=shape).astype(np.float32)
            for n, (shape, _) in PARAMS.items()}


def _np_grads(seed, step):
    rng = np.random.default_rng(seed * 10 + step)
    grads = {n: rng.normal(size=shape).astype(np.float32)
             for n, (shape, _) in PARAMS.items()}
    # the sparse table: only some rows touched, different ones each step
    grads["emb"][[(step + k) % 6 for k in range(3)]] = 0.0
    return grads


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {str(i): _to_np(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def _assert_tree_close(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), **TOL,
                               err_msg=path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_three_updates_match_jax(name):
    kwargs = CASES[name]
    jo = jopt.create_optimizer(name, **kwargs)
    to = topt.create_optimizer(name, **kwargs)
    jmeta = {n: JSpec(shape=s, **f) for n, (s, f) in PARAMS.items()}
    tmeta = {n: TSpec(shape=s, **f) for n, (s, f) in PARAMS.items()}
    np_params = _np_params(7)
    jparams = {n: jnp.asarray(v) for n, v in np_params.items()}
    tparams = {n: torch.from_numpy(v.copy()) for n, v in np_params.items()}
    jstate = jo.init(jparams, jmeta)
    tstate = to.init(tparams, tmeta)
    jparams = jo.prune_params(jparams, jstate)
    tparams = to.prune_params(tparams, tstate)
    _assert_tree_close(_to_np(tstate), _to_np(jstate))
    for step, (bsz, pass_id) in enumerate([(4, 0), (3, 0), (5, 1)]):
        grads = _np_grads(11, step)
        jparams, jstate = jo.update(
            {n: jnp.asarray(g) for n, g in grads.items()}, jstate, jparams,
            jmeta, batch_size=bsz, num_passes=pass_id)
        tparams, tstate = to.update(
            {n: torch.from_numpy(g) for n, g in grads.items()}, tstate,
            tparams, tmeta, batch_size=bsz, num_passes=pass_id)
        _assert_tree_close(_to_np(tparams), _to_np(jparams), f"step{step}")
        _assert_tree_close(_to_np(tstate), _to_np(jstate), f"step{step}")
    np.testing.assert_array_equal(tparams["static"], np_params["static"])
    assert (tparams["pruned"].numpy()[tstate["slots"]["pruned"]["prune_mask"]
                                      .numpy() == 0] == 0).all()
    # deferred sparse rows (Momentum only) caught up at pass end
    jparams, jstate = jo.catch_up(jparams, jstate, jmeta, num_passes=1)
    tparams, tstate = to.catch_up(tparams, tstate, tmeta, num_passes=1)
    _assert_tree_close(_to_np(tparams), _to_np(jparams), "catch_up")
    _assert_tree_close(_to_np(tstate), _to_np(jstate), "catch_up")
    if isinstance(to, topt.Momentum):
        assert "t_rows" in tstate["slots"]["emb"]


def test_opt_state_from_numpy_resumes_a_jax_state():
    """A JAX optimizer state carried across mid-run continues the same
    trajectory in the port."""
    jo = jopt.Adam(learning_rate=0.01, average_window=0.5)
    to = topt.Adam(learning_rate=0.01, average_window=0.5)
    np_params = _np_params(3)
    jparams = {n: jnp.asarray(v) for n, v in np_params.items()}
    jstate = jo.init(jparams)
    jparams, jstate = jo.update(
        {n: jnp.asarray(g) for n, g in _np_grads(3, 0).items()}, jstate,
        jparams, batch_size=2)
    tparams = {n: torch.from_numpy(np.array(v)) for n, v in jparams.items()}
    tstate = opt_state_from_numpy(_to_np(jstate), device="cpu")
    assert tstate["t"] == 1 and tstate["num_samples"] == 2.0
    grads = _np_grads(3, 1)
    jparams, jstate = jo.update({n: jnp.asarray(g) for n, g in grads.items()},
                                jstate, jparams, batch_size=2)
    tparams, tstate = to.update({n: torch.from_numpy(g) for n, g in
                                 grads.items()}, tstate, tparams,
                                batch_size=2)
    _assert_tree_close(_to_np(tparams), _to_np(jparams))
    _assert_tree_close(_to_np(tstate), _to_np(jstate))
    _assert_tree_close(_to_np(to.averaged_params(tstate, tparams)),
                       _to_np(jo.averaged_params(jstate, jparams)))


@pytest.mark.parametrize("shape", [(1,), (7,), (33, 31)])
def test_fused_route_matches_jax_pallas_kernels(shape):
    """The port's ``apply_one`` on CPU tensors (its plain route) against
    the JAX Pallas kernels in interpret mode, for Momentum and Adam."""
    rng = np.random.default_rng(sum(shape))
    p, g, m, v = (rng.normal(size=shape).astype(np.float32)
                  for _ in range(4))
    v = np.abs(v)
    lr, decay, t = 0.05, 1e-3, 3
    with common.force_mode("interpret"):
        jp, js = j_fused._momentum_fused(*map(jnp.asarray, (p, g, m)), lr,
                                         0.9, decay)
    tp, ts = t_fused.apply_one(topt.Momentum(momentum=0.9),
                               *map(torch.from_numpy, (p, g)),
                               {"mom": torch.from_numpy(m)}, lr, decay, t)
    _assert_tree_close(_to_np((tp, ts)), _to_np((jp, js)))
    with common.force_mode("interpret"):
        jp, js = j_fused._adam_fused(*map(jnp.asarray, (p, g, m, v)), lr,
                                     jnp.int32(t), 0.9, 0.999, 1e-8, decay)
    before = t_fused.adam.launches
    tp, ts = t_fused.apply_one(topt.Adam(), *map(torch.from_numpy, (p, g)),
                               {"mom": torch.from_numpy(m),
                                "v": torch.from_numpy(v)}, lr, decay, t)
    assert t_fused.adam.launches == before  # CPU tensors: plain version
    _assert_tree_close(_to_np((tp, ts)), _to_np((jp, js)))


def test_kernel_wrappers_use_apply_one_on_cpu():
    """On CPU tensors the kernel wrappers ARE ``opt._apply_one``, the
    plain version the card holds the kernels against."""
    rng = np.random.default_rng(0)
    p, g, m, v = (torch.from_numpy(rng.normal(size=(9,)).astype(np.float32))
                  for _ in range(4))
    v = v.abs()
    mo = topt.Momentum(momentum=0.8)
    got = t_fused.momentum(mo, p, g, {"mom": m}, 0.1, 0.01)
    want = mo._apply_one(p, g, {"mom": m}, 0.1, 0.01, 0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    ad = topt.Adam(beta1=0.8)
    got = t_fused.adam(ad, p, g, {"mom": m, "v": v}, 0.1, 0.01, 4)
    want = ad._apply_one(p, g, {"mom": m, "v": v}, 0.1, 0.01, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

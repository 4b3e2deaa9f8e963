"""The grouped optimizer update of the port (``Optimizer.update`` through
``kernels/opt_update.py:apply_group``, one kernel launch a step on the
card) on the CPU.

(a) ``update`` equals the per-parameter loop it replaced (each parameter's
clipping, l1/l2 resolution, dense ``_apply_one`` or sparse apply, l1
shrink and prune mask, in turn) bit for bit, for Adam, Momentum and
Nesterov Momentum over three steps, on a parameter set with per-parameter
learning rates, l2 and l1 overrides, a prune mask, a static parameter, a
parameter without a gradient, a sparse table, a float64 parameter and a
slot set the kernel does not take; the inputs stay untouched. (b) The same
updates hold the JAX package's ``update`` at ``tests/test_torch_optim.py``'s
tolerance (rtol 1e-5 / atol 1e-6: the last bit of ``pow``, ``sqrt`` and
``rsqrt``, compounded over three steps). (c) The grouped launch's
outputs: fresh contiguous tensors on the 16-byte grid. The kernel's table
(its chunk walk, the split of a long list, float4 by alignment) lives in
``csrc/opt_update.cu`` alone; the card tests in ``test_torch_cuda.py``
hold it, every element of every output written, at sizes 1 to
15,360,000, at offset views and at lists longer than one table.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import ParamSpec as JSpec
from paddle_tpu.optim import optimizers as jopt
from paddle_tpu_torch.core.registry import ParamSpec as TSpec
from paddle_tpu_torch.kernels import opt_update
from paddle_tpu_torch.optim import optimizers as topt

TOL = dict(rtol=1e-5, atol=1e-6)
_F = np.float32

CASES = {
    "adam": ("adam", dict(learning_rate=0.01, l2_rate=1e-3, l1_rate=1e-4,
                          gradient_clipping_threshold=0.3,
                          learning_rate_schedule="poly",
                          learning_rate_decay_a=0.1,
                          learning_rate_decay_b=0.5)),
    "momentum": ("momentum", dict(learning_rate=0.1, momentum=0.9,
                                  l2_rate=1e-2, sum_gradients=True,
                                  gradient_clipping_threshold=0.4)),
    "nesterov": ("momentum", dict(learning_rate=0.05, momentum=0.5,
                                  nesterov=True, l1_rate=1e-3)),
    # the trained paths' own settings: Adam at its defaults
    "adam_default": ("adam", dict(learning_rate=2e-3)),
    # other moments and eps, summed gradients
    "adam_moments": ("adam", dict(learning_rate=0.01, beta1=0.8, beta2=0.99,
                                  epsilon=1e-6, sum_gradients=True)),
    # the l1 shrink after the grouped apply, under a decaying rate
    "momentum_l1": ("momentum", dict(learning_rate=0.1, momentum=0.9,
                                     l1_rate=1e-3,
                                     learning_rate_schedule="exp",
                                     learning_rate_decay_a=0.5,
                                     learning_rate_decay_b=4)),
}

# name -> (shape, spec fields): per-parameter lr and l2, a sparse table, a
# pruned matrix, a static vector, an l1 override, one with a float4 tail
# and a lr multiplier, and one that gets no gradient
PARAMS = {
    "w": ((5, 4), dict(learning_rate=0.5, l2_rate=2e-3)),
    "emb": ((6, 3), dict(sparse_grad=True)),
    "pruned": ((4, 4), dict(sparsity_ratio=0.5)),
    "static": ((3,), dict(is_static=True)),
    "bias": ((4,), dict(l1_rate=1e-2)),
    "wide": ((2, 4099), dict(learning_rate=2.0, l2_rate=0.0)),
    "nograd": ((3, 2), {}),
}
# the port only: a float64 parameter and a slot set with a slot the
# kernel does not take
PORT_ONLY = {"f64": ((3, 3), {}), "extra": ((2, 2), {})}


def _np_params(names, seed=7):
    rng = np.random.default_rng(seed)
    shapes = {**PARAMS, **PORT_ONLY}
    return {n: rng.normal(size=shapes[n][0]).astype(np.float32)
            for n in names}


def _np_grads(names, step, seed=11):
    rng = np.random.default_rng(seed * 10 + step)
    shapes = {**PARAMS, **PORT_ONLY}
    grads = {n: rng.normal(size=shapes[n][0]).astype(np.float32)
             for n in names if n != "nograd"}
    grads["emb"][[(step + k) % 6 for k in range(3)]] = 0.0
    return grads


def _reference_update(opt, grads, state, params, meta, batch_size,
                      num_passes):
    """The per-parameter loop ``update`` ran before the grouped apply:
    each parameter's whole update, ``_apply_one`` on the dense path."""
    t = state["t"] + 1
    num_samples = float(_F(state["num_samples"]) + _F(batch_size))
    lr_t = opt._rate(num_samples, num_passes)
    new_params = dict(params)
    new_slots = {n: s for n, s in state["slots"].items() if n not in grads}
    if opt.sum_gradients:
        grads = {n: g * float(_F(batch_size)) for n, g in grads.items()}
    for name, g in grads.items():
        if name not in state["slots"]:
            new_params[name] = params[name]
            continue
        spec = meta.get(name)
        lr_mult, l2, l1 = opt._rates(spec)
        lr = float(_F(lr_t) * _F(lr_mult))
        if opt.gradient_clipping_threshold > 0:
            th = opt.gradient_clipping_threshold
            g = torch.clamp(g, -th, th)
        slots = state["slots"][name]
        mask = slots.get("prune_mask")
        if opt._is_sparse(spec):
            p_new, s_new = opt._apply_sparse(params[name], g, slots, lr, l1,
                                             l2, t)
        else:
            p_new, s_new = opt._apply_one(params[name], g, slots, lr, l2, t)
            if l1 > 0:
                p_new = topt._shrink(p_new, float(_F(l1) * _F(lr_t)
                                                  * _F(lr_mult)))
        if mask is not None:
            p_new = p_new * mask
            s_new["prune_mask"] = mask
        new_params[name] = p_new
        new_slots[name] = s_new
    return new_params, {"slots": new_slots, "t": t,
                        "num_samples": num_samples}


def _port_setup(case, names):
    name, kwargs = CASES[case]
    opt = topt.create_optimizer(name, **kwargs)
    shapes = {**PARAMS, **PORT_ONLY}
    meta = {n: TSpec(shape=shapes[n][0], **shapes[n][1]) for n in names}
    params = {n: torch.from_numpy(v.copy())
              for n, v in _np_params(names).items()}
    if "f64" in params:
        params["f64"] = params["f64"].double()
    state = opt.init(params, meta)
    if "extra" in state["slots"]:
        state["slots"]["extra"]["accum"] = torch.ones(2, 2)
    return opt, meta, opt.prune_params(params, state), state


def _snapshot(tree):
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _assert_equal_tree(got, want, path=""):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_equal_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, torch.Tensor):
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   msg=lambda m: f"{path}: {m}")
    else:
        assert got == want, path


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_update_equals_the_per_parameter_loop(case):
    names = list(PARAMS) + list(PORT_ONLY)
    opt, meta, params, state = _port_setup(case, names)
    ref_params, ref_state = _snapshot(params), _snapshot(state)
    for step, (bsz, pass_id) in enumerate([(4, 0), (3, 0), (5, 1)]):
        grads = {n: torch.from_numpy(g)
                 for n, g in _np_grads(names, step).items()}
        grads["f64"] = grads["f64"].double()
        ins = (params, state, grads)
        before = _snapshot(ins)
        params, state = opt.update(grads, state, params, meta,
                                   batch_size=bsz, num_passes=pass_id)
        ref_params, ref_state = _reference_update(
            opt, grads, ref_state, ref_params, meta, bsz, pass_id)
        _assert_equal_tree(params, ref_params, f"step{step} params")
        _assert_equal_tree(state, ref_state, f"step{step} state")
        for p in params.values():
            assert p.is_contiguous()
        for got, want in zip(ins, before):  # the inputs are untouched
            _assert_equal_tree(got, want)
    assert state["t"] == 3
    start = _np_params(names)
    for n in ("static", "nograd"):  # no slots; no gradient
        assert torch.equal(params[n], torch.from_numpy(start[n]))
    assert (params["pruned"][state["slots"]["pruned"]["prune_mask"] == 0]
            == 0).all()


def test_inputs_are_untouched():
    names = list(PARAMS)
    opt, meta, params, state = _port_setup("adam", names)
    grads = {n: torch.from_numpy(g) for n, g in _np_grads(names, 0).items()}
    before = _snapshot((params, state, grads))
    new_params, new_state = opt.update(grads, state, params, meta)
    _assert_equal_tree(params, before[0])
    _assert_equal_tree(state, before[1])
    _assert_equal_tree(grads, before[2])
    for n in grads:
        if n in state["slots"]:
            assert new_params[n] is not params[n]
            assert new_params[n].shape == params[n].shape


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_kernel_takes_exactly_the_eligible_dense_updates(case):
    """``groupable`` (the route to the kernel on the card) holds exactly
    for the dense float32 updates of Adam and non-Nesterov Momentum with
    their own slot set."""
    names = list(PARAMS) + list(PORT_ONLY)
    opt, meta, params, state = _port_setup(case, names)
    grads = {n: torch.from_numpy(g) for n, g in _np_grads(names, 0).items()}
    grads["f64"] = grads["f64"].double()
    taken = {n for n in grads if n in state["slots"]
             and not opt._is_sparse(meta[n])
             and opt_update.groupable(opt, params[n], grads[n],
                                      state["slots"][n])}
    want = set() if case == "nesterov" else {"w", "pruned", "bias", "wide"}
    if CASES[case][0] == "adam":
        want.add("emb")  # Adam has no lazy sparse path: a dense update
    assert taken == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_update_matches_jax(case):
    name, kwargs = CASES[case]
    names = list(PARAMS)
    jo = jopt.create_optimizer(name, **kwargs)
    opt, meta, tparams, tstate = _port_setup(case, names)
    jmeta = {n: JSpec(shape=s, **f) for n, (s, f) in PARAMS.items()}
    jparams = {n: jnp.asarray(v) for n, v in _np_params(names).items()}
    jstate = jo.init(jparams, jmeta)
    jparams = jo.prune_params(jparams, jstate)
    for step, (bsz, pass_id) in enumerate([(4, 0), (3, 0), (5, 1)]):
        grads = _np_grads(names, step)
        jparams, jstate = jo.update(
            {n: jnp.asarray(g) for n, g in grads.items()}, jstate, jparams,
            jmeta, batch_size=bsz, num_passes=pass_id)
        tparams, tstate = opt.update(
            {n: torch.from_numpy(g) for n, g in grads.items()}, tstate,
            tparams, meta, batch_size=bsz, num_passes=pass_id)
        for n in names:
            np.testing.assert_allclose(tparams[n].numpy(),
                                       np.asarray(jparams[n]), **TOL,
                                       err_msg=f"step{step} {n}")
            for s, v in tstate["slots"].get(n, {}).items():
                np.testing.assert_allclose(
                    v.numpy(), np.asarray(jstate["slots"][n][s]), **TOL,
                    err_msg=f"step{step} {n}/{s}")


def test_group_outputs_are_fresh_aligned_tensors_of_each_shape():
    """``group_outputs``: per tensor of a list (views among them) its new
    p and slots, fresh contiguous tensors of its p's shape, each on the
    16-byte grid the kernel's float4 moves need."""
    base = [torch.zeros(1028) for _ in range(4)]
    ins = [[t[4:].reshape(32, 32) for t in base],
           [t[1:1025] for t in base],
           [torch.zeros(7) for _ in range(4)]]
    outs = opt_update.group_outputs(ins)
    seen = {t.data_ptr() for row in ins for t in row}
    for row, o in zip(ins, outs):
        assert [t.shape for t in o] == [row[0].shape] * 3
        for t in o:
            assert t.is_contiguous() and t.data_ptr() % 16 == 0
            assert t.data_ptr() not in seen
            seen.add(t.data_ptr())

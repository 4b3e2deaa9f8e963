"""Optimizers with reference v1 semantics, the port of
``paddle_tpu/optim/optimizers.py``.

Update formulas match the fused kernels in
``paddle/math/TrainingAlgorithmOp.cu`` (adadelta ``:43``, adagrad ``:66``,
rmsprop ``:86``, decayed-adagrad ``:117``, adam ``:146``, adamax ``:166``)
and the optimizer classes in ``paddle/parameter/FirstOrderOptimizer.h``.
L2 regularization enters the update as ``decayRate`` exactly as there
(``grad + value*decayRate``); L1 is a post-update shrink
(``OptimizerWithRegularizer``). Per-parameter lr multipliers and static
params mirror ``ParameterConfig.learning_rate`` / ``is_static``.

State is ``{"slots": {name: {slot: tensor}}, "t": int, "num_samples":
float}`` (plus ``"avg"`` under model averaging), the JAX package's tree
with host scalars. The learning rate and every scalar derived from it are
computed in float32 on the host (``np.float32``) and enter the tensor
arithmetic as exact float32 values, so each update takes the same
roundings as the JAX package's. A step's dense elementwise chains route
through ``kernels/opt_update.py:apply_group`` (one launch of the CUDA
kernels on the card for Momentum and Adam).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.registry import ParamSpec
from paddle_tpu_torch.optim.schedules import learning_rate_at

_F = np.float32


def _shrink(p, amount):
    """L1 soft threshold: sign(p) * max(|p| - amount, 0)."""
    return torch.sign(p) * torch.clamp_min(p.abs() - amount, 0.0)


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation quantile of all of ``x`` (``jnp.quantile``'s
    default), in x's dtype, with no size limit."""
    v = x.reshape(-1).sort().values
    pos = q * (v.numel() - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, v.numel() - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclasses.dataclass
class Optimizer:
    """Base: shared hyper-parameters (``OptimizationConfig`` in
    proto/TrainerConfig.proto)."""

    learning_rate: float = 1e-3
    learning_rate_schedule: str = "constant"
    learning_rate_decay_a: float = 0.0
    learning_rate_decay_b: float = 0.0
    learning_rate_args: str = ""
    l1_rate: float = 0.0
    l2_rate: float = 0.0
    gradient_clipping_threshold: float = 0.0
    # model averaging (``AverageOptimizer``): fraction of updates kept in
    # the average (TrainerConfig.proto:74); >= 1 acts as an absolute window
    average_window: float = 0.0
    max_average_window: float = float("inf")
    # reference v1 gradient semantics: parameter grads are the batch SUM
    # (ParameterUpdateFunctions.cpp:25-36); the engine differentiates the
    # batch-MEAN cost, so the update multiplies grads by the live batch
    # size before clipping/decay
    sum_gradients: bool = False

    # -- per-subclass ---------------------------------------------------
    def slot_names(self):
        return []

    def _apply_one(self, p, g, slots, lr, decay, t):
        raise NotImplementedError

    # -- public ---------------------------------------------------------
    def _is_sparse(self, spec) -> bool:
        # the lazy touched-rows path implements the PLAIN momentum
        # recurrence; nesterov's lookahead has no closed-form row catch-up
        return (spec is not None and getattr(spec, "sparse_grad", False)
                and hasattr(self, "_apply_sparse")
                and not getattr(self, "nesterov", False))

    def _rate(self, num_samples, num_passes) -> np.float32:
        return learning_rate_at(
            self.learning_rate_schedule, self.learning_rate,
            self.learning_rate_decay_a, self.learning_rate_decay_b,
            num_samples, args=self.learning_rate_args,
            num_passes=num_passes)

    def _rates(self, spec):
        """(lr multiplier, l2, l1) of one parameter: its spec's overrides,
        else the optimizer's."""
        lr_mult = spec.learning_rate if spec else 1.0
        l2 = spec.l2_rate if spec and spec.l2_rate is not None else self.l2_rate
        l1 = spec.l1_rate if spec and spec.l1_rate is not None else self.l1_rate
        return lr_mult, l2, l1

    def init(self, params: Dict[str, torch.Tensor],
             meta: Optional[Dict[str, ParamSpec]] = None) -> Dict[str, Any]:
        slots = {}
        for name, p in params.items():
            spec = meta.get(name) if meta else None
            if spec is not None and spec.is_static:
                continue
            d = {s: torch.zeros_like(p) for s in self.slot_names()}
            if spec is not None and spec.sparsity_ratio:
                # StaticPruningHook (ParameterUpdaterHook.cpp:39): mask the
                # smallest-|w| fraction at init; update() keeps them zero
                thresh = _quantile(p.abs(), spec.sparsity_ratio)
                d["prune_mask"] = (p.abs() >= thresh).to(p.dtype)
            if self._is_sparse(spec):
                # per-row last-processed step for lazy (touched-rows-only)
                # updates (SparseRowMatrix.h:204, OptimizerWithRegularizer.h)
                d["t_rows"] = torch.zeros((p.shape[0],), dtype=torch.int32,
                                          device=p.device)
            slots[name] = d
        state = {"slots": slots, "t": 0, "num_samples": 0.0}
        if self.average_window > 0:
            state["avg"] = {n: torch.zeros_like(p) for n, p in params.items()
                            if n in slots}
        return state

    def update(self, grads, state, params,
               meta: Optional[Dict[str, ParamSpec]] = None,
               batch_size=1, num_passes=0):
        """(grads, state, params) -> (new_params, new_state). meta carries
        per-param lr multipliers / static flags / l1-l2 overrides;
        ``num_passes`` (current pass id) drives the pass_manual schedule.

        Per parameter as ``paddle_tpu``'s ``_update_param`` (``:111-151``):
        clipping, the l1/l2 resolution, the dense or sparse apply, the l1
        shrink and the prune mask. The step's dense applies go to
        ``kernels/opt_update.py:apply_group`` together (one kernel launch
        on the card); the numbers are those of the per-parameter loop."""
        from paddle_tpu_torch.kernels import opt_update
        t = state["t"] + 1
        num_samples = float(_F(state["num_samples"]) + _F(batch_size))
        lr_t = self._rate(num_samples, num_passes)

        new_params = dict(params)
        # parameters whose gradient is absent this call keep their slots
        new_slots = {n: s for n, s in state["slots"].items()
                     if n not in grads}
        if self.sum_gradients:
            bsz = float(_F(batch_size))
            grads = {n: g * bsz for n, g in grads.items()}
        done, dense, finish = {}, [], []
        for name, g in grads.items():
            if name not in state["slots"]:
                new_params[name] = params[name]
                continue
            spec = meta.get(name) if meta else None
            lr_mult, l2, l1 = self._rates(spec)
            lr = float(_F(lr_t) * _F(lr_mult))
            if self.gradient_clipping_threshold > 0:
                th = self.gradient_clipping_threshold
                g = torch.clamp(g, -th, th)
            slots = state["slots"][name]
            if self._is_sparse(spec):
                # touched-rows-only update with momentum/decay catch-up;
                # l1/l2 handled inside (deferred per-row)
                done[name] = self._apply_sparse(params[name], g, slots, lr,
                                                l1, l2, t)
                shrink = None
            else:
                dense.append((params[name], g, slots, lr, l2))
                shrink = (float(_F(l1) * _F(lr_t) * _F(lr_mult)) if l1 > 0
                          else None)
            finish.append((name, shrink, slots.get("prune_mask")))
        applied = iter(opt_update.apply_group(self, dense, t))
        for name, shrink, mask in finish:
            p_new, slots_new = done[name] if name in done else next(applied)
            if shrink is not None:
                p_new = _shrink(p_new, shrink)
            if mask is not None:
                p_new = p_new * mask          # pruned weights stay zero
                slots_new["prune_mask"] = mask
            new_params[name] = p_new
            new_slots[name] = slots_new

        new_state = {"slots": new_slots, "t": t, "num_samples": num_samples}
        if "avg" in state:
            new_state["avg"] = self._update_avg(state["avg"], t, new_params,
                                                new_slots)
        return new_params, new_state

    def _update_avg(self, avg, t, new_params, new_slots):
        """AverageOptimizer: running average with the growing effective
        window W_t = clip(average_window * t, 1, max_average_window),
        never beyond t (TrainerConfig.proto:70-74, AverageOptimizer.h:83)."""
        tf = _F(t)
        w = np.clip(_F(self.average_window) * tf, _F(1.0),
                    _F(self.max_average_window))
        w = float(np.minimum(tf, w))
        return {n: avg[n] + (new_params[n] - avg[n]) / w for n in new_slots}

    def prune_params(self, params, state):
        """Zero the masked weights before any step runs (the reference's
        StaticPruningHook::init)."""
        out = dict(params)
        for name, slots in state["slots"].items():
            if "prune_mask" in slots and name in out:
                out[name] = out[name] * slots["prune_mask"]
        return out

    def catch_up(self, params, state,
                 meta: Optional[Dict[str, ParamSpec]] = None,
                 num_passes: int = 0):
        """Apply deferred sparse-row updates to ALL rows (the reference's
        ``catchUpWith``), at pass end and before checkpoints, at the current
        learning rate."""
        if not any("t_rows" in s for s in state["slots"].values()):
            return params, state
        lr_t = self._rate(state["num_samples"], num_passes)
        new_params = dict(params)
        new_slots = dict(state["slots"])
        for name, slots in state["slots"].items():
            if "t_rows" not in slots:
                continue
            spec = meta.get(name) if meta else None
            lr_mult, l2, l1 = self._rates(spec)
            p2, s2 = self._sparse_catch_up_one(
                params[name], slots, float(_F(lr_t) * _F(lr_mult)), l1, l2,
                state["t"])
            if "prune_mask" in slots:
                p2 = p2 * slots["prune_mask"]
                s2["prune_mask"] = slots["prune_mask"]
            new_params[name] = p2
            new_slots[name] = s2
        return new_params, {**state, "slots": new_slots}

    def averaged_params(self, state, params):
        """``AverageOptimizer::apply``: the windowed average of each
        learnable parameter for evaluation; the raw values stay in
        ``params``."""
        if "avg" not in state:
            return params
        out = dict(params)
        out.update(state["avg"])
        return out


@dataclasses.dataclass
class Momentum(Optimizer):
    """Classic v1 SGD+momentum (``sgdUpdate``):
    mom = momentum*mom - lr*(grad + decayRate*value); value += mom.
    ``nesterov`` is ``SparseMomentumParameterOptimizer``'s lookahead
    collapsed to its dense equivalent."""

    momentum: float = 0.0
    nesterov: bool = False

    def slot_names(self):
        return ["mom"]

    def _apply_one(self, p, g, slots, lr, decay, t):
        mom = self.momentum * slots["mom"] - lr * (g + decay * p)
        if self.nesterov:
            return p + self.momentum * mom - lr * (g + decay * p), \
                {"mom": mom}
        return p + mom, {"mom": mom}

    # ---------------------------------------------------- sparse (lazy) path
    # Touched-rows-only updates for sparse_grad tables, with closed-form
    # catch-up: for a row with zero grad the dense recurrence is
    # mom *= mu; p += mom, so over k missed steps p += mom*(mu+...+mu^k)
    # and mom *= mu^k, applied when the row is next touched (or at
    # catch_up). Equal to the dense updater when l1=l2=0; with
    # regularization the decay is deferred per row as (1-lr*l2)^k and a
    # k-scaled l1 shrink (OptimizerWithRegularizerSparse).

    def _geo_sum(self, k):
        """mu + mu^2 + ... + mu^k, elementwise over int k."""
        mu = self.momentum
        kf = k.to(torch.float32)
        if mu == 1.0:
            return kf
        if mu == 0.0:
            return torch.zeros_like(kf)
        return mu * (1.0 - torch.pow(mu, kf)) / (1.0 - mu)

    def _catch_up_rows(self, p, mom, lr, l1, l2, k):
        kf = k.to(p.dtype).reshape(k.shape + (1,) * (p.ndim - 1))
        if l2 > 0:
            p = p * torch.pow(float(_F(1.0) - _F(lr) * _F(l2)), kf)
        if l1 > 0:
            p = _shrink(p, float(_F(lr) * _F(l1)) * kf)
        geo = self._geo_sum(k).reshape(kf.shape)
        p = p + mom * geo
        mom = (mom * torch.pow(self.momentum, kf) if self.momentum > 0
               else torch.where(kf > 0, torch.zeros_like(mom), mom))
        return p, mom

    def _apply_sparse(self, p, g, slots, lr, l1, l2, t):
        t_rows = slots["t_rows"]
        touched = (g != 0).reshape(g.shape[0], -1).any(dim=1)
        k = (t - 1) - t_rows  # steps missed before this one
        cp, cmom = self._catch_up_rows(p, slots["mom"], lr, l1, l2, k)
        mom_new = self.momentum * cmom - lr * (g + l2 * cp)
        p_new = cp + mom_new
        if l1 > 0:
            # the live step's shrink (catch-up covered only missed steps)
            p_new = _shrink(p_new, float(_F(lr) * _F(l1)))
        tb = touched.reshape(touched.shape + (1,) * (p.ndim - 1))
        return (torch.where(tb, p_new, p),
                {"mom": torch.where(tb, mom_new, slots["mom"]),
                 "t_rows": torch.where(touched, torch.full_like(t_rows, t),
                                       t_rows)})

    def _sparse_catch_up_one(self, p, slots, lr, l1, l2, t):
        k = t - slots["t_rows"]
        p2, mom2 = self._catch_up_rows(p, slots["mom"], lr, l1, l2, k)
        return p2, {"mom": mom2,
                    "t_rows": torch.full_like(slots["t_rows"], t)}


@dataclasses.dataclass
class AdaGrad(Optimizer):
    """``adagradApply`` (TrainingAlgorithmOp.cu:66)."""

    momentum: float = 0.0
    epsilon: float = 1e-6

    def slot_names(self):
        return ["mom", "accum"]

    def _apply_one(self, p, g, slots, lr, decay, t):
        accum = slots["accum"] + torch.square(g)
        scale = torch.rsqrt(accum + self.epsilon)
        mom = self.momentum * slots["mom"] - lr * scale * (g + decay * p)
        return p + mom, {"mom": mom, "accum": accum}


@dataclasses.dataclass
class AdaDelta(Optimizer):
    """``adadeltaApply`` (TrainingAlgorithmOp.cu:43)."""

    rou: float = 0.95
    epsilon: float = 1e-6
    momentum: float = 0.0

    def slot_names(self):
        return ["mom", "accum", "accum_update"]

    def _apply_one(self, p, g, slots, lr, decay, t):
        accum = self.rou * slots["accum"] + (1 - self.rou) * torch.square(g)
        lr_vec = torch.sqrt((slots["accum_update"] + self.epsilon)
                            / (accum + self.epsilon))
        accum_update = (self.rou * slots["accum_update"]
                        + (1 - self.rou) * torch.square(g * lr_vec))
        mom = self.momentum * slots["mom"] - lr * lr_vec * (g + decay * p)
        return p + mom, {"mom": mom, "accum": accum,
                         "accum_update": accum_update}


@dataclasses.dataclass
class RMSProp(Optimizer):
    """``rmspropApply`` (TrainingAlgorithmOp.cu:86): centered RMSProp with
    mean-subtracted second moment."""

    rou: float = 0.95
    epsilon: float = 1e-6
    momentum: float = 0.0

    def slot_names(self):
        return ["mom", "g", "f"]

    def _apply_one(self, p, g, slots, lr, decay, t):
        acc_g = self.rou * slots["g"] + (1 - self.rou) * torch.square(g)
        acc_f = self.rou * slots["f"] + (1 - self.rou) * g
        scale = torch.rsqrt(acc_g - torch.square(acc_f) + self.epsilon)
        mom = self.momentum * slots["mom"] - lr * scale * (g + decay * p)
        return p + mom, {"mom": mom, "g": acc_g, "f": acc_f}


@dataclasses.dataclass
class DecayedAdaGrad(Optimizer):
    """``decayedAdagradApply`` (TrainingAlgorithmOp.cu:117)."""

    rou: float = 0.95
    epsilon: float = 1e-6
    momentum: float = 0.0

    def slot_names(self):
        return ["mom", "accum"]

    def _apply_one(self, p, g, slots, lr, decay, t):
        accum = self.rou * slots["accum"] + (1 - self.rou) * torch.square(g)
        scale = torch.rsqrt(accum + self.epsilon)
        mom = self.momentum * slots["mom"] - lr * scale * (g + decay * p)
        return p + mom, {"mom": mom, "accum": accum}


@dataclasses.dataclass
class Adam(Optimizer):
    """``adamApply`` (TrainingAlgorithmOp.cu:146). decay enters via grad as
    in ``AdamOptimizer::update`` (FirstOrderOptimizer.h)."""

    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def slot_names(self):
        return ["mom", "v"]

    def alpha(self, lr, t) -> float:
        """The bias-corrected rate lr*sqrt(1-b2^t)/(1-b1^t), in float32
        (``paddle_tpu/kernels/opt_update.py:126``)."""
        tf, one = _F(t), _F(1.0)
        return float(_F(lr) * np.sqrt(one - np.power(_F(self.beta2), tf))
                     / (one - np.power(_F(self.beta1), tf)))

    def _apply_one(self, p, g, slots, lr, decay, t):
        g = g + decay * p
        mom = self.beta1 * slots["mom"] + (1 - self.beta1) * g
        v = self.beta2 * slots["v"] + (1 - self.beta2) * torch.square(g)
        return p - self.alpha(lr, t) * mom / (torch.sqrt(v) + self.epsilon), \
            {"mom": mom, "v": v}


@dataclasses.dataclass
class Adamax(Optimizer):
    """``adamaxApply`` (TrainingAlgorithmOp.cu:166)."""

    beta1: float = 0.9
    beta2: float = 0.999

    def slot_names(self):
        return ["mom", "u"]

    def _apply_one(self, p, g, slots, lr, decay, t):
        g = g + decay * p
        mom = self.beta1 * slots["mom"] + (1 - self.beta1) * g
        u = torch.maximum(self.beta2 * slots["u"], g.abs())
        step = float(_F(lr) / (_F(1.0) - np.power(_F(self.beta1), _F(t))))
        return p - step * mom / torch.clamp_min(u, 1e-12), \
            {"mom": mom, "u": u}


_BY_NAME = {
    "momentum": Momentum, "sgd": Momentum, "adagrad": AdaGrad,
    "adadelta": AdaDelta, "rmsprop": RMSProp,
    "decayed_adagrad": DecayedAdaGrad, "adam": Adam, "adamax": Adamax,
}


def create_optimizer(name: str, **kwargs) -> Optimizer:
    """Factory mirroring ``ParameterOptimizer::create``
    (``paddle/parameter/ParameterOptimizer.cpp``)."""
    if name not in _BY_NAME:
        raise KeyError(f"unknown optimizer {name!r}; have {sorted(_BY_NAME)}")
    return _BY_NAME[name](**kwargs)

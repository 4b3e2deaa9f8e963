"""The training loop, single device: the port of
``paddle_tpu/trainer/trainer.py``'s ``Topology`` and ``SGD``.

One training step is the JAX package's jitted step (``:701-758``) run
eagerly: the forward of the cost's sub-graph with autograd recording, the
batch-mean cost (row-masked when the feeder pads rows), ``torch.autograd
.grad`` for every learnable parameter, and ``Optimizer.update`` with the
live row count as the batch size. On ``cuda`` the LSTM and GRU layers
run their residual recurrence kernels and backward step kernels, the GRU
step of a recurrent group its cell kernel, and the Momentum and Adam
updates their fused kernels. Parameters are plain tensors on
the trainer's device, held in a dict by name (the JAX package's pytree).

Batch norm's moving statistics are static parameters: no gradient, no
optimizer update; the training forward returns their new values, which
the step folds into the parameters after the update, as the JAX step does.
Test and forward runs read them (``train=False``).

Config-declared evaluators (``dsl.evaluator``, ``trainer/metrics.py``) are
wired as the JAX trainer wires them: the executed sub-graph grows to the
layers they read (such as a CRF decode branch off the loss path), each
batch fetches those layers' outputs (with a decoded-ids view where the
layer carries one), and the host evaluators see the live rows only.

Not ported: the mesh, ZeRO-1, FSDP and pipeline planes, gradient
accumulation, ``prev_batch_state``, the health plane, bf16 compute, async
prefetch, the auto-resume ``Checkpointer`` and the evaluator types of
``paddle_tpu/trainer/metrics.py`` other than ``chunk`` and ``sum``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.config import dsl as _dsl
from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.network import Network
from paddle_tpu_torch.data.feeder import ROW_MASK_KEY
from paddle_tpu_torch.optim.optimizers import Optimizer
from paddle_tpu_torch.trainer import events as ev
from paddle_tpu_torch.trainer import metrics as _metrics
from paddle_tpu_torch.trainer.evaluators import (Accumulator,
                                                 classification_error)

logger = logging.getLogger("paddle_tpu_torch.trainer")

_CLASSIFICATION_COSTS = {"multi-class-cross-entropy"}


def _param(v, device) -> torch.Tensor:
    """A parameter (tensor, or array as numpy or the JAX package gives it)
    as a float32 tensor on ``device``."""
    t = v.detach() if isinstance(v, torch.Tensor) else torch.tensor(
        np.asarray(v, dtype=np.float32))
    return t.to(device=device, dtype=torch.float32)


def _eval_view(arg: Argument) -> tuple:
    """(value, mask) of a layer an evaluator reads, plus (ids, ids_mask)
    where the layer carries a decoded-ids view (crf_decoding with a
    label)."""
    view = (arg.value, arg.mask)
    if isinstance(arg.state, dict) and "ids" in arg.state:
        view += (arg.state["ids"], arg.state.get("ids_mask"))
    return view


class Topology:
    """cost LayerOutput(s) -> executable Network (``python/paddle/v2/
    topology.py:44``). ``cost`` may be a list: multi-task configs train on
    the SUM of their cost layers."""

    def __init__(self, cost, extra_outputs: Optional[List] = None,
                 graph=None):
        costs = list(cost) if isinstance(cost, (list, tuple)) else [cost]
        if graph is None:
            graph = getattr(costs[0], "graph", None) or _dsl.current_graph()
        names = [c.name if hasattr(c, "name") else c
                 for c in (costs + list(extra_outputs or []))]
        self.cost_names = names[:len(costs)]
        self.cost_name = names[0]
        graph.output_layer_names = names
        self.network = Network(graph, outputs=names)
        self.graph = graph


class SGD:
    """v2 ``trainer.SGD``: holds topology + parameters + optimizer and runs
    the training loop on one device (``cuda`` unless the caller asks for
    the CPU). ``parameters`` (name -> tensor or array) replace the fresh
    initialisation, which draws from a ``torch.Generator`` seeded by
    ``seed``."""

    def __init__(self, cost, parameters: Optional[Dict[str, Any]] = None,
                 update_equation: Optimizer = None, *,
                 extra_layers: Optional[List] = None, seed: int = 0,
                 device="cuda"):
        if update_equation is None:
            raise ValueError("update_equation (an Optimizer) is required")
        self.topology = (cost if isinstance(cost, Topology)
                         else Topology(cost, extra_outputs=extra_layers))
        self.network = self.topology.network
        graph = self.topology.graph
        self._host_evals = _metrics.build_from_configs(graph.evaluators)
        needed = {n for _, ins, _ in self._host_evals for n in ins
                  if n in graph.layers}
        missing = needed - set(self.network.shape_infos)
        if missing:
            # evaluator inputs off the loss path (a decode branch): extend
            # the executed sub-graph to cover them
            self.network = Network(graph, outputs=list(
                graph.output_layer_names) + sorted(missing))
            self.topology.network = self.network
        self._eval_layers = sorted(needed)
        self.optimizer = update_equation
        self.device = torch.device(device)
        self.meta = self.network.param_meta()
        if parameters is not None:
            self.params = {k: _param(v, self.device)
                           for k, v in parameters.items()}
        else:
            self.params = self.network.init_params(
                torch.Generator().manual_seed(seed), device=self.device)
        self.opt_state = self.optimizer.init(self.params, self.meta)
        # StaticPruningHook: masked weights are zero from step 0
        self.params = self.optimizer.prune_params(self.params,
                                                  self.opt_state)
        # wall seconds of each training step, ending at the host fetch of
        # its cost (which waits for the device)
        self.step_seconds: List[float] = []

    # ---------------------------------------------------- cost and metrics
    @staticmethod
    def _row_mask(feed):
        """[B] f32 row-validity mask the bucketing feeder emits when it
        pads the batch dim; None for unpadded feeds."""
        arg = feed.get(ROW_MASK_KEY) if feed is not None else None
        return arg.value if arg is not None else None

    def _total_cost(self, outputs, row_mask=None):
        """Sum of all cost layers' batch-mean. ``row_mask`` makes batch
        padding exact: dead rows leave the sum and the denominator."""
        total = 0.0
        for n in self.topology.cost_names:
            v = outputs[n].value.to(torch.float32)
            if row_mask is not None:
                rm = row_mask.reshape((-1,) + (1,) * (v.dim() - 1))
                total = total + (v * rm).sum() / torch.clamp_min(
                    row_mask.sum(), 1.0)
            else:
                total = total + v.sum() / v.shape[0]
        return total

    def _metrics(self, outputs, feed):
        cdef = self.topology.graph.layers[self.topology.cost_name]
        row_mask = self._row_mask(feed)
        metrics = {"cost": self._total_cost(outputs, row_mask)}
        if cdef.type in _CLASSIFICATION_COSTS:
            out_l, lab_l = cdef.input_names()[0], cdef.input_names()[1]
            metrics["classification_error"] = classification_error(
                outputs[out_l], outputs[lab_l], row_mask=row_mask)
        if self._eval_layers:
            # the outputs the evaluators read, fetched once per batch
            metrics["eval_outputs"] = {n: _eval_view(outputs[n])
                                       for n in self._eval_layers}
        return metrics

    def _to_device(self, feed: Dict[str, Argument]) -> Dict[str, Argument]:
        def move(t):
            return None if t is None else t.to(self.device)
        return {k: Argument(value=move(a.value), mask=move(a.mask),
                            state=a.state) for k, a in feed.items()}

    def _prepare(self, data, feeder):
        return self._to_device(feeder(data) if feeder is not None else data)

    # ---------------------------------------------------------------- step
    def loss_and_grads(self, feed):
        """(outputs, loss, grads, updates) of one batch from the current
        parameters: the forward with autograd recording, the batch-mean
        cost, its gradient for every non-static parameter (zeros for one
        the cost does not reach, as ``jax.grad`` gives), and the state
        updates of the training forward (batch norm's moving statistics,
        by parameter name, detached)."""
        names = [n for n in self.params
                 if not (n in self.meta and self.meta[n].is_static)]
        leaves = {n: p.detach().requires_grad_(n in names)
                  for n, p in self.params.items()}
        outputs, updates = self.network.apply_with_state(leaves, feed,
                                                         train=True)
        loss = self._total_cost(outputs, self._row_mask(feed))
        found = torch.autograd.grad(loss, [leaves[n] for n in names],
                                    allow_unused=True)
        grads = {n: g if g is not None else torch.zeros_like(leaves[n])
                 for n, g in zip(names, found)}
        return outputs, loss.detach(), grads, updates

    def train_step(self, feed, pass_id: int = 0):
        """One step on a device-placed feed; updates ``params`` and
        ``opt_state`` and returns the batch's metrics (tensors). The state
        updates are folded into ``params`` after the optimizer's update,
        as f32 (``new_params.update(updates)`` in the JAX step)."""
        outputs, loss, grads, updates = self.loss_and_grads(feed)
        row_mask = self._row_mask(feed)
        # LIVE rows drive the lr schedule's sample count, not the padded
        # shape (sum_gradients scaling likewise)
        bsz = (float(row_mask.sum()) if row_mask is not None
               else outputs[self.topology.cost_name].value.shape[0])
        self.params, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self.params, self.meta, batch_size=bsz,
            num_passes=pass_id)
        self.params.update({n: u.to(torch.float32)
                            for n, u in updates.items()})
        with torch.no_grad():
            metrics = self._metrics(
                {k: a.with_value(a.value.detach()) for k, a in
                 outputs.items()}, feed)
        metrics["cost"] = loss
        return metrics

    # ---------------------------------------------------------------- loop
    def train(self, reader, *, feeder=None, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              log_period: int = 0):
        """``reader`` yields minibatches (lists of sample tuples) that
        ``feeder`` converts to Arguments (or feed dicts directly).
        ``log_period`` > 0 logs a ``Pass= Batch= Cost= AvgEval:`` line every
        N batches (the cost windowed, the evaluators cumulative since pass
        start). Deferred sparse-row updates are applied at each pass end,
        before ``EndPass``."""
        event_handler = event_handler or (lambda e: None)
        acc = Accumulator()
        for pass_id in range(num_passes):
            event_handler(ev.BeginPass(pass_id))
            acc.reset()
            self._start_host_evaluators()
            window_cost, window_n = 0.0, 0
            for batch_id, data in enumerate(reader()):
                event_handler(ev.BeginIteration(pass_id, batch_id))
                t0 = time.perf_counter()
                feed = self._prepare(data, feeder)
                metrics = self.train_step(feed, pass_id)
                cost = float(metrics["cost"])  # waits for the device
                self.step_seconds.append(time.perf_counter() - t0)
                evals = self._accumulate(acc, metrics)
                self._feed_host_evaluators(metrics, feed)
                window_cost += cost
                window_n += 1
                if log_period and (batch_id + 1) % log_period == 0:
                    logger.info(
                        "Pass=%d Batch=%d Cost=%.5f AvgEval: %s", pass_id,
                        batch_id + 1, window_cost / window_n,
                        " ".join(f"{k}={v:.5g}" for k, v in
                                 {**evals,
                                  **self.host_eval_values()}.items()))
                    window_cost, window_n = 0.0, 0
                event_handler(ev.EndIteration(pass_id, batch_id, cost,
                                              evals))
            self.params, self.opt_state = self.optimizer.catch_up(
                self.params, self.opt_state, self.meta, num_passes=pass_id)
            event_handler(ev.EndPass(
                pass_id, {**acc.result(), **self.host_eval_values()}))

    def test(self, reader, *, feeder=None) -> ev.TestResult:
        """The cost and evaluators over ``reader``'s batches, no update."""
        acc = Accumulator()
        self._start_host_evaluators()
        total_cost, batches = 0.0, 0
        with torch.no_grad():
            for data in reader():
                feed = self._prepare(data, feeder)
                metrics = self._metrics(
                    self.network.apply(self.params, feed, train=False), feed)
                total_cost += float(metrics["cost"])
                batches += 1
                self._accumulate(acc, metrics)
                self._feed_host_evaluators(metrics, feed)
        return ev.TestResult(0, total_cost / max(batches, 1),
                             {**acc.result(), **self.host_eval_values()})

    @staticmethod
    def _accumulate(acc: Accumulator, metrics) -> Dict[str, float]:
        for k, v in metrics.items():
            if isinstance(v, tuple):
                acc.add(k, *v)
        return acc.result()

    # -------------------------------------------- config-driven evaluators
    def _start_host_evaluators(self):
        for e, _, _ in self._host_evals:
            e.start()

    def _feed_host_evaluators(self, metrics, feed):
        """One batch into the config-declared evaluators. Inputs bind by
        the roles the DSL recorded ([outputs..., label?, weight?]); rows
        the batch bucket padded are cut off first (they sit at the end of
        the batch), so the evaluators see live rows only."""
        outs = metrics.get("eval_outputs")
        if not outs:
            return
        host = {k: tuple(None if v is None else v.cpu().numpy() for v in tup)
                for k, tup in outs.items()}
        row_mask = self._row_mask(feed)
        if row_mask is not None:
            n_live = int(row_mask.sum())
            host = {k: tuple(None if v is None else v[:n_live] for v in tup)
                    for k, tup in host.items()}
        for e, ins, roles in self._host_evals:
            if not ins or ins[0] not in host:
                continue
            vals = [host[n][0] if n in host else None for n in ins]
            rest = vals[roles.get("n_outputs", 1):]
            kwargs = {"mask": host[ins[0]][1]}
            if getattr(e, "wants_ids", False) and len(host[ins[0]]) > 2:
                # the decoded path, not the error indicator (ChunkEvaluator
                # reads output_.ids in the reference)
                vals[0] = host[ins[0]][2]
                kwargs["mask"] = host[ins[0]][3]
            if roles.get("has_label") and rest:
                kwargs["label"] = rest.pop(0)
            if roles.get("has_weight") and rest:
                kwargs["weight"] = rest.pop(0)
            e.eval_batch(vals[0], **kwargs)

    def host_eval_values(self) -> Dict[str, float]:
        return {e.name: e.value() for e, _, _ in self._host_evals}

    # --------------------------------------------------------------- state
    def load_state(self, params: Dict[str, Any], opt_flat=None):
        """Install restored parameters (name -> array or tensor) and,
        optionally, a flat optimizer state as ``checkpoint.load_params``
        returns it (``slots/<name>/<slot>``, ``t``, ``num_samples``).
        Entries of the current state the file lacks are kept."""
        missing = sorted(set(self.params) - set(params))
        unknown = sorted(set(params) - set(self.params))
        if missing or unknown:
            raise ValueError(
                "restored checkpoint does not match the model's parameters"
                + (f"; missing: {missing}" if missing else "")
                + (f"; unknown: {unknown}" if unknown else ""))
        self.params = {k: _param(v, self.device) for k, v in params.items()}
        if not opt_flat:
            return

        def restore(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: restore(v, f"{prefix}{k}/")
                        for k, v in tree.items()}
            new = opt_flat.get(prefix.rstrip("/"))
            if new is None:
                return tree
            if isinstance(tree, torch.Tensor):
                return torch.tensor(np.asarray(new)).to(device=tree.device,
                                                        dtype=tree.dtype)
            return type(tree)(np.asarray(new))

        self.opt_state = restore(self.opt_state)

    # ------------------------------------------------------------ forward
    def forward(self, feed, output_names: Optional[List[str]] = None):
        with torch.no_grad():
            outputs = self.network.apply(self.params, self._to_device(feed),
                                         train=False)
        if output_names is None:
            return outputs
        return {n: outputs[n] for n in output_names}

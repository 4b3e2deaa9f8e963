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

Training-mode dropout draws its keep masks from the step's seed
(``core/network.py:_dropout_mask``); the trainer owns the step stream, a
``torch.Generator`` seeded by ``seed + 1`` that gives one seed a batch
(JAX splits ``_rng`` once a batch). ``grad_accum_steps`` runs k
microbatches of a batch, each with its own forward, backward and seed,
sums their gradients in float32 (full-batch denominators in each partial
loss) and runs the optimizer once. ``prev_batch_state`` threads each
forward recurrent layer's final state into the next batch, detached
(truncated BPTT). ``train(async_load_data=True)`` prepares batches in a
background thread (``data/prefetch.py``); ``train(checkpointer=...)``
saves on the ``Checkpointer``'s cadence and resumes exactly: parameters,
optimizer slots and counters, the step generator, the carried state and
the data position.

Mixed precision (``compute_dtype="bfloat16"``, JAX ``_cast_compute`` /
``_cast_f32``): the master parameters and the optimizer state stay f32;
each forward (training, test, ``forward``, ``layer_stats``) runs on bf16
casts of the f32 parameters and of the feed's f32 values, made inside the
differentiated function, so the gradients on the f32 leaves come back f32.
Integer ids keep their dtype and every mask stays f32 (``ROW_MASK_KEY`` by
key; a mask below f32 raises ``MaskDtypeError``). State updates and the
carried state are widened back to f32.

Not ported: the mesh, ZeRO-1, FSDP and pipeline planes and the health
plane.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.config import dsl as _dsl
from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.network import Network, fold_seed
from paddle_tpu_torch.data.feeder import ROW_MASK_KEY
from paddle_tpu_torch.optim.optimizers import Optimizer
from paddle_tpu_torch.testing import chaos as _chaos
from paddle_tpu_torch.trainer import events as ev
from paddle_tpu_torch.trainer import metrics as _metrics
from paddle_tpu_torch.trainer.checkpoint import unflatten_state
from paddle_tpu_torch.trainer.evaluators import (Accumulator,
                                                 classification_error)
from paddle_tpu_torch.utils.masks import assert_mask_f32

logger = logging.getLogger("paddle_tpu_torch.trainer")

_CLASSIFICATION_COSTS = {"multi-class-cross-entropy"}
# the layers whose final state crosses a batch boundary under
# prev_batch_state (JAX ``_carry_layers``)
_CARRY_TYPES = ("lstmemory", "gated_recurrent", "recurrent",
                "recurrent_layer_group")
_BATCH_STAT_TYPES = ("batch_norm", "cudnn_batch_norm", "batch_normalization")
_END_OF_PASS = object()


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


def _map_tensors(fn, tree):
    """``fn`` over every tensor of a nest of dicts and tuples."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map_tensors(fn, v) for v in tree)
    return fn(tree)


def compute_dtype_of(name) -> Optional[torch.dtype]:
    """The trainer's compute dtype from ``--compute_dtype`` (a name or a
    torch dtype): None for float32 or None (no casting), else the dtype."""
    if name is None:
        return None
    dt = name if isinstance(name, torch.dtype) else getattr(torch, str(name))
    if not dt.is_floating_point:
        raise ValueError(f"compute_dtype must be a floating dtype, got {name}")
    return None if dt == torch.float32 else dt


def _host(t):
    """A tensor for numpy: bf16 widened to f32 (exactly)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _first_tensor(tree):
    if isinstance(tree, dict):
        return _first_tensor(next(iter(tree.values())))
    if isinstance(tree, (tuple, list)):
        return _first_tensor(tree[0])
    return tree


def _batch_rows(feed) -> int:
    return next(a.value.shape[0] for a in feed.values()
                if isinstance(a, Argument))


def _split_feed(feed, k: int) -> List[Dict[str, Argument]]:
    """The k microbatches of a feed: rows [i B/k, (i+1) B/k) of every
    entry (JAX ``_split_microbatches``' reshape to (k, B/k, ...))."""
    micro = [{} for _ in range(k)]
    for name, a in feed.items():
        if a.value.dim() == 0 or a.value.shape[0] % k:
            raise ValueError(
                f"grad_accum_steps={k} must divide the batch dim of every "
                f"feed entry; got shape {tuple(a.value.shape)} for {name!r}")
        vals = a.value.chunk(k)
        masks = a.mask.chunk(k) if a.mask is not None else [None] * k
        starts = (a.sub_starts_mask.chunk(k)
                  if a.sub_starts_mask is not None else [None] * k)
        for i in range(k):
            micro[i][name] = Argument(value=vals[i], mask=masks[i],
                                      sub_starts_mask=starts[i],
                                      state=a.state)
    return micro


def _arg_abs_stats(a: Argument):
    """(mean |value|, max |value|) of one layer output, padded positions
    excluded from both (JAX ``_arg_abs_stats``)."""
    v = a.value.detach().abs().to(torch.float32)
    if a.mask is not None and v.dim() >= 2 \
            and tuple(a.mask.shape) == tuple(v.shape[:a.mask.dim()]):
        m = a.mask.reshape(tuple(a.mask.shape)
                           + (1,) * (v.dim() - a.mask.dim()))
        n = torch.clamp_min(a.mask.sum(), 1.0) * (
            v.numel() / max(1, a.mask.numel()))
        return float((v * m).sum() / n), float((v * m).max())
    return float(v.mean()), float(v.max())


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
    ``seed``; the step stream (dropout's seeds) is a generator seeded by
    ``seed + 1``. ``prev_batch_state``: truncated BPTT across batches
    (``--prev_batch_state``). ``compute_dtype``: mixed precision
    (``--compute_dtype bfloat16``; see the module note)."""

    def __init__(self, cost, parameters: Optional[Dict[str, Any]] = None,
                 update_equation: Optimizer = None, *,
                 extra_layers: Optional[List] = None, seed: int = 0,
                 device="cuda", prev_batch_state: bool = False,
                 compute_dtype=None):
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
        # gradient_printer: d cost / d (a layer's output) of the batch
        # being stepped, from the step's own backward
        self._grad_watch = sorted({
            n for e, ins, _ in self._host_evals
            if getattr(e, "wants_grad", False) for n in ins
            if n in self.network.shape_infos})
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
        # the step stream: one seed a batch, saved in every checkpoint
        self._rng = torch.Generator().manual_seed(seed + 1)
        self.grad_accum_steps = 1
        self._accum_shape_seen = False
        self.prev_batch_state = prev_batch_state
        self._carry_layers = [
            name for name, ld in graph.layers.items()
            if ld.type in _CARRY_TYPES
            and not (ld.attrs.get("reversed") or ld.attrs.get("reverse"))
            and name in self.network.order] if prev_batch_state else []
        self._carried = None  # {layer: final state}, threaded over batches
        self.compute_dtype = compute_dtype_of(compute_dtype)
        # wall seconds of each training step (from the prepared batch to
        # the host fetch of its cost, which waits for the device), and the
        # seconds the loop waited for the batch before it
        self.step_seconds: List[float] = []
        self.data_wait_seconds: List[float] = []

    # --------------------------------------------------- mixed precision
    def _cast_compute(self, tree):
        """The compute-dtype view of parameters or a feed (JAX
        ``_cast_compute``): every float32 tensor cast, other dtypes kept;
        an Argument's value and state cast, its masks kept f32 (a mask
        below f32 raises ``MaskDtypeError``), nested Arguments in state
        likewise; the row-validity mask exempt by key."""
        if self.compute_dtype is None:
            return tree
        dt = self.compute_dtype
        if isinstance(tree, dict) and ROW_MASK_KEY in tree:
            out = self._cast_compute({k: v for k, v in tree.items()
                                      if k != ROW_MASK_KEY})
            out[ROW_MASK_KEY] = tree[ROW_MASK_KEY]
            return out

        def go(x):
            if isinstance(x, Argument):
                assert_mask_f32(x.mask, "_cast_compute")
                assert_mask_f32(x.sub_starts_mask, "_cast_compute")
                return dataclasses.replace(x, value=go(x.value),
                                           state=go(x.state))
            if isinstance(x, dict):
                return {k: go(v) for k, v in x.items()}
            if isinstance(x, (tuple, list)):
                return type(x)(go(v) for v in x)
            if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
                return x.to(dt)
            return x

        return go(tree)

    def _cast_f32(self, tree):
        """Compute-dtype tensors of a nest widened back to f32 (JAX
        ``_cast_f32``)."""
        if self.compute_dtype is None:
            return tree
        dt = self.compute_dtype
        return _map_tensors(
            lambda t: t.to(torch.float32)
            if isinstance(t, torch.Tensor) and t.dtype == dt else t, tree)

    # ---------------------------------------------------- cost and metrics
    @staticmethod
    def _row_mask(feed):
        """[B] f32 row-validity mask the bucketing feeder emits when it
        pads the batch dim; None for unpadded feeds."""
        arg = feed.get(ROW_MASK_KEY) if feed is not None else None
        return arg.value if arg is not None else None

    def _total_cost(self, outputs, row_mask=None, accum_k=1,
                    total_live=None):
        """Sum of all cost layers' batch-mean. ``row_mask`` makes batch
        padding exact: dead rows leave the sum and the denominator. Under
        accumulation the denominator is the whole batch's (``accum_k``
        times the microbatch's rows, or ``total_live`` live rows), so the
        k partial losses sum to the whole batch's."""
        total = 0.0
        for n in self.topology.cost_names:
            v = outputs[n].value.to(torch.float32)
            if row_mask is not None:
                denom = (total_live if total_live is not None
                         else row_mask.sum())
                rm = row_mask.reshape((-1,) + (1,) * (v.dim() - 1))
                total = total + (v * rm).sum() / torch.clamp_min(
                    torch.as_tensor(denom, dtype=torch.float32), 1.0)
            else:
                total = total + v.sum() / (v.shape[0] * accum_k)
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
        return {k: a.to(self.device) for k, a in feed.items()}

    def _prepare(self, data, feeder):
        return self._to_device(feeder(data) if feeder is not None else data)

    # ---------------------------------------------------------------- step
    def _next_seed(self) -> int:
        """The next batch's seed from the step stream."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._rng))

    def _grads(self, feed, seed=None, carried=None, accum_k=1,
               total_live=None):
        """(outputs, loss, grads, updates, probe grads) of one batch or
        microbatch from the current parameters."""
        names = [n for n in self.params
                 if not (n in self.meta and self.meta[n].is_static)]
        leaves = {n: p.detach().requires_grad_(n in names)
                  for n, p in self.params.items()}
        # the casts inside the differentiated function: the gradients of
        # the f32 leaves come back f32
        outputs, updates = self.network.apply_with_state(
            self._cast_compute(leaves), self._cast_compute(feed), train=True,
            carried=carried, seed=seed)
        updates = self._cast_f32(updates)
        loss = self._total_cost(outputs, self._row_mask(feed), accum_k,
                                total_live)
        watch = [n for n in self._grad_watch
                 if outputs[n].value.requires_grad]
        found = torch.autograd.grad(
            loss, [leaves[n] for n in names]
            + [outputs[n].value for n in watch], allow_unused=True)
        grads = {n: g if g is not None else torch.zeros_like(leaves[n])
                 for n, g in zip(names, found)}
        probes = {n: _host(g.detach()) if g is not None
                  else _host(torch.zeros_like(outputs[n].value))
                  for n, g in zip(watch, found[len(names):])}
        return outputs, loss.detach(), grads, updates, probes

    def loss_and_grads(self, feed, seed: Optional[int] = None):
        """(outputs, loss, grads, updates) of one batch from the current
        parameters: the forward with autograd recording, the batch-mean
        cost, its gradient for every non-static parameter (zeros for one
        the cost does not reach, as ``jax.grad`` gives), and the state
        updates of the training forward (batch norm's moving statistics,
        by parameter name, detached). ``seed``: dropout's step seed."""
        return self._grads(feed, seed)[:4]

    def _accum_k_for(self, batch_size: int) -> int:
        """The accumulation factor for one batch shape (JAX
        ``_accum_k_for``): the first batch shape must be divisible by
        ``grad_accum_steps``; a later one it does not divide (a tail
        batch) takes gcd(k, B) microbatches, with a warning."""
        if batch_size % self.grad_accum_steps == 0:
            self._accum_shape_seen = True
            return self.grad_accum_steps
        if not self._accum_shape_seen:
            raise ValueError(
                f"grad_accum_steps={self.grad_accum_steps} does not divide "
                f"the batch size ({batch_size} rows): pick a k that "
                "divides the reader's batch size (or bucket batches with "
                "DataFeeder batch_buckets)")
        k = math.gcd(self.grad_accum_steps, batch_size)
        logger.warning(
            "grad_accum_steps=%d does not divide this batch's %d rows (a "
            "final partial batch): using %d microbatches for this shape",
            self.grad_accum_steps, batch_size, k)
        return k

    def _carried_for(self, feed):
        """The carried state for this batch: None when the batch size
        changed (the reference's resetState on a shape change)."""
        if self._carried is None:
            return None
        if _first_tensor(self._carried).shape[0] != _batch_rows(feed):
            self._carried = None
        return self._carried

    def _final_states(self, outputs):
        """Each carry layer's final state, detached (truncated BPTT)."""
        graph = self.topology.graph

        def final(n):
            st = outputs[n].state
            # a group's state also holds its extra outputs; only the final
            # carry crosses the batch boundary
            if graph.layers[n].type == "recurrent_layer_group":
                return st["final"]
            return st
        # widened to f32 (exact); the layers take a carried state at their
        # input's dtype
        return {n: self._cast_f32(_map_tensors(lambda t: t.detach(),
                                               final(n)))
                for n in self._carry_layers}

    def train_step(self, feed, pass_id: int = 0,
                   seed: Optional[int] = None):
        """One step on a device-placed feed; updates ``params`` and
        ``opt_state`` (and the carried state under ``prev_batch_state``)
        and returns the batch's metrics (tensors). ``seed``: the step's
        seed (default: the next of the step stream). The state updates
        are folded into ``params`` after the optimizer's update, as f32
        (``new_params.update(updates)`` in the JAX step)."""
        if seed is None:
            seed = self._next_seed()
        B = _batch_rows(feed)
        k = self._accum_k_for(B) if self.grad_accum_steps > 1 else 1
        row_mask = self._row_mask(feed)
        probes = {}
        if k == 1:
            outputs, loss, grads, updates, probes = self._grads(
                feed, seed, self._carried_for(feed))
            if self._carry_layers:
                self._carried = self._final_states(outputs)
            with torch.no_grad():
                metrics = self._metrics(
                    {n: a.with_value(a.value.detach()) for n, a in
                     outputs.items()}, feed)
            metrics["cost"] = loss
            bsz = (float(row_mask.sum()) if row_mask is not None
                   else outputs[self.topology.cost_name].value.shape[0])
        else:
            metrics, grads, updates = self._accum_grads(feed, k, seed)
            bsz = float(row_mask.sum()) if row_mask is not None else B
        # LIVE rows drive the lr schedule's sample count, not the padded
        # shape (sum_gradients scaling likewise)
        self.params, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self.params, self.meta, batch_size=bsz,
            num_passes=pass_id)
        self.params.update({n: u.to(torch.float32)
                            for n, u in updates.items()})
        if probes:
            metrics["probe_grads"] = probes
        return metrics

    def _accum_grads(self, feed, k: int, seed: int):
        """(metrics, grads, updates) of a batch as k microbatches (JAX
        ``accum_step``): one forward and backward each, each with its own
        seed, gradients summed in float32 with the whole batch's
        denominators in each partial loss, batch norm's updates averaged
        over the microbatches."""
        row_mask = self._row_mask(feed)
        total_live = row_mask.sum() if row_mask is not None else None
        grads, updates_k, parts = None, [], []
        for i, mfeed in enumerate(_split_feed(feed, k)):
            outputs, loss, g, updates, _ = self._grads(
                mfeed, fold_seed(seed, i), accum_k=k, total_live=total_live)
            grads = g if grads is None else {
                n: grads[n] + g[n] for n in grads}
            updates_k.append(updates)
            with torch.no_grad():
                m = self._metrics({n: a.with_value(a.value.detach())
                                   for n, a in outputs.items()}, mfeed)
            m["cost"] = loss
            parts.append(m)
        updates = {n: torch.stack([u[n] for u in updates_k]).mean(dim=0)
                   for n in updates_k[0]}
        metrics = {"cost": torch.stack([m["cost"] for m in parts]).sum()}
        for key, val in parts[0].items():
            if isinstance(val, tuple):
                metrics[key] = tuple(sum(float(m[key][j]) for m in parts)
                                     for j in range(len(val)))
            elif key == "eval_outputs":
                # rows back in batch order: the padded rows sit at the end
                metrics[key] = {
                    n: tuple(None if view[j] is None else torch.cat(
                        [m[key][n][j] for m in parts])
                        for j in range(len(view)))
                    for n, view in val.items()}
        return metrics, grads, updates

    # ----------------------------------------------------------- settings
    def _configure_step(self, grad_accum_steps: Optional[int]):
        """``grad_accum_steps`` is sticky: None keeps the last k. k > 1 is
        refused with ``prev_batch_state`` and with a gradient_printer, as
        in the JAX package."""
        if grad_accum_steps is None:
            grad_accum_steps = self.grad_accum_steps
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got "
                             f"{grad_accum_steps}")
        if grad_accum_steps > 1:
            if self._carry_layers:
                raise ValueError(
                    "grad_accum_steps > 1 is incompatible with "
                    "prev_batch_state: truncated-BPTT state cannot carry "
                    "across microbatches of disjoint rows")
            if self._grad_watch:
                raise ValueError(
                    "grad_accum_steps > 1 is incompatible with "
                    "gradient_printer evaluators (per-batch output "
                    "gradients are not accumulated across microbatches)")
            bn = [n for n, ld in self.topology.graph.layers.items()
                  if ld.type in _BATCH_STAT_TYPES]
            if bn:
                logger.warning(
                    "grad_accum_steps > 1 with batch-stat layers %s: each "
                    "microbatch normalizes by its own batch statistics, "
                    "so the step is not exactly the k-times-batch step "
                    "(the moving averages are averaged over the "
                    "microbatches)", bn)
        self.grad_accum_steps = grad_accum_steps

    # --------------------------------------------------- checkpoint state
    def _trainer_state_for_save(self):
        """The exact-resume state beyond parameters and optimizer state:
        the step generator and, mid-pass, the carried BPTT state. The
        schedule's counters ride in the optimizer state; the data
        position in the file name."""
        state = {"torch_rng": self._rng.get_state()}
        if self._carried is not None:
            state["carried"] = self._carried
        return state

    def _restore_trainer_state(self, tstate):
        """The step generator (and the carried state, returned) from a
        restored checkpoint's ``state::`` arrays. A JAX-written file's
        ``rng`` key is not the port's stream and is left alone."""
        rng = tstate.get("torch_rng")
        if rng is not None:
            self._rng.set_state(torch.from_numpy(np.asarray(rng, np.uint8)))
        carried = {k[len("carried/"):]: v for k, v in tstate.items()
                   if k.startswith("carried/")}
        if not carried:
            return None
        return _map_tensors(
            lambda a: torch.from_numpy(np.asarray(a)).to(self.device),
            unflatten_state(carried))

    # ---------------------------------------------------------------- loop
    def train(self, reader, *, feeder=None, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              log_period: int = 0, checkpointer=None, auto_resume=True,
              dot_period: int = 0, show_parameter_stats_period: int = 0,
              show_layer_stat: bool = False, async_load_data: bool = False,
              prefetch_depth: int = 2,
              grad_accum_steps: Optional[int] = None):
        """``reader`` yields minibatches (lists of sample tuples) that
        ``feeder`` converts to Arguments (or feed dicts directly).
        ``log_period`` > 0 logs a ``Pass= Batch= Cost= AvgEval:`` line every
        N batches (the cost windowed, the evaluators cumulative since pass
        start); ``dot_period`` > 0 prints a dot every N batches;
        ``show_parameter_stats_period`` > 0 logs every parameter's mean
        and largest |value| every N batches; ``show_layer_stat`` logs each
        layer output's at every log period. Deferred sparse-row updates
        are applied at each pass end, before ``EndPass``.

        ``checkpointer`` (``dist.checkpoint.Checkpointer``) first restores
        the newest intact generation (unless ``auto_resume=False``) and
        resumes where it was taken: the pass after an end-of-pass save, or
        inside the pass at the saved batch, the reader fast-forwarded past
        the batches already trained (prepared and thrown away); then it
        saves on its cadence at batch and pass ends. The resumed run is
        bitwise the uninterrupted one for a reader that replays the same
        batches. ``async_load_data`` prepares batches in a background
        thread with ``prefetch_depth`` in flight; a reader from
        ``prefetch_reader`` (``is_prefetched``) is consumed as it is.
        ``grad_accum_steps``: k microbatches a batch (sticky)."""
        from paddle_tpu_torch.data.prefetch import PrefetchPipeline
        self._configure_step(grad_accum_steps)
        event_handler = event_handler or (lambda e: None)
        pre_prepared = bool(getattr(reader, "is_prefetched", False))
        if pre_prepared and feeder is not None:
            raise ValueError(
                "feeder would be silently ignored: this reader is already "
                "prefetched; pass the feeder to prefetch_reader(...)")
        start_pass, resume_base, resume_carried = 0, 0, None
        if checkpointer is not None and auto_resume:
            restored = checkpointer.restore()
            if restored is not None:
                r_params, r_opt, meta = restored
                self.load_state(r_params, r_opt)
                carried = self._restore_trainer_state(
                    meta.get("trainer_state") or {})
                pid = int(meta.get("pass_id", -1))
                if meta.get("end_of_pass", meta.get("batch_id", 0) == 0):
                    start_pass = pid + 1
                else:
                    start_pass = pid
                    resume_base = int(meta.get("batch_id", 0))
                    resume_carried = carried
                    logger.warning(
                        "mid-pass resume fast-forwards %d batches of the "
                        "reader: it must replay the same batch order as "
                        "the interrupted run", resume_base)
        acc = Accumulator()
        loop_ok = False
        try:
            for pass_id in range(start_pass, num_passes):
                event_handler(ev.BeginPass(pass_id))
                acc.reset()
                self._start_host_evaluators()
                resuming = pass_id == start_pass and resume_base > 0
                self._carried = resume_carried if resuming else None
                window_cost, window_n = 0.0, 0
                dots_pending = False
                pipe = None
                if async_load_data and not pre_prepared:
                    pipe = PrefetchPipeline(reader, feeder=feeder,
                                            device=self.device,
                                            depth=prefetch_depth)
                    stream = iter(pipe)
                else:
                    stream = iter(reader())
                batch_id = -1
                if resuming:
                    # the already-trained batches: prepared, not trained
                    for _ in range(resume_base):
                        if next(stream, _END_OF_PASS) is _END_OF_PASS:
                            break
                    batch_id = resume_base - 1
                try:
                    while True:
                        t_wait = time.perf_counter()
                        data = next(stream, _END_OF_PASS)
                        if data is _END_OF_PASS:
                            break
                        batch_id += 1
                        event_handler(ev.BeginIteration(pass_id, batch_id))
                        t0 = time.perf_counter()
                        feed = (data if pipe is not None or pre_prepared
                                else self._prepare(data, feeder))
                        metrics = self.train_step(feed, pass_id)
                        cost = float(metrics["cost"])  # waits for the device
                        self.step_seconds.append(time.perf_counter() - t0)
                        self.data_wait_seconds.append(t0 - t_wait)
                        evals = self._accumulate(acc, metrics)
                        self._feed_host_evaluators(metrics, feed)
                        window_cost += cost
                        window_n += 1
                        if dot_period and (batch_id + 1) % dot_period == 0:
                            print(".", end="", flush=True)
                            dots_pending = True
                        stats_due = show_parameter_stats_period and (
                            batch_id + 1) % show_parameter_stats_period == 0
                        log_due = log_period and (batch_id + 1) % log_period == 0
                        if dots_pending and (stats_due or log_due):
                            print(flush=True)
                            dots_pending = False
                        if stats_due:
                            for pname, st in self.parameter_stats().items():
                                logger.info("Param %s: %s", pname, " ".join(
                                    f"{k}={v:.5g}" for k, v in st.items()))
                        if log_due:
                            logger.info(
                                "Pass=%d Batch=%d Cost=%.5f AvgEval: %s",
                                pass_id, batch_id + 1,
                                window_cost / window_n,
                                " ".join(f"{k}={v:.5g}" for k, v in
                                         {**evals, **self.host_eval_values(
                                             include_printers=False)
                                          }.items()))
                            window_cost, window_n = 0.0, 0
                            if show_layer_stat:
                                for lname, st in self.layer_stats(
                                        feed).items():
                                    logger.info(
                                        "Layer %s: avg_abs=%.5g "
                                        "max_abs=%.5g", lname,
                                        st["avg_abs"], st["max_abs"])
                        event_handler(ev.EndIteration(pass_id, batch_id, cost,
                                                      evals))
                        if checkpointer is not None:
                            checkpointer.maybe_save(
                                lambda: self.params, lambda: self.opt_state,
                                pass_id=pass_id, batch_id=batch_id + 1,
                                trainer_state=self._trainer_state_for_save)
                        if _chaos._ACTIVE is not None:
                            # a kill here resumes from the file just saved
                            _chaos._ACTIVE.hit("step_done", pass_id=pass_id,
                                               batch_id=batch_id)
                finally:
                    # the worker must not outlive the pass
                    if pipe is not None:
                        pipe.close()
                    close = getattr(stream, "close", None)
                    if close is not None:
                        close()
                if dots_pending:
                    print(flush=True)
                self.params, self.opt_state = self.optimizer.catch_up(
                    self.params, self.opt_state, self.meta,
                    num_passes=pass_id)
                event_handler(ev.EndPass(
                    pass_id, {**acc.result(), **self.host_eval_values()}))
                if checkpointer is not None:
                    checkpointer.maybe_save(
                        lambda: self.params, lambda: self.opt_state,
                        pass_id=pass_id, end_of_pass=True,
                        trainer_state=self._trainer_state_for_save)
            loop_ok = True
        finally:
            if checkpointer is not None and hasattr(checkpointer, "flush"):
                # every generation queued becomes durable, even when the
                # loop unwinds; an unwinding loop's own error stays the one
                # raised
                try:
                    checkpointer.flush()
                except Exception as err:
                    if loop_ok:
                        raise
                    logger.error("checkpoint flush failed while the "
                                 "training loop was unwinding: %r", err)

    def test(self, reader, *, feeder=None) -> ev.TestResult:
        """The cost and evaluators over ``reader``'s batches, no update."""
        acc = Accumulator()
        self._start_host_evaluators()
        total_cost, batches = 0.0, 0
        with torch.no_grad():
            for data in reader():
                feed = self._prepare(data, feeder)
                metrics = self._metrics(
                    self.network.apply(self._cast_compute(self.params),
                                       self._cast_compute(feed),
                                       train=False), feed)
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
        the roles the DSL recorded ([outputs..., label?, weight?,
        query?]); rows the batch bucket padded are cut off first (they sit
        at the end of the batch), so the evaluators see live rows only.
        A gradient_printer gets d cost / d (its layer's output) from the
        step's backward."""
        outs = metrics.get("eval_outputs")
        if not outs:
            return
        host = {k: tuple(None if v is None else _host(v).cpu().numpy()
                         for v in tup)
                for k, tup in outs.items()}
        row_mask = self._row_mask(feed)
        n_live = None
        if row_mask is not None:
            n_live = int(row_mask.sum())
            host = {k: tuple(None if v is None else v[:n_live] for v in tup)
                    for k, tup in host.items()}
        probes = metrics.get("probe_grads")
        if probes:
            pg = {k: v.cpu().numpy()[:n_live] for k, v in probes.items()}
            for e, ins, _ in self._host_evals:
                if getattr(e, "wants_grad", False) and ins and ins[0] in pg:
                    e.last = pg[ins[0]]
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
            if getattr(e, "wants_grad", False):
                kwargs["grad"] = None  # set from the probes above
            if roles.get("has_label") and rest:
                kwargs["label"] = rest.pop(0)
            if roles.get("has_weight") and rest:
                kwargs["weight"] = rest.pop(0)
            if roles.get("has_query") and rest:
                kwargs["query_id"] = rest.pop(0)
            e.eval_batch(vals[0], **kwargs)

    def host_eval_values(self, include_printers: bool = True
                         ) -> Dict[str, float]:
        return {e.name: e.value() for e, _, _ in self._host_evals
                if include_printers or not e.prints_on_value}

    # -------------------------------------------------------------- stats
    def parameter_stats(self) -> Dict[str, Dict[str, float]]:
        """Each parameter's mean and largest |value| and its size
        (``showParameterStats``, ``TrainerInternal.cpp:186``)."""
        out = {}
        for n, v in self.params.items():
            a = v.detach().abs()
            out[n] = {"avg_abs": float(a.mean()), "max_abs": float(a.max()),
                      "size": int(v.numel())}
        return out

    def layer_stats(self, feed) -> Dict[str, Dict[str, float]]:
        """Each layer output's mean and largest |value| on one batch, the
        padded positions excluded (``--show_layer_stat``)."""
        with torch.no_grad():
            outs = self.network.apply(self._cast_compute(self.params),
                                      self._cast_compute(feed), train=False)
        return {n: dict(zip(("avg_abs", "max_abs"), _arg_abs_stats(a)))
                for n, a in outs.items()
                if isinstance(a.value, torch.Tensor)
                and a.value.is_floating_point() and a.value.numel()}

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
            outputs = self.network.apply(
                self._cast_compute(self.params),
                self._cast_compute(self._to_device(feed)), train=False)
        if output_names is None:
            return outputs
        return {n: outputs[n] for n in output_names}

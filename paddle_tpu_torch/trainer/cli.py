"""Command line of the port: ``--job train|test|time|checkgrad|merge|
serve``, the counterpart of ``paddle_tpu/trainer/cli.py`` (``cmd_train``,
``cmd_test``, ``cmd_time``, ``cmd_checkgrad``, ``cmd_merge``,
``_serving_plan`` / ``cmd_serve``) without the parallel, health, fleet
and bf16-compute flags.

    python -m paddle_tpu_torch.trainer.cli --config conf.py --job train \\
        --save_dir ckpt --num_passes 3 [--device cuda]
    python -m paddle_tpu_torch.trainer.cli --config conf.py --job merge \\
        --save_dir ckpt --model_path m.ptmodel
    python -m paddle_tpu_torch.trainer.cli --config conf.py --job serve \\
        --init_model_path m.ptmodel --max_batch 64 \\
        --serving_length_buckets 32,64,128 --port 8000

``--job merge --quantize bf16|int8`` writes a quantized PTM1 file
(``quant.py``: the golden rows and their fp32 outputs first, then the
weights in their storage dtype; ``--quantize_tol`` overrides the gate's
tolerance); ``--job serve`` of it keeps the weights in their storage dtype
on the device and refuses to become ready past the gate. Training, test
and merge refuse a quantized file as their start.

The config is a Python file that builds its graph with
``paddle_tpu_torch.config.dsl`` and names, as module variables, ``cost``,
``feeding`` (data-layer name -> InputType, or a ``DataFeeder``),
``train_reader``/``test_reader`` and optionally ``optimizer`` (default
``Momentum(learning_rate=0.01, momentum=0.9)``, as in the JAX package)
and ``outputs`` (the layers to merge and serve).

A generating config (``seq2seq_attention(generating=True)``, or any graph
with a ``beam_search`` group) names the group in ``outputs`` and needs no
``cost``: ``--job merge`` writes its graph and parameters (the step
network's and the generated word's embedding, read from a training
checkpoint under the names the training graph gave them), and ``--job
serve`` answers ``POST /v1/generate`` with the config's (beam_size,
max_length); ``--decode_chunk`` sets the early-exit chunk (0 = the full
length-``max_length`` loop); ``--serving_continuous_batching`` admits and
retires requests at chunk boundaries (``DecodeSession``), standing down to
convoy batching, with a warning, for a full-scan policy or a model whose
static inputs change shape across the length buckets (seq2seq's encoded
source: give one bucket). Generation parameters missing from the table
(a fresh initialisation) are filled with small random values and a
warning, as the JAX package does.

``--job train`` prints ``Pass N: cost=...`` with the pass's evaluators
(``classification_error`` for a classification cost, and the config's
own, such as a tagger's ``error=... chunk_f1=...``) at each pass end.
With ``--save_dir`` it saves through ``dist.checkpoint.Checkpointer``
(the JAX package's file format and names,
``checkpoint-p{pass:05d}-b{batch:08d}.npz``) every ``--saving_period``
passes and every ``--saving_period_by_batches`` batches, on a
background writer unless ``--no-background_save``, and first resumes
exactly from the newest intact generation there unless
``--no-auto_resume``. ``--grad_accum_steps K`` splits each batch into K
microbatches, ``--prev_batch_state`` carries the recurrent state across
batches, ``--use_async_load_data`` prepares ``--prefetch_depth`` batches
in a background thread, ``--dot_period``, ``--show_parameter_stats_period``
and ``--show_layer_stat`` print progress and statistics.
``PADDLE_TPU_CHAOS_PLAN`` arms a kill fault (``testing/chaos.py``). It
ends with a ``train_summary {...}`` JSON line: the kernel launch counts of
the training loop, its wall ms per training step and the ms each step
waited for its batch. ``--job time`` times ``--time_batches`` steps after
``--time_warmup`` and prints ``TimeInfo: ...`` and a ``time_summary``
line; ``--job checkgrad`` checks the gradient of one batch against
central differences (``--checkgrad_eps``). ``--init_model_path`` also
takes a directory of v1 parameter files (``Parameter::save``), loaded by
name with a size check. ``--job test`` prints
``Test: cost=...`` and a ``test_summary`` JSON line with the kernel
launch counts of the test pass. ``--job test`` and ``--job merge`` read
``--init_model_path`` (a ``.ptmodel`` or a checkpoint ``.npz``), else the
newest checkpoint of ``--save_dir``; merge writes a PTM1 file to
``--model_path``. Parameters otherwise come from a fresh initialisation
seeded by ``--seed``. Every job runs on ``--device`` (``cuda`` unless the
caller asks for ``cpu``); the server prints one ``serving on
http://host:port`` line when ready, and drains and exits 0 on SIGTERM.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import sys
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.trainer.cli")
    p.add_argument("--config", required=True)
    p.add_argument("--job", required=True,
                   choices=["train", "test", "time", "checkgrad", "merge",
                            "serve"],
                   help="train: the training loop; test: the test reader's "
                        "cost and evaluators; time: steady-state step "
                        "time; checkgrad: one batch's gradient against "
                        "central differences; merge: write a PTM1 model; "
                        "serve: answer /v1/score (and /v1/generate for a "
                        "generating config) over HTTP")
    p.add_argument("--init_model_path", default=None,
                   help="merged model (.ptmodel), checkpoint (.npz) or a "
                        "directory of v1 parameter files to start from; "
                        "serve takes a .ptmodel")
    p.add_argument("--save_dir", default=None,
                   help="checkpoint directory (train) / source (test, "
                        "merge)")
    p.add_argument("--saving_period", type=int, default=1,
                   help="save every N passes")
    p.add_argument("--saving_period_by_batches", type=int, default=None,
                   help="also save every N batches inside a pass")
    p.add_argument("--auto_resume", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="restore the newest intact checkpoint in "
                        "--save_dir before training (exact resume: the "
                        "step generator, data position and schedule "
                        "state included); --no-auto_resume makes "
                        "--save_dir save-only")
    p.add_argument("--background_save", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="write checkpoints on a background thread (the "
                        "tensors are still copied to the host at once, "
                        "so the saved generation is exact)")
    p.add_argument("--grad_accum_steps", type=int, default=1,
                   help="split each batch into k microbatches, one "
                        "backward each, the optimizer once on their "
                        "summed gradient")
    p.add_argument("--prev_batch_state", action="store_true",
                   help="carry the recurrent state across batches "
                        "(truncated BPTT)")
    p.add_argument("--use_async_load_data", action="store_true",
                   help="prepare batches in a background thread and copy "
                        "them to the device ahead of the step")
    p.add_argument("--prefetch_depth", type=int, default=2,
                   help="batches in flight under --use_async_load_data")
    p.add_argument("--dot_period", type=int, default=0,
                   help="print a progress dot every N batches")
    p.add_argument("--show_parameter_stats_period", type=int, default=0,
                   help="log every parameter's mean and largest |value| "
                        "every N batches")
    p.add_argument("--show_layer_stat", action="store_true",
                   help="log each layer output's mean and largest |value| "
                        "at each log_period")
    p.add_argument("--compute_dtype", default=None,
                   choices=["bfloat16", "float32"],
                   help="mixed precision: f32 master parameters and "
                        "optimizer state, the forward and backward in this "
                        "dtype (masks stay f32); float32 = no casting")
    p.add_argument("--time_batches", type=int, default=20,
                   help="--job=time: timed batches after warmup")
    p.add_argument("--time_warmup", type=int, default=3)
    p.add_argument("--checkgrad_eps", type=float, default=1e-3,
                   help="--job=checkgrad finite-difference step")
    p.add_argument("--model_path", default=None,
                   help="output path for --job=merge")
    p.add_argument("--num_passes", type=int, default=1)
    p.add_argument("--log_period", type=int, default=100)
    p.add_argument("--test_period", type=int, default=0,
                   help="run the test reader every N passes during train")
    p.add_argument("--seed", type=int, default=0,
                   help="parameter init seed when no model is given")
    p.add_argument("--device", default="cuda")
    p.add_argument("--port", type=int, default=8000,
                   help="0 = any free port (the ready line names it)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--batch_timeout_ms", type=float, default=5.0,
                   help="coalescing window of the dynamic batcher")
    p.add_argument("--max_batch", type=int, default=32,
                   help="largest coalesced batch; the batch buckets are "
                        "the powers of two up to it")
    p.add_argument("--queue_depth", type=int, default=128,
                   help="bound of the request queue (beyond it: 429)")
    p.add_argument("--serving_length_buckets", default="32,64,128",
                   help="closed menu of padded sequence lengths")
    p.add_argument("--serving_deadline_ms", type=float, default=0,
                   help="default per-request deadline (0 = none)")
    p.add_argument("--decode_chunk", type=int, default=None,
                   help="decoder steps per chunk of the early-exit beam "
                        "search (core/generation.py): it stops at the first "
                        "chunk boundary where every beam finished. 0 = the "
                        "full length-max_length loop; unset = the config's "
                        "pinned policy, else chunks of 8")
    p.add_argument("--serving_continuous_batching", action="store_true",
                   help="--job=serve: continuous batching for generate: a "
                        "fixed-width decode session admits queued requests "
                        "and retires finished ones at every --decode_chunk "
                        "boundary, so one slow request no longer holds its "
                        "batch")
    p.add_argument("--quantize", default=None, choices=["bf16", "int8"],
                   help="--job=merge: quantize the weights into the PTM1 "
                        "file (bf16 storage cast, or int8 per-tensor with "
                        "row-wise scales for sparse tables) with the golden "
                        "rows of the warmup accuracy gate")
    p.add_argument("--quantize_tol", type=float, default=None,
                   help="--job=merge --quantize: the gate's tolerance "
                        "recorded in the file (default per dtype: bf16 "
                        "2e-2, int8 1e-1)")
    return p.parse_args(argv)


def load_config(path: str) -> dict:
    """Execute the config file against a fresh DSL graph; returns its
    namespace."""
    from paddle_tpu_torch.config import dsl
    dsl.reset()
    ns = {"__file__": os.path.abspath(path), "__name__": "__paddle_config__"}
    with open(path) as f:
        code = compile(f.read(), path, "exec")
    exec(code, ns)
    return ns


def _serving_plan(ns, args):
    """(graph, params, output names, feeding, predictor kwargs, engine
    kwargs) from the config and the flags."""
    from paddle_tpu_torch.config import dsl
    feeding = ns.get("feeding")
    if not isinstance(feeding, dict):
        feeding = getattr(feeding, "feeding", None)
    if not isinstance(feeding, dict):
        raise SystemExit("--job=serve needs the config to define "
                         "`feeding` (data-layer name -> InputType)")
    if not ns.get("outputs") and "cost" not in ns:
        raise SystemExit("--job=serve needs the config to define "
                         "`outputs` (the layers to serve)")
    names = _output_names(ns)
    graph = dsl.current_graph()
    max_batch = max(args.max_batch, 1)
    batch_buckets = [1]
    while batch_buckets[-1] < max_batch:
        batch_buckets.append(min(batch_buckets[-1] * 2, max_batch))
    length_buckets = [int(x) for x in filter(
        None, str(args.serving_length_buckets).split(","))]
    # None = the config's pinned decode policy; <= 0 = the full scan
    decode_chunk = args.decode_chunk
    pred_kwargs = dict(
        batch_buckets=batch_buckets, length_buckets=length_buckets,
        gen_decode_chunk=decode_chunk,
        gen_full_scan=(None if decode_chunk is None
                       else decode_chunk <= 0), device=args.device)
    mp = args.init_model_path
    if mp:
        if not mp.endswith(".ptmodel"):
            raise SystemExit(f"--init_model_path {mp}: paddle_tpu_torch "
                             "serves PTM1 merged models (.ptmodel) only")
        from paddle_tpu_torch.trainer.merge_model import (load_merged_ex,
                                                          merged_digest)
        _, params, _, extras = load_merged_ex(mp)
        pred_kwargs["model_hash"] = merged_digest(mp)
        # a quantized file's sections reach the predictor: the storage-
        # dtype load and the warmup gate
        pred_kwargs["quant"] = extras.get("quant")
        pred_kwargs["golden"] = extras.get("golden")
    else:
        from paddle_tpu_torch.core.network import Network
        gen = torch.Generator().manual_seed(args.seed)
        params = Network(graph, outputs=names).init_params(gen,
                                                           device="cpu")
    _ensure_generation_params(graph, params)
    eng_kwargs = dict(max_batch=max_batch,
                      batch_timeout_ms=args.batch_timeout_ms,
                      queue_depth=args.queue_depth,
                      default_deadline_ms=args.serving_deadline_ms or None,
                      continuous_batching=args.serving_continuous_batching)
    return graph, params, names, feeding, pred_kwargs, eng_kwargs


def _ensure_generation_params(graph, params):
    """Fill the parameters a beam search reads that ``params`` lacks (its
    hoisted step parameters, its generated word's embedding) with small
    random values, with a warning: a trainer initialises only what its
    graph reaches, and a generating config served or merged from a fresh
    initialisation would otherwise miss them (JAX
    ``_ensure_generation_params``). A trained model carries them."""
    import numpy as np

    from paddle_tpu_torch.core.generation import generation_params
    from paddle_tpu_torch.core.registry import get_layer_impl
    rng = np.random.RandomState(0)
    needed = dict(generation_params(graph))
    for ldef in graph.layers.values():
        if ldef.type == "beam_search_group":
            for spec in get_layer_impl(ldef.type).params(ldef, []).values():
                needed.setdefault(spec.absolute_name, spec.shape)
    missing = [n for n in needed if n not in params]
    for name in missing:
        params[name] = torch.from_numpy(
            rng.randn(*needed[name]).astype(np.float32) * 0.01)
    if missing:
        logging.getLogger("paddle_tpu_torch.cli").warning(
            "generation parameters %s were not in the loaded or initialised "
            "table; using fresh small random values: load a trained model "
            "for real generation", missing)


def _build_trainer(ns, args):
    from paddle_tpu_torch.optim import Momentum
    from paddle_tpu_torch.trainer.trainer import SGD, Topology
    # a generating config may name its beam search in `outputs` alone
    src = ns.get("cost")
    if src is None and args.job == "merge":
        src = ns.get("outputs")
    if src is None:
        raise SystemExit(f"--job={args.job} needs the config to define "
                         "`cost`" + (" or `outputs`" if args.job == "merge"
                                     else ""))
    topo = src if isinstance(src, Topology) else Topology(src)
    optimizer = ns.get("optimizer") or Momentum(learning_rate=0.01,
                                                momentum=0.9)
    trainer = SGD(cost=topo, update_equation=optimizer, seed=args.seed,
                  device=args.device,
                  prev_batch_state=getattr(args, "prev_batch_state", False),
                  compute_dtype=getattr(args, "compute_dtype", None))
    if args.init_model_path:
        _load_into(trainer, args.init_model_path)
    return trainer


def _load_v1_dir(trainer, path):
    """A directory of v1 parameter files (``Parameter::save``, one file a
    parameter, named after it) into ``trainer`` by name, each file's size
    checked against the parameter's (JAX ``cli._init_params``); missing
    parameters keep their initialisation, with a warning."""
    from paddle_tpu_torch.compat.param_format import load_v1_model_dir
    raw = load_v1_model_dir(path)
    params = dict(trainer.params)
    missing = []
    for name, spec in trainer.meta.items():
        if name not in raw:
            missing.append(name)
            continue
        flat = raw[name]
        want = 1
        for d in spec.shape:
            want *= int(d)
        if flat.size != want:
            raise ValueError(
                f"--init_model_path: parameter {name!r} has {flat.size} "
                f"values, the model needs {want} (shape {spec.shape}; "
                "fused-gate layouts may need repacking)")
        params[name] = torch.from_numpy(flat.reshape(spec.shape))
    if missing:
        logging.getLogger("paddle_tpu_torch.cli").warning(
            "--init_model_path: %d parameters missing in %s (kept "
            "initialized): %s", len(missing), path, missing[:5])
    trainer.load_state(params)


def _load_into(trainer, path):
    """A merged model's parameters, a checkpoint's parameters and
    optimizer state, or a directory of v1 parameter files, into
    ``trainer``. A generating graph also takes the file's embeddings of
    its generated words, which no layer of it owns."""
    from paddle_tpu_torch.core.generation import generation_params
    if os.path.isdir(path):
        _load_v1_dir(trainer, path)
        return
    if path.endswith(".ptmodel"):
        from paddle_tpu_torch.trainer.merge_model import load_merged_ex
        _, params, _, extras = load_merged_ex(path)
        if extras:
            # the JAX package's training load reads such a file through
            # the section-ignoring load_merged and would start from raw
            # storage-dtype leaves; the port refuses instead
            raise SystemExit(f"{path}: a quantized merged model holds "
                             "storage-dtype weights; train, test and merge "
                             "start from an fp32 model or checkpoint (serve "
                             "it with --job serve)")
        state = (params,)
    else:
        from paddle_tpu_torch.trainer.checkpoint import load_params
        state = load_params(path)
    for name in generation_params(trainer.topology.graph):
        if name in state[0] and name not in trainer.params:
            trainer.params[name] = torch.as_tensor(state[0][name])
    trainer.load_state(*state)


def _restore(trainer, args):
    """test/merge: without --init_model_path, the newest checkpoint of
    --save_dir (if any) replaces the fresh parameters."""
    if args.init_model_path or not args.save_dir:
        return
    from paddle_tpu_torch.trainer.checkpoint import latest_checkpoint
    path = latest_checkpoint(args.save_dir)
    if path is not None:
        logging.getLogger("paddle_tpu_torch.cli").info(
            "restored checkpoint %s", path)
        _load_into(trainer, path)


def _feeder(ns, device):
    """The config's feeding as a DataFeeder whose batches land on
    ``device``."""
    from paddle_tpu_torch.data.feeder import DataFeeder
    feeding = ns.get("feeding")
    if isinstance(feeding, dict):
        return DataFeeder(feeding, device=device)
    if not isinstance(feeding, DataFeeder):
        raise SystemExit("the config must define `feeding` (data-layer name "
                         "-> InputType, or a DataFeeder)")
    feeding.device = torch.device(device)
    return feeding


def _output_names(ns):
    outputs = ns.get("outputs")
    if outputs:
        return [o.name if hasattr(o, "name") else o for o in outputs]
    return [ns["cost"].name]


def _evals(evaluator):
    return " ".join(f"{k}={v:.5g}" for k, v in evaluator.items())


def cmd_train(ns, args) -> int:
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.trainer import events as ev
    reader = ns.get("train_reader")
    if reader is None:
        raise SystemExit("config must define `train_reader` for --job=train")
    trainer = _build_trainer(ns, args)
    feeder = _feeder(ns, args.device)
    test_reader = ns.get("test_reader")
    ck = None
    if args.save_dir:
        from paddle_tpu_torch.dist.checkpoint import Checkpointer
        ck = Checkpointer(args.save_dir, saving_period=args.saving_period,
                          saving_period_by_batches=(
                              args.saving_period_by_batches),
                          background=args.background_save)

    def handler(e):
        if isinstance(e, ev.EndPass):
            print(f"Pass {e.pass_id}: " + _evals(
                {"cost": _pass_cost[0] / max(_pass_cost[1], 1),
                 **e.evaluator}), flush=True)
            _pass_cost[:] = [0.0, 0]
            if (test_reader is not None and args.test_period
                    and (e.pass_id + 1) % args.test_period == 0):
                res = trainer.test(test_reader, feeder=feeder)
                print(f"  Test: cost={res.cost:.5g} " + _evals(res.evaluator),
                      flush=True)
        elif isinstance(e, ev.EndIteration):
            _pass_cost[0] += e.cost
            _pass_cost[1] += 1

    _pass_cost = [0.0, 0]
    ops.reset_kernel_counts()  # the summary counts this loop's launches
    try:
        trainer.train(
            reader, feeder=feeder, num_passes=args.num_passes,
            event_handler=handler, log_period=args.log_period,
            checkpointer=ck, auto_resume=args.auto_resume,
            dot_period=args.dot_period,
            show_parameter_stats_period=args.show_parameter_stats_period,
            show_layer_stat=args.show_layer_stat,
            async_load_data=args.use_async_load_data,
            prefetch_depth=args.prefetch_depth,
            grad_accum_steps=args.grad_accum_steps)
    finally:
        if ck is not None:
            ck.close()
    steps_ms = [1e3 * s for s in trainer.step_seconds]
    print("train_summary " + json.dumps({
        "device": str(trainer.device), "steps": len(steps_ms),
        "step_ms": steps_ms,
        "median_step_ms": statistics.median(steps_ms) if steps_ms else None,
        "data_wait_ms": [1e3 * s for s in trainer.data_wait_seconds],
        "save_ms": [1e3 * s for s in ck.save_seconds] if ck else [],
        "kernels": ops.kernel_counts()}), flush=True)
    return 0


def cmd_time(ns, args) -> int:
    """Steady-state step time (``paddle_trainer --job=time``): the first
    ``--time_warmup + --time_batches`` batches of the train reader (read
    again from the start when it runs out), each a training step; the
    batches after the warmup whose shapes equal the first's are timed,
    host clock to the cost's fetch."""
    from paddle_tpu_torch import ops
    trainer = _build_trainer(ns, args)
    reader = ns.get("train_reader")
    if reader is None:
        raise SystemExit("config must define `train_reader` for --job=time")
    feeder = _feeder(ns, args.device)
    want = args.time_warmup + args.time_batches
    batches = []
    while len(batches) < want:
        before = len(batches)
        for data in reader():
            batches.append(data)
            if len(batches) >= want:
                break
        if len(batches) == before:
            break
    if not batches:
        raise SystemExit("train_reader produced no batches")

    def shape_sig(feed):
        return tuple(sorted((k, tuple(a.value.shape))
                            for k, a in feed.items()))

    ops.reset_kernel_counts()
    times, sig0 = [], None
    for i, data in enumerate(batches):
        feed = trainer._prepare(data, feeder)
        sig = shape_sig(feed)
        sig0 = sig0 or sig
        t0 = time.perf_counter()
        float(trainer.train_step(feed)["cost"])  # waits for the device
        dt = time.perf_counter() - t0
        if i >= args.time_warmup and sig == sig0:
            times.append(dt)
    if not times:
        raise SystemExit("no steady-state batches to time (all warmup or "
                         "shape-mismatched)")
    ms = [1e3 * t for t in times]
    print(f"TimeInfo: avg_batch_time={sum(ms) / len(ms):.3f}ms over "
          f"{len(ms)} batches (skipped {args.time_warmup} warmup)",
          flush=True)
    print("time_summary " + json.dumps({
        "device": str(trainer.device), "step_ms": ms,
        "median_step_ms": statistics.median(ms),
        "kernels": ops.kernel_counts()}), flush=True)
    return 0


def cmd_checkgrad(ns, args, *, rtol=5e-2, samples=6) -> int:
    """The gradient of one batch's cost against central differences
    (``Trainer::checkGradient``): for up to ``samples`` entries of every
    learnable parameter, autograd's entry on ``--device`` beside (cost(p +
    eps) - cost(p - eps)) / 2 eps, the costs taken in float64 on the
    CPU's plain path (the reference checks in double; float32 costs would
    put their rounding, about 1e-7 of the cost, over 2 eps), passing
    within ``rtol`` relative. The forward is the test-mode one, as in the
    JAX package."""
    import numpy as np

    from paddle_tpu_torch.core.argument import Argument
    eps = args.checkgrad_eps
    trainer = _build_trainer(ns, args)
    reader = ns.get("train_reader")
    if reader is None:
        raise SystemExit("config must define `train_reader` for "
                         "--job=checkgrad")
    feed = trainer._prepare(next(iter(reader())),
                            _feeder(ns, args.device))
    network, cost_name = trainer.network, trainer.topology.cost_name

    def loss_fn(params, feed):
        out = network.apply(params, feed, train=False)[cost_name].value
        return out.sum() / out.shape[0]

    def host64(t):
        t = t.detach().cpu()
        return t.double() if t.is_floating_point() else t

    names = [n for n in trainer.params
             if not network.param_specs[n].is_static]
    leaves = {n: p.detach().requires_grad_(n in names)
              for n, p in trainer.params.items()}
    analytic = dict(zip(names, torch.autograd.grad(
        loss_fn(leaves, feed), [leaves[n] for n in names],
        allow_unused=True)))
    feed64 = {k: Argument(value=host64(a.value),
                          mask=None if a.mask is None else host64(a.mask))
              for k, a in feed.items()}
    base64 = {k: host64(v) for k, v in trainer.params.items()}
    rng = np.random.RandomState(args.seed)
    worst, failed = 0.0, []
    with torch.no_grad():
        for name in names:
            g = analytic[name]
            flat = base64[name].reshape(-1)
            for idx in rng.choice(flat.numel(), size=min(samples,
                                                         flat.numel()),
                                  replace=False):
                def cost_at(delta):
                    p = flat.clone()
                    p[idx] += delta
                    return float(loss_fn(
                        {**base64, name: p.reshape(base64[name].shape)},
                        feed64))
                num = (cost_at(eps) - cost_at(-eps)) / (2 * eps)
                ana = 0.0 if g is None else float(g.reshape(-1)[idx])
                rel = abs(num - ana) / max(abs(num), abs(ana), 1e-4)
                worst = max(worst, rel)
                if rel > rtol:
                    failed.append((name, int(idx), num, ana))
    for name, idx, num, ana in failed[:10]:
        print(f"FAIL {name}[{idx}]: numeric={num:.6g} analytic={ana:.6g}")
    print(f"checkgrad {'FAILED' if failed else 'PASSED'} "
          f"({len(failed)} mismatches, worst rel err {worst:.3g})",
          flush=True)
    return 1 if failed else 0


def cmd_test(ns, args) -> int:
    from paddle_tpu_torch import ops
    trainer = _build_trainer(ns, args)
    _restore(trainer, args)
    reader = ns.get("test_reader") or ns.get("train_reader")
    if reader is None:
        raise SystemExit("config must define `test_reader` (or "
                         "`train_reader`) for --job=test")
    ops.reset_kernel_counts()  # the summary counts this pass's launches
    res = trainer.test(reader, feeder=_feeder(ns, args.device))
    print(f"Test: cost={res.cost:.5g} " + _evals(res.evaluator), flush=True)
    print("test_summary " + json.dumps({
        "device": str(trainer.device), "kernels": ops.kernel_counts()}),
        flush=True)
    return 0


def cmd_merge(ns, args) -> int:
    from paddle_tpu_torch.trainer.merge_model import merge_model
    trainer = _build_trainer(ns, args)
    _restore(trainer, args)
    out_path = args.model_path or "model.ptmodel"
    graph, names = trainer.topology.graph, _output_names(ns)
    _ensure_generation_params(graph, trainer.params)
    params = trainer.params
    quant_meta = golden = None
    if args.quantize:
        from paddle_tpu_torch import quant as quant_lib
        feeding = ns.get("feeding")
        if not isinstance(feeding, dict):
            feeding = getattr(feeding, "feeding", None)
        if not isinstance(feeding, dict):
            raise SystemExit(
                "--quantize needs the config to define `feeding` "
                "(data-layer name -> InputType) so the golden "
                "warmup-gate set can be recorded with the artifact")
        params = {k: v.detach().cpu().numpy() for k, v in params.items()}
        # the golden references come from the unquantized params: the
        # fp32 side of the warmup gate
        golden = quant_lib.golden_section(graph, params, names, feeding)
        sparse = {name for name, spec in trainer.meta.items()
                  if spec.sparse_grad}
        params, quant_meta = quant_lib.quantize_params(
            params, args.quantize, sparse_names=sparse)
        if args.quantize_tol is not None:
            quant_meta["tol"] = float(args.quantize_tol)
    merge_model(out_path, graph, params, outputs=names, quant=quant_meta,
                golden=golden)
    tag = f" ({args.quantize} quantized)" if args.quantize else ""
    print(f"merged model written to {out_path}{tag}", flush=True)
    return 0


def build_serving_engine(ns, args):
    """One engine from the serving plan (tests and embedders build it
    without entering serve_forever)."""
    from paddle_tpu_torch.serving import ServingEngine, ServingPredictor
    graph, params, names, feeding, pk, ek = _serving_plan(ns, args)
    return ServingEngine(
        ServingPredictor(graph, params, names, feeding, **pk), **ek)


def cmd_serve(ns, args) -> int:
    from paddle_tpu_torch.serving import QuantGateError, serve_forever
    try:
        return serve_forever(build_serving_engine(ns, args), host=args.host,
                             port=args.port)
    except QuantGateError as e:
        # a quantized model that fails its warmup gate never serves
        logging.getLogger("paddle_tpu_torch.cli").error(
            "serving refused: %s", json.dumps(e.to_wire()))
        return 1


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device; "
                             "pass --device cpu to run on the CPU")
        # the f32 reference semantics: no TF32 in matmuls or convolutions,
        # and bf16 products summed in f32 (as JAX's bf16 dots are)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    from paddle_tpu_torch.testing import chaos
    chaos.install_from_env()
    ns = load_config(args.config)
    return {"train": cmd_train, "test": cmd_test, "time": cmd_time,
            "checkgrad": cmd_checkgrad, "merge": cmd_merge,
            "serve": cmd_serve}[args.job](ns, args)


if __name__ == "__main__":
    sys.exit(main())

"""Command line of the port: ``--job train|test|merge|serve``, the
counterpart of ``paddle_tpu/trainer/cli.py`` (``cmd_train``, ``cmd_test``,
``cmd_merge``, ``_serving_plan`` / ``cmd_serve``) without the parallel,
health and quantize flags.

    python -m paddle_tpu_torch.trainer.cli --config conf.py --job train \\
        --save_dir ckpt --num_passes 3 [--device cuda]
    python -m paddle_tpu_torch.trainer.cli --config conf.py --job merge \\
        --save_dir ckpt --model_path m.ptmodel
    python -m paddle_tpu_torch.trainer.cli --config conf.py --job serve \\
        --init_model_path m.ptmodel --max_batch 64 \\
        --serving_length_buckets 32,64,128 --port 8000

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
length-``max_length`` loop). Generation parameters missing from the table
(a fresh initialisation) are filled with small random values and a
warning, as the JAX package does.

``--job train`` prints ``Pass N: cost=...`` with the pass's evaluators
(``classification_error`` for a classification cost, and the config's
own, such as a tagger's ``error=... chunk_f1=...``) at each pass end,
saves ``checkpoint-p{pass:05d}-b00000000.npz`` into ``--save_dir`` (the
JAX package's file format and names), and ends with a
``train_summary {...}`` JSON line: the kernel launch counts of the
training loop and its wall ms per training step; ``--job test`` prints
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

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.trainer.cli")
    p.add_argument("--config", required=True)
    p.add_argument("--job", required=True,
                   choices=["train", "test", "merge", "serve"],
                   help="train: the training loop; test: the test reader's "
                        "cost and evaluators; merge: write a PTM1 model; "
                        "serve: answer /v1/score (and /v1/generate for a "
                        "generating config) over HTTP")
    p.add_argument("--init_model_path", default=None,
                   help="merged model (.ptmodel) or checkpoint (.npz) to "
                        "start from; serve takes a .ptmodel")
    p.add_argument("--save_dir", default=None,
                   help="checkpoint directory (train) / source (test, "
                        "merge)")
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
    pred_kwargs = dict(
        batch_buckets=batch_buckets, length_buckets=length_buckets,
        gen_decode_chunk=args.decode_chunk, device=args.device)
    mp = args.init_model_path
    if mp:
        if not mp.endswith(".ptmodel"):
            raise SystemExit(f"--init_model_path {mp}: paddle_tpu_torch "
                             "serves PTM1 merged models (.ptmodel) only")
        from paddle_tpu_torch.trainer.merge_model import (load_merged_ex,
                                                          merged_digest)
        _, params, _, extras = load_merged_ex(mp)
        if extras:
            raise SystemExit(f"{mp}: quantized merged models are not "
                             "served by paddle_tpu_torch yet")
        pred_kwargs["model_hash"] = merged_digest(mp)
    else:
        from paddle_tpu_torch.core.network import Network
        gen = torch.Generator().manual_seed(args.seed)
        params = Network(graph, outputs=names).init_params(gen,
                                                           device="cpu")
    _ensure_generation_params(graph, params)
    eng_kwargs = dict(max_batch=max_batch,
                      batch_timeout_ms=args.batch_timeout_ms,
                      queue_depth=args.queue_depth,
                      default_deadline_ms=args.serving_deadline_ms or None)
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
                  device=args.device)
    if args.init_model_path:
        _load_into(trainer, args.init_model_path)
    return trainer


def _load_into(trainer, path):
    """A merged model's parameters, or a checkpoint's parameters and
    optimizer state, into ``trainer``. A generating graph also takes the
    file's embeddings of its generated words, which no layer of it owns."""
    from paddle_tpu_torch.core.generation import generation_params
    if path.endswith(".ptmodel"):
        from paddle_tpu_torch.trainer.merge_model import load_merged_ex
        _, params, _, extras = load_merged_ex(path)
        if extras:
            raise SystemExit(f"{path}: quantized merged models are not "
                             "read by paddle_tpu_torch yet")
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
    from paddle_tpu_torch.trainer.checkpoint import save_generation
    reader = ns.get("train_reader")
    if reader is None:
        raise SystemExit("config must define `train_reader` for --job=train")
    trainer = _build_trainer(ns, args)
    feeder = _feeder(ns, args.device)
    test_reader = ns.get("test_reader")

    def handler(e):
        if isinstance(e, ev.EndPass):
            print(f"Pass {e.pass_id}: " + _evals(
                {"cost": _pass_cost[0] / max(_pass_cost[1], 1),
                 **e.evaluator}), flush=True)
            _pass_cost[:] = [0.0, 0]
            if args.save_dir:
                save_generation(args.save_dir, e.pass_id, trainer.params,
                                trainer.opt_state)
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
    trainer.train(reader, feeder=feeder, num_passes=args.num_passes,
                  event_handler=handler, log_period=args.log_period)
    steps_ms = [1e3 * s for s in trainer.step_seconds]
    print("train_summary " + json.dumps({
        "device": str(trainer.device), "steps": len(steps_ms),
        "step_ms": steps_ms,
        "median_step_ms": statistics.median(steps_ms) if steps_ms else None,
        "kernels": ops.kernel_counts()}), flush=True)
    return 0


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
    _ensure_generation_params(trainer.topology.graph, trainer.params)
    merge_model(out_path, trainer.topology.graph, trainer.params,
                outputs=_output_names(ns))
    print(f"merged model written to {out_path}", flush=True)
    return 0


def build_serving_engine(ns, args):
    """One engine from the serving plan (tests and embedders build it
    without entering serve_forever)."""
    from paddle_tpu_torch.serving import ServingEngine, ServingPredictor
    graph, params, names, feeding, pk, ek = _serving_plan(ns, args)
    return ServingEngine(
        ServingPredictor(graph, params, names, feeding, **pk), **ek)


def cmd_serve(ns, args) -> int:
    from paddle_tpu_torch.serving import serve_forever
    return serve_forever(build_serving_engine(ns, args), host=args.host,
                         port=args.port)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device; "
                             "pass --device cpu to run on the CPU")
        # the f32 reference semantics: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ns = load_config(args.config)
    return {"train": cmd_train, "test": cmd_test, "merge": cmd_merge,
            "serve": cmd_serve}[args.job](ns, args)


if __name__ == "__main__":
    sys.exit(main())

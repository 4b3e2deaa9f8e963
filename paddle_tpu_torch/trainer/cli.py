"""Command line of the port: ``--job serve``, the counterpart of
``paddle_tpu/trainer/cli.py`` (``_serving_plan`` / ``cmd_serve``).

    python -m paddle_tpu_torch.trainer.cli --config conf.py --job serve \\
        [--init_model_path m.ptmodel] --max_batch 64 \\
        --serving_length_buckets 32,64,128 --port 8000 [--device cuda]

The config is a Python file that builds its graph with
``paddle_tpu_torch.config.dsl`` and names ``feeding`` (data-layer name ->
InputType) and ``outputs`` (the layers to serve) as module variables.
Parameters come from a PTM1 merged model (``--init_model_path``, written
by either package), else from a fresh initialisation seeded by
``--seed``. The server runs on ``--device`` (``cuda`` unless the caller
asks for ``cpu``); it prints one ``serving on http://host:port`` line when
ready, and drains and exits 0 on SIGTERM.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.trainer.cli")
    p.add_argument("--config", required=True)
    p.add_argument("--job", required=True, choices=["serve"],
                   help="serve: answer /v1/score over HTTP (the only job "
                        "ported so far)")
    p.add_argument("--init_model_path", default=None,
                   help="PTM1 merged model (.ptmodel) to serve")
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
        raise SystemExit("--job=serve needs the config to define "
                         "`feeding` (data-layer name -> InputType)")
    outputs = ns.get("outputs")
    if outputs:
        names = [o.name if hasattr(o, "name") else o for o in outputs]
    elif "cost" in ns:
        names = [ns["cost"].name]
    else:
        raise SystemExit("--job=serve needs the config to define "
                         "`outputs` (the layers to serve)")
    graph = dsl.current_graph()
    max_batch = max(args.max_batch, 1)
    batch_buckets = [1]
    while batch_buckets[-1] < max_batch:
        batch_buckets.append(min(batch_buckets[-1] * 2, max_batch))
    length_buckets = [int(x) for x in filter(
        None, str(args.serving_length_buckets).split(","))]
    pred_kwargs = dict(batch_buckets=batch_buckets,
                       length_buckets=length_buckets, device=args.device)
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
    eng_kwargs = dict(max_batch=max_batch,
                      batch_timeout_ms=args.batch_timeout_ms,
                      queue_depth=args.queue_depth,
                      default_deadline_ms=args.serving_deadline_ms or None)
    return graph, params, names, feeding, pred_kwargs, eng_kwargs


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
                             "pass --device cpu to serve on the CPU")
        # the f32 reference semantics: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ns = load_config(args.config)
    return {"serve": cmd_serve}[args.job](ns, args)


if __name__ == "__main__":
    sys.exit(main())

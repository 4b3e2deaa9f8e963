#!/usr/bin/env python3
"""Chip smoke test of paddle_tpu_torch, the PyTorch/CUDA port, on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and the script exits
non-zero without the result line:

1. device: a CUDA card is required (no CPU fallback); prints
   ``nvidia-smi --query-gpu=name,power.limit`` and turns TF32 off.
2. build: compiles every CUDA source of the port (``paddle_tpu_torch/
   csrc``: ``lstm_seq.cu``, ``opt_update.cu``; one nvcc per source,
   started together) and prints the seconds and the register report.
3. kernel check: the primal LSTM recurrence kernel against its plain
   PyTorch version on the card, at T=100 with a ragged mask and nonzero
   h0/c0, in both time directions, for every BENCH_SHAPES (batch, hidden)
   pair and at the serving path's own shapes; ys, hT and cT within rtol
   1e-4 / atol 1e-5 (summation order over K=H and 100 steps).
4. train kernel check: at every BENCH_SHAPES pair (T=100, ragged mask,
   nonzero h0/c0) the residual forward kernel (ys, hs, cs, gates; rtol
   1e-4 / atol 1e-5) and the backward through the step kernel (every
   gradient, per tensor within 1e-4 of the tensor's largest entry + 1e-5:
   sums over T*B rows) against their plain versions; reverse through
   ``LstmFunction`` at (64, 1280); the Momentum and Adam kernels against
   ``_apply_one`` at every parameter size of the h=1280 model and at 1, 7
   and 1025 elements (rtol 1e-6 / atol 1e-7: the kernels take the plain
   chain's roundings). Kernel and plain times are CUDA events, median of
   10 calls after warmup, beside the bound.
5. train: ``lstm_text_classifier`` at its widest published width (vocab
   30000, embed 128, hidden 1280, 2 LSTM layers, 2 classes) trained by
   ``python -m paddle_tpu_torch.trainer.cli --job train`` with
   ``Adam(learning_rate=2e-3)`` for 3 passes over 4 fixed batches of 64
   (lengths 1-100, padded to 100; ids from the seed, labels from a rule
   on the ids), saving into ``--save_dir``: the cost must be finite and
   fall from pass 0 to pass 2, and the CLI's kernel counts (a fresh
   process: they start at 0) must show the residual forward, the backward
   step and Adam launched. One pass with the CLI's default optimizer,
   Momentum, drives the Momentum kernel the same way. Then one batch's
   loss and every parameter gradient at full width (16 rows, lengths
   1-100) from the trained checkpoint, on the card against the plain path
   on the CPU, per tensor within 1e-3 of the CPU tensor's largest entry
   + 1e-6 (float32 through 100 recurrent steps each way; the plain path
   in float64 is reported beside both as the exact reference); then
   ``--job merge`` of the save dir.
6. serve: the merged trained model served by ``--job serve`` (max_batch
   64, length buckets 32,64,128). Single samples and a rows batch of
   lengths 1-100 must answer softmax rows that sum to 1, repeat
   identically, match the port's plain path run on the CPU from the same
   file, and go through the kernel (its launch count, read from the
   server's /healthz before and after the requests, grows). SIGTERM must
   drain the server to exit 0.
7. kernels: one JSON line ``{"kernels": [...]}`` for every ported kernel,
   with the launches of the main path (phases 5 and 6).

The last line is ``{"ok": true, "device": {...}}``. Full results go to
``chip_smoke.json`` in ``OUT_DIR``.
"""

from __future__ import annotations

import http.client
import json
import os
import queue
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

import numpy as np
import torch

from paddle_tpu_torch.ops import build
from paddle_tpu_torch.ops import lstm as L

SOURCES = ["lstm_seq", "opt_update"]

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# published H100 SXM peaks at 700 W (NVIDIA data sheet)
F32_FLOPS = 67e12      # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
TOL = dict(rtol=1e-4, atol=1e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
T_CHECK = 100
MODEL = dict(vocab_size=30000, embed_dim=128, hidden=1280, num_layers=2,
             classes=2)
MAX_BATCH = 64
TRAIN_BATCH, TRAIN_BATCHES, TRAIN_PASSES, SEQLEN = 64, 4, 3, 100
GRAD_CHECK_ROWS = 16
LENGTH_BUCKETS = [32, 64, 128]
# the shapes the serving path hands the kernel: (batch, T) at hidden 1280
SERVE_SHAPES = [(1, 32), (64, 128)]
SEED = 2017


def phase(title: str, **kv):
    print(f"phase {title}: {json.dumps(kv)}", flush=True)


# ------------------------------------------------------------ 1. device
def check_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is false); this script runs on the "
                         "card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    return smi


# ------------------------------------------------------------- 2. build
def build_kernels():
    secs = build.build_all(SOURCES)
    report = {}
    for name in SOURCES:
        log = build.library_path(name).with_suffix(".log")
        if log.exists():
            report[name] = [ln.strip() for ln in log.read_text().splitlines()
                            if "registers" in ln or "spill" in ln
                            or "Compiling entry" in ln]
    phase("build", seconds=secs, ptxas=report)


# ------------------------------------------------------ 3. kernel check
def _inputs(B, H, T, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    lens = torch.randint(1, T + 1, (B,), generator=g, device=dev)
    lens[0] = T
    mask = (torch.arange(T, device=dev)[:, None] < lens[None, :]).float()
    return dict(xs=randn(T, B, 4 * H), mask=mask.contiguous(),
                w=randn(H, 4 * H, scale=H ** -0.5),
                bias=randn(4 * H, scale=0.1), pI=randn(H, scale=0.1),
                pF=randn(H, scale=0.1), pO=randn(H, scale=0.1),
                h0=randn(B, H, scale=0.5), c0=randn(B, H, scale=0.5))


def _plain(a, reverse):
    xs, mask = a["xs"], a["mask"]
    if reverse:
        xs, mask = xs.flip(0), mask.flip(0)
    ys, hT, cT = L.lstm_sequence_plain(xs + a["bias"], mask, a["w"],
                                       a["pI"], a["pF"], a["pO"], a["h0"],
                                       a["c0"])
    return (ys.flip(0) if reverse else ys), hT, cT


def _time_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(ops, nbytes):
    """Least time for the work, ms: the bytes (each input read once, each
    output written once) over HBM, or the operations at the f32 rate,
    whichever is larger; and which one it is."""
    t_ops, t_bytes = ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _bound_ms(B, H, T, residuals=False):
    """The recurrence: its product 2*B*H*4H per step; xs, mask, W, the
    peepholes, h0, c0 in, ys and hT, cT (or the residuals hs, cs and
    gates) out."""
    outs = (3 * T * B * H + T * B * 4 * H) if residuals \
        else (T * B * H + 2 * B * H)
    return _bound(2.0 * B * H * 4 * H * T,
                  4 * (T * B * 4 * H + T * B + H * 4 * H + 3 * H
                       + 2 * B * H + outs))


def check_shape(B, H, T, senses, seed):
    a = _inputs(B, H, T, seed)
    err = 0.0
    for reverse in senses:
        got = L.lstm_sequence(a["xs"], a["mask"], a["w"], a["bias"],
                              a["pI"], a["pF"], a["pO"], a["h0"], a["c0"],
                              reverse=reverse)
        torch.cuda.synchronize()
        want = _plain(a, reverse)
        for name, g, w in zip(("ys", "hT", "cT"), got, want):
            if not torch.isfinite(g).all():
                raise AssertionError(f"B={B} H={H} reverse={reverse}: "
                                     f"{name} is not finite")
            err = max(err, (g - w).abs().max().item())
            torch.testing.assert_close(
                g, w, **TOL, msg=lambda m: f"B={B} H={H} T={T} reverse="
                f"{reverse} {name}: {m}")
    xs_b = (a["xs"] + a["bias"]).contiguous()
    args = (xs_b, a["mask"], a["w"], a["pI"], a["pF"], a["pO"], a["h0"],
            a["c0"])
    ms = _time_ms(lambda: L.lstm_seq(*args))
    plain_ms = _time_ms(lambda: L.lstm_sequence_plain(*args))
    bound_ms, bound_by = _bound_ms(B, H, T)
    row = dict(B=B, H=H, T=T, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    phase("kernel_check", **row)
    return row


def check_kernels():
    rows = [check_shape(B, H, T_CHECK, (False, True), seed=B * 7 + H)
            for B, H in L.BENCH_SHAPES]
    serve_rows = [check_shape(B, MODEL["hidden"], T, (False,), seed=B + T)
                  for B, T in SERVE_SHAPES]
    return rows, serve_rows


# ------------------------------------------------ 4. train kernel check
def _grad_err(got, want):
    """max |got - want| and the per-tensor limit 1e-4 * max|want| + 1e-5."""
    return ((got - want).abs().max().item(),
            1e-4 * want.abs().max().item() + 1e-5)


def _residual_args(a):
    return ((a["xs"] + a["bias"]).contiguous(), a["mask"], a["w"], a["pI"],
            a["pF"], a["pO"], a["h0"], a["c0"])


def _cotangents(B, H, T, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda")
            for shape in ((T, B, H), (B, H), (B, H))]


def _bwd_step_args(res, cot):
    """One reverse step's arguments (the last step of the sequence)."""
    mask, w, pI, pF, pO, h0, c0, hs, cs, gates = res
    dys, dhT, dcT = cot
    return (dys[-1], mask[-1], gates[-1], cs[-1], cs[-2], pI, pF, pO,
            torch.zeros_like(dhT), dhT.clone(), dcT.clone(),
            torch.empty_like(gates[-1]))


def check_train_shape(B, H, T, seed):
    a = _inputs(B, H, T, seed)
    args = _residual_args(a)
    got = L.lstm_seq_train(*args)
    torch.cuda.synchronize()
    want = L.lstm_sequence_residual_plain(*args)
    fwd_err = 0.0
    for name, g, w in zip(("ys", "hs", "cs", "gates"), got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"B={B} H={H}: {name} is not finite")
        fwd_err = max(fwd_err, (g - w).abs().max().item())
        torch.testing.assert_close(
            g, w, **TOL, msg=lambda m: f"B={B} H={H} T={T} {name}: {m}")
    res = (a["mask"], a["w"], a["pI"], a["pF"], a["pO"], a["h0"], a["c0"],
           *got[1:])
    cot = _cotangents(B, H, T, seed + 1)
    got_b = L.lstm_backward(*res, *cot)
    torch.cuda.synchronize()
    want_b = L.lstm_backward(*res, *cot, step=L.lstm_bwd_step_plain)
    bwd_err = 0.0
    for name, g, w in zip(("dxs", "dW", "dpI", "dpF", "dpO", "dh0", "dc0"),
                          got_b, want_b):
        err, limit = _grad_err(g, w)
        if not (err <= limit):
            raise AssertionError(f"B={B} H={H} T={T} backward {name}: "
                                 f"max abs err {err} > {limit}")
        bwd_err = max(bwd_err, err)
    step = _bwd_step_args(res, cot)
    row = dict(
        B=B, H=H, T=T, fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err,
        fwd_ms=_time_ms(lambda: L.lstm_seq_train(*args)),
        fwd_plain_ms=_time_ms(lambda: L.lstm_sequence_residual_plain(*args)),
        bwd_ms=_time_ms(lambda: L.lstm_backward(*res, *cot)),
        bwd_plain_ms=_time_ms(lambda: L.lstm_backward(
            *res, *cot, step=L.lstm_bwd_step_plain)),
        step_ms=_time_ms(lambda: L.lstm_bwd_step(*step), reps=50),
        step_plain_ms=_time_ms(lambda: L.lstm_bwd_step_plain(*step),
                               reps=50))
    row["fwd_bound_ms"], row["fwd_bound_by"] = _bound_ms(B, H, T, True)
    # one backward step: dy, mask, gates, c_new, c_prev, peepholes, dhw,
    # dh, dc in; dh, dc, dgates out; ~37 operations per element
    row["step_bound_ms"], row["step_bound_by"] = _bound(
        37.0 * B * H, 4 * (15 * B * H + B + 3 * H))
    phase("train_kernel_check", **row)
    return row


def check_reverse(B, H, T, seed):
    """reverse=True through LstmFunction (flip in, flip out; the bias
    folded outside) against the plain residual forward and backward."""
    a = _inputs(B, H, T, seed)
    names = ("xs", "w", "bias", "pI", "pF", "pO", "h0", "c0")
    leaves = {k: a[k].clone().requires_grad_(True) for k in names}
    ys, hT, cT = L.lstm_sequence(
        leaves["xs"], a["mask"], leaves["w"], leaves["bias"], leaves["pI"],
        leaves["pF"], leaves["pO"], leaves["h0"], leaves["c0"], reverse=True)
    dys, dhT, dcT = _cotangents(B, H, T, seed + 1)
    got = torch.autograd.grad(
        (ys * dys).sum() + (hT * dhT).sum() + (cT * dcT).sum(),
        [leaves[k] for k in names])
    torch.cuda.synchronize()
    f = dict(a, xs=a["xs"].flip(0), mask=a["mask"].flip(0).contiguous())
    args = _residual_args(f)
    w_ys, hs, cs, gates = L.lstm_sequence_residual_plain(*args)
    dxs, dW, dpI, dpF, dpO, dh0, dc0 = L.lstm_backward(
        f["mask"], a["w"], a["pI"], a["pF"], a["pO"], a["h0"], a["c0"], hs,
        cs, gates, dys.flip(0), dhT, dcT, step=L.lstm_bwd_step_plain)
    want = (dxs.flip(0), dW, dxs.sum(dim=(0, 1)), dpI, dpF, dpO, dh0, dc0)
    torch.testing.assert_close(ys, w_ys.flip(0), **TOL)
    err = 0.0
    for name, g, w in zip(names, got, want):
        e, limit = _grad_err(g, w)
        if not (e <= limit):
            raise AssertionError(f"reverse B={B} H={H} d{name}: max abs err "
                                 f"{e} > {limit}")
        err = max(err, e)
    phase("train_kernel_check_reverse", B=B, H=H, T=T, max_abs_err=err)
    return err


def _model_param_sizes():
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
    dsl.reset()
    cost, _, _ = lstm_text_classifier(**MODEL)
    specs = Network(dsl.current_graph(), outputs=[cost.name]).param_specs
    return {int(np.prod(s.shape)) for s in specs.values()}


def check_optimizer_kernels():
    """Momentum and Adam against ``_apply_one`` on the same card tensors,
    at every parameter size of the model and at 1, 7 and 1025; timed at
    the largest size."""
    from paddle_tpu_torch.kernels import opt_update
    from paddle_tpu_torch.optim import Adam, Momentum
    sizes = sorted(_model_param_sizes() | {1, 7, 1025})
    mo, ad = Momentum(momentum=0.9), Adam(learning_rate=2e-3)
    lr, decay, t = 2e-3, 1e-3, 3
    rows = {}
    for kind in ("momentum", "adam"):
        err = 0.0
        for n in sizes:
            g = torch.Generator(device="cuda").manual_seed(n)
            p, grad, m, v = (torch.randn(n, generator=g, device="cuda")
                             for _ in range(4))
            slots = {"mom": m} if kind == "momentum" else {"mom": m,
                                                           "v": v.abs()}
            if kind == "momentum":
                run = lambda: opt_update.momentum(mo, p, grad, slots, lr,
                                                  decay)
                plain = lambda: mo._apply_one(p, grad, slots, lr, decay, t)
            else:
                run = lambda: opt_update.adam(ad, p, grad, slots, lr, decay,
                                              t)
                plain = lambda: ad._apply_one(p, grad, slots, lr, decay, t)
            got, want = run(), plain()
            torch.cuda.synchronize()
            for gt, wt in zip((got[0], *got[1].values()),
                              (want[0], *want[1].values())):
                err = max(err, (gt - wt).abs().max().item())
                torch.testing.assert_close(
                    gt, wt, **OPT_TOL, msg=lambda m: f"{kind} n={n}: {m}")
        # p, g and the slots in, p and the slots out, once each
        n_slots = 1 if kind == "momentum" else 2
        bound_ms, bound_by = _bound(
            (6.0 if kind == "momentum" else 14.0) * n,
            4 * n * (2 + n_slots + 1 + n_slots))
        rows[kind] = dict(n=n, sizes=sizes, max_abs_err=err,
                          ms=_time_ms(run), plain_ms=_time_ms(plain),
                          bound_ms=bound_ms, bound_by=bound_by)
        phase("optimizer_kernel_check", kind=kind, **rows[kind])
    return rows


def check_train_kernels():
    rows = [check_train_shape(B, H, T_CHECK, seed=B * 11 + H)
            for B, H in L.BENCH_SHAPES]
    reverse_err = check_reverse(64, MODEL["hidden"], T_CHECK, seed=5)
    return rows, reverse_err, check_optimizer_kernels()


# ------------------------------------------------------------- 5. train
def _write_config(path, optimizer):
    with open(path, "w") as f:
        f.write(textwrap.dedent(f"""
            import numpy as np
            from paddle_tpu_torch.data.feeder import DataFeeder
            from paddle_tpu_torch.data.types import (
                integer_value, integer_value_sequence)
            from paddle_tpu_torch.models.lstm_text import \\
                lstm_text_classifier
            from paddle_tpu_torch.optim import Adam
            cost, out, _ = lstm_text_classifier(**{MODEL!r})
            outputs = [out]
            {optimizer}
            feeding = DataFeeder(
                {{"words": integer_value_sequence({MODEL['vocab_size']}),
                  "label": integer_value({MODEL['classes']})}},
                pad_multiple={SEQLEN})

            def train_reader():
                # fixed batches: lengths 1-{SEQLEN}, ids from the seed, the
                # label says whether most ids lie in the table's lower half
                rng = np.random.default_rng({SEED})
                for _ in range({TRAIN_BATCHES}):
                    batch = []
                    for n in rng.integers(1, {SEQLEN + 1},
                                          size={TRAIN_BATCH}):
                        ids = rng.integers(0, {MODEL['vocab_size']},
                                           size=int(n))
                        low = (ids < {MODEL['vocab_size'] // 2}).mean()
                        batch.append((ids.tolist(), int(low > 0.5)))
                    yield batch
        """))


def _cli(args, timeout):
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.trainer.cli", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
        raise AssertionError(f"trainer.cli {' '.join(args[:4])} exited "
                             f"{res.returncode}")
    return res.stdout


def _train_run(conf, passes, save_dir=None):
    """One ``--job train`` process: (per-pass costs, train_summary)."""
    args = ["--config", conf, "--job", "train", "--num_passes", str(passes),
            "--seed", str(SEED)]
    if save_dir:
        args += ["--save_dir", save_dir]
    out = _cli(args, timeout=900)
    costs = [float(ln.split("cost=")[1].split()[0])
             for ln in out.splitlines() if ln.startswith("Pass ")]
    summary = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith("train_summary "))[14:])
    if len(costs) != passes or summary["steps"] != passes * TRAIN_BATCHES:
        raise AssertionError(f"train run printed {costs}, {summary}")
    return costs, summary


def check_full_width_grads(save_dir):
    """One batch's loss and every parameter gradient from the trained
    checkpoint: the card (kernels) against the plain path on the CPU,
    per tensor ``max|g_card - g_cpu| <= 1e-3 * max|g_cpu| + 1e-6``: both
    are float32 through 100 recurrent steps each way, with every sum in
    another order. The same plain path in float64 on the CPU is the
    reference that shows how far each float32 result is from the exact
    one (``err64``)."""
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.data.feeder import DataFeeder
    from paddle_tpu_torch.data.types import (integer_value,
                                             integer_value_sequence)
    from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.trainer.checkpoint import (latest_checkpoint,
                                                     load_params)
    from paddle_tpu_torch.trainer.trainer import SGD
    dsl.reset()
    cost, _, _ = lstm_text_classifier(**MODEL)
    params, _ = load_params(latest_checkpoint(save_dir))
    rng = np.random.default_rng(SEED + 1)
    batch = [(rng.integers(0, MODEL["vocab_size"], size=int(n)).tolist(),
              int(rng.integers(0, MODEL["classes"])))
             for n in rng.integers(1, SEQLEN + 1, size=GRAD_CHECK_ROWS)]
    feed = DataFeeder({"words": integer_value_sequence(MODEL["vocab_size"]),
                       "label": integer_value(MODEL["classes"])},
                      pad_multiple=SEQLEN, device="cpu")(batch)
    runs = {}
    for key, device, dtype in (("cuda", "cuda", torch.float32),
                               ("cpu", "cpu", torch.float32),
                               ("cpu64", "cpu", torch.float64)):
        trainer = SGD(cost, parameters=params, device=device,
                      update_equation=Adam(learning_rate=2e-3))
        trainer.params = {k: v.to(dtype) for k, v in trainer.params.items()}
        t0 = time.perf_counter()
        _, loss, grads = trainer.loss_and_grads(trainer._to_device(feed))
        runs[key] = (float(loss), {k: v.cpu().double() for k, v in
                                   grads.items()},
                     time.perf_counter() - t0)
        del trainer
    loss_g, loss_c = runs["cuda"][0], runs["cpu"][0]
    if not np.isfinite(loss_g) or abs(loss_g - loss_c) > 1e-5 * abs(loss_c):
        raise AssertionError(f"loss on the card {loss_g}, on the CPU "
                             f"{loss_c}")
    errs = {}
    for name, gc in runs["cpu"][1].items():
        gg, g64 = runs["cuda"][1][name], runs["cpu64"][1][name]
        err = (gg - gc).abs().max().item()
        limit = 1e-3 * gc.abs().max().item() + 1e-6
        errs[name] = dict(err=err, max_abs=gc.abs().max().item(),
                          err64_cuda=(gg - g64).abs().max().item(),
                          err64_cpu=(gc - g64).abs().max().item())
        if not (err <= limit):
            raise AssertionError(f"gradient {name}: max abs err {err} > "
                                 f"{limit} ({errs[name]})")
    return dict(rows=GRAD_CHECK_ROWS, loss_cuda=loss_g, loss_cpu=loss_c,
                loss_cpu64=runs["cpu64"][0], grads=errs,
                seconds={k: v[2] for k, v in runs.items()})


def train(tmp):
    """--job train (Adam, 3 passes, --save_dir), one Momentum pass, the
    full-width gradient check, --job merge. Returns (result, conf, model)."""
    conf = os.path.join(tmp, "train_conf.py")
    _write_config(conf, "optimizer = Adam(learning_rate=2e-3)")
    save_dir = os.path.join(tmp, "ckpt")
    costs, summary = _train_run(conf, TRAIN_PASSES, save_dir)
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"pass costs {costs} do not fall")
    counts = summary["kernels"]
    for name in ("lstm_seq_train", "lstm_bwd_step", "adam"):
        if counts[name]["launches"] <= 0:
            raise AssertionError(f"--job train never launched {name}")
    mom_conf = os.path.join(tmp, "momentum_conf.py")
    _write_config(mom_conf, "# no optimizer: the CLI's default Momentum")
    mom_costs, mom_summary = _train_run(mom_conf, 1)
    if mom_summary["kernels"]["momentum"]["launches"] <= 0:
        raise AssertionError("--job train never launched momentum")
    grads = check_full_width_grads(save_dir)
    model = os.path.join(tmp, "lstm_text_h1280.ptmodel")
    _cli(["--config", conf, "--job", "merge", "--save_dir", save_dir,
          "--model_path", model], timeout=600)
    result = dict(pass_costs=costs, steps=summary["steps"],
                  median_step_ms=summary["median_step_ms"],
                  step_ms=summary["step_ms"], kernels=counts,
                  momentum_pass_costs=mom_costs,
                  momentum_median_step_ms=mom_summary["median_step_ms"],
                  momentum_kernels=mom_summary["kernels"], grad_check=grads)
    phase("train", **result)
    return result, conf, model


# ------------------------------------------------------------- 6. serve
def _batch_buckets(max_batch):
    """The serve CLI's menu: powers of two up to max_batch."""
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return out


def _http(port, method, path, body=None, timeout=300):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        payload = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _launches(port):
    status, h = _http(port, "GET", "/healthz")
    if status != 200:
        raise AssertionError(f"/healthz answered {status}: {h}")
    return h["kernels"]["lstm_seq"]


def _wait_ready(proc, timeout):
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=1.0)
        except queue.Empty:
            if proc.poll() is not None:
                raise AssertionError(f"server exited {proc.returncode} "
                                     "before it was ready")
            continue
        if line.startswith("serving on http://"):
            return int(line.split()[2].rsplit(":", 1)[1])
    raise AssertionError(f"server not ready within {timeout}s")


def serve(tmp, conf, model):
    """Serve the merged PTM1 ``model`` with the config ``conf``."""
    from paddle_tpu_torch.data.types import (integer_value,
                                             integer_value_sequence)
    from paddle_tpu_torch.serving import ServingPredictor

    feeding = {"words": integer_value_sequence(MODEL["vocab_size"]),
               "label": integer_value(MODEL["classes"])}

    rng = np.random.default_rng(SEED)

    def sample(n):
        return [rng.integers(0, MODEL["vocab_size"], size=n).tolist(),
                int(rng.integers(0, MODEL["classes"]))]

    singles = [sample(n) for n in (1, 37, 100)]
    rows = [sample(int(n)) for n in rng.integers(1, 101, size=24)]

    t_start = time.perf_counter()
    err_log = open(os.path.join(tmp, "server.stderr"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.trainer.cli", "--config",
         conf, "--job", "serve", "--init_model_path", model,
         "--max_batch", str(MAX_BATCH), "--serving_length_buckets",
         ",".join(map(str, LENGTH_BUCKETS)), "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=err_log, text=True)
    try:
        port = _wait_ready(proc, timeout=600)
        ready_s = time.perf_counter() - t_start
        before = _launches(port)
        answers, times_ms = [], []
        for s in singles + [singles[-1]]:
            t0 = time.perf_counter()
            status, body = _http(port, "POST", "/v1/score", {"sample": s})
            times_ms.append(1e3 * (time.perf_counter() - t0))
            if status != 200:
                raise AssertionError(f"/v1/score answered {status}: {body}")
            answers.append(body["outputs"]["output"])
        t0 = time.perf_counter()
        status, body = _http(port, "POST", "/v1/score", {"rows": rows})
        rows_ms = 1e3 * (time.perf_counter() - t0)
        if status != 200:
            raise AssertionError(f"/v1/score rows answered {status}: {body}")
        answers += [r["outputs"]["output"] for r in body["results"]]
        after = _launches(port)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        err_log.close()
    if rc != 0:
        with open(os.path.join(tmp, "server.stderr")) as f:
            sys.stderr.write(f.read()[-4000:])
        raise AssertionError(f"server exited {rc} after SIGTERM")

    got = np.asarray(answers, dtype=np.float64)
    if got.shape != (len(singles) + 1 + len(rows), MODEL["classes"]):
        raise AssertionError(f"answers have shape {got.shape}")
    if not np.isfinite(got).all():
        raise AssertionError("non-finite answers")
    sum_err = float(np.abs(got.sum(axis=1) - 1.0).max())
    if sum_err > 1e-5:
        raise AssertionError(f"softmax rows sum to 1 +- {sum_err}")
    if answers[2] != answers[3]:
        raise AssertionError("two identical requests answered differently")
    ref = ServingPredictor.from_merged(
        model, feeding, batch_buckets=_batch_buckets(MAX_BATCH),
        length_buckets=LENGTH_BUCKETS, device="cpu")
    want = np.concatenate(
        [ref.predict_rows([tuple(s) for s in singles + [singles[-1]]])[0]
         ["output"][:len(singles) + 1],
         ref.predict_rows([tuple(r) for r in rows])[0]["output"][:len(rows)]])
    ref_err = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, **TOL)
    launches = after["launches"] - before["launches"]
    steps = after["step_launches"] - before["step_launches"]
    if launches <= 0:
        raise AssertionError("the serving path never launched lstm_seq")
    result = dict(ready_s=ready_s, single_ms=times_ms, rows=len(rows),
                  rows_ms=rows_ms, requests=len(singles) + 1 + len(rows),
                  launches=launches, step_launches=steps,
                  max_abs_err_vs_cpu=ref_err, softmax_sum_err=sum_err,
                  server_exit=rc)
    phase("serve", **result)
    return result


def _entry(name, source, replaces, launches, err, row, prefix=""):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": row[prefix + "ms"], "plain_ms": row[prefix + "plain_ms"],
            "bound_ms": row[prefix + "bound_ms"],
            "bound_by": row[prefix + "bound_by"], "library_ms": None,
            "check": "pass"}


def main() -> int:
    check_device()
    build_kernels()
    rows, serve_rows = check_kernels()
    train_rows, reverse_err, opt_rows = check_train_kernels()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        trained, conf, model = train(tmp)
        served = serve(tmp, conf, model)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    main_row = serve_rows[-1]  # the largest shape the serving path runs
    # the training path's shape: batch 64 at h=1280, T=100
    t_row = next(r for r in train_rows
                 if (r["B"], r["H"]) == (TRAIN_BATCH, MODEL["hidden"]))
    lstm_src = "paddle_tpu_torch/csrc/lstm_seq.cu"
    opt_src = "paddle_tpu_torch/csrc/opt_update.cu"
    counts = trained["kernels"]
    entries = [
        dict(_entry("lstm_seq", lstm_src, "paddle_tpu/ops/lstm.py:174",
                    served["launches"],
                    max(r["max_abs_err"] for r in rows + serve_rows),
                    main_row),
             shape={k: main_row[k] for k in ("B", "H", "T")}),
        dict(_entry("lstm_seq_train", lstm_src, "paddle_tpu/ops/lstm.py:174",
                    counts["lstm_seq_train"]["launches"],
                    max(r["fwd_max_abs_err"] for r in train_rows), t_row,
                    "fwd_"),
             shape={k: t_row[k] for k in ("B", "H", "T")}),
        dict(_entry("lstm_bwd_step", lstm_src,
                    "JAX lax.scan paddle_tpu/ops/lstm.py:358 (_bwd_rule)",
                    counts["lstm_bwd_step"]["launches"],
                    max([r["bwd_max_abs_err"] for r in train_rows]
                        + [reverse_err]), t_row, "step_"),
             shape={"B": t_row["B"], "H": t_row["H"], "T": 1}),
        dict(_entry("momentum", opt_src,
                    "paddle_tpu/kernels/opt_update.py:83",
                    trained["momentum_kernels"]["momentum"]["launches"],
                    opt_rows["momentum"]["max_abs_err"], opt_rows["momentum"]),
             shape={"n": opt_rows["momentum"]["n"]}),
        dict(_entry("adam", opt_src, "paddle_tpu/kernels/opt_update.py:110",
                    counts["adam"]["launches"],
                    opt_rows["adam"]["max_abs_err"], opt_rows["adam"]),
             shape={"n": opt_rows["adam"]["n"]}),
    ]
    for e in entries:
        if e["launches"] <= 0:
            raise AssertionError(f"the main path never launched {e['name']}")
    kernels = {"kernels": entries}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"bench_shapes": rows, "serve_shapes": serve_rows,
                   "train_shapes": train_rows, "reverse_err": reverse_err,
                   "optimizer": opt_rows, "train": trained, "serve": served,
                   **kernels}, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

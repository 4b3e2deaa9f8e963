#!/usr/bin/env python3
"""Chip smoke test of paddle_tpu_torch, the PyTorch/CUDA port, on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and the script exits
non-zero without the result line:

1. device: a CUDA card is required (no CPU fallback); prints
   ``nvidia-smi --query-gpu=name,power.limit`` and turns TF32 off.
2. build: compiles every CUDA kernel of the port from ``paddle_tpu_torch/
   csrc`` (one nvcc per source, started together) and prints the seconds
   and the compiler's register report.
3. kernel check: the LSTM recurrence kernel against its plain PyTorch
   version on the card, at T=100 with a ragged mask and nonzero h0/c0, in
   both time directions, for every BENCH_SHAPES (batch, hidden) pair and
   at the serving path's own shapes; ys, hT and cT within rtol 1e-4 /
   atol 1e-5 (summation order over K=H and 100 steps of recurrence).
   Prints each pair's errors, kernel and plain times (CUDA events, median
   of 10 calls after warmup) and the bound.
4. serve: ``lstm_text_classifier`` at its widest published width (vocab
   30000, embed 128, hidden 1280, 2 LSTM layers, 2 classes), random
   weights from a fixed seed, merged to a PTM1 file and served by
   ``python -m paddle_tpu_torch.trainer.cli --job serve`` (max_batch 64,
   length buckets 32,64,128). Single samples and a rows batch of lengths
   1-100 must answer softmax rows that sum to 1, repeat identically, match
   the port's plain path run on the CPU from the same file, and go through
   the kernel (its launch count, read from the server's /healthz before
   and after the requests, grows). SIGTERM must drain the server to exit 0.
5. kernels: one JSON line ``{"kernels": [...]}`` for every ported kernel.

The last line is ``{"ok": true, "device": {...}}``. Full results go to
``chiprun_out/chip_smoke.json``.
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

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# published H100 SXM peaks at 700 W (NVIDIA data sheet)
F32_FLOPS = 67e12      # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
TOL = dict(rtol=1e-4, atol=1e-5)
T_CHECK = 100
MODEL = dict(vocab_size=30000, embed_dim=128, hidden=1280, num_layers=2,
             classes=2)
MAX_BATCH = 64
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
    secs = build.build_all(["lstm_seq"])
    report = []
    log = build.library_path("lstm_seq").with_suffix(".log")
    if log.exists():
        report = [ln.strip() for ln in log.read_text().splitlines()
                  if "registers" in ln or "spill" in ln]
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


def _bound_ms(B, H, T):
    """Least time for the work: each input read once and each output
    written once over HBM, or the recurrent product at the f32 rate."""
    ops = 2.0 * B * H * 4 * H * T
    nbytes = 4 * (T * B * 4 * H + T * B + H * 4 * H + 3 * H + 2 * B * H
                  + T * B * H + 2 * B * H)
    t_ops, t_bytes = ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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


# ------------------------------------------------------------- 4. serve
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


def serve(tmp):
    from paddle_tpu_torch.config import dsl
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.data.types import (integer_value,
                                             integer_value_sequence)
    from paddle_tpu_torch.models.lstm_text import lstm_text_classifier
    from paddle_tpu_torch.serving import ServingPredictor
    from paddle_tpu_torch.trainer.merge_model import merge_model

    dsl.reset()
    lstm_text_classifier(**MODEL)
    graph = dsl.current_graph()
    params = Network(graph, outputs=["output"]).init_params(
        torch.Generator().manual_seed(SEED), device="cpu")
    model = os.path.join(tmp, "lstm_text_h1280.ptmodel")
    merge_model(model, graph, params, outputs=["output"])
    conf = os.path.join(tmp, "serve_conf.py")
    with open(conf, "w") as f:
        f.write(textwrap.dedent(f"""
            from paddle_tpu_torch.data.types import (
                integer_value, integer_value_sequence)
            from paddle_tpu_torch.models.lstm_text import \\
                lstm_text_classifier
            cost, out, _ = lstm_text_classifier(**{MODEL!r})
            outputs = [out]
            feeding = {{"words": integer_value_sequence({MODEL['vocab_size']}),
                       "label": integer_value({MODEL['classes']})}}
        """))
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


def main() -> int:
    check_device()
    build_kernels()
    rows, serve_rows = check_kernels()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        served = serve(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    main_row = serve_rows[-1]  # the largest shape the serving path runs
    kernels = {"kernels": [{
        "name": "lstm_seq", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/lstm_seq.cu",
        "replaces": "paddle_tpu/ops/lstm.py:174",
        "launches": served["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows + serve_rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None, "check": "pass",
        "shape": {k: main_row[k] for k in ("B", "H", "T")}}]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"bench_shapes": rows, "serve_shapes": serve_rows,
                   "serve": served, **kernels}, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

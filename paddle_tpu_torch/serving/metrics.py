"""Serving observability: the latency split, batch and lane occupancy,
bucket hits, the decode-step economics. The port's copy of
``paddle_tpu/serving/metrics.py`` (``LatencyStat``, ``ServingMetrics``
and its Prometheus text) with the same counter and series names; the
router's ``RouterMetrics`` waits for the router.

Four phases partition a request's life: ``queue_wait`` (enqueue until
the batcher takes it), ``pad_overhead`` (feeder conversion, padding to
the bucket, the copy to the device), ``compute`` (the forward or beam
search through the copy back) and ``decode`` (slicing the batch into
per-request answers). Batch occupancy is real rows / padded rows;
``lane_occupancy`` is live lanes / session width at each chunk boundary
of continuous batching; ``decode_steps`` counts the steps each generate
request ran. Quantiles come from a bounded reservoir of the most recent
samples; counts and sums are exact over the process's life.

Exported as :meth:`ServingMetrics.snapshot` (``/metrics?format=json``)
and :meth:`ServingMetrics.to_prometheus` (``/metrics``).
"""

from __future__ import annotations

import threading
from collections import Counter, deque
from typing import Dict, Optional

PHASES = ("queue_wait", "pad_overhead", "compute", "decode")


class LatencyStat:
    """Exact count/sum + recent-window quantiles for one phase (ms)."""

    def __init__(self, window: int = 4096):
        self.count = 0
        self.sum_ms = 0.0
        self._recent = deque(maxlen=window)

    def add(self, ms: float):
        self.count += 1
        self.sum_ms += ms
        self._recent.append(ms)

    def quantile(self, q: float) -> Optional[float]:
        if not self._recent:
            return None
        vals = sorted(self._recent)
        idx = min(int(q * len(vals)), len(vals) - 1)
        return vals[idx]

    def snapshot(self) -> dict:
        out = {"count": self.count,
               "sum_ms": round(self.sum_ms, 3),
               "mean_ms": round(self.sum_ms / self.count, 3)
               if self.count else None}
        for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            v = self.quantile(q)
            out[f"{name}_ms"] = round(v, 3) if v is not None else None
        return out


class ServingMetrics:
    """Thread-safe metric registry for one serving engine."""

    COUNTERS = ("requests_total", "responses_total", "batches_total",
                "shed_total", "deadline_exceeded_total",
                "bad_request_total", "internal_error_total",
                "decode_chunks_total", "continuous_admissions_total",
                "decode_steps_total", "decode_steps_saved_total",
                # the hot-reconfig plane's counters (0 until the port
                # has apply_config): the JAX package's series names
                "config_applies_total", "config_rejected_total",
                "tune_decisions_total")

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self.latency: Dict[str, LatencyStat] = {
            p: LatencyStat(window) for p in PHASES + ("total",)}
        self.occupancy = LatencyStat(window)  # unit: fraction, not ms
        self.decode_steps = LatencyStat(window)  # unit: steps, not ms
        self.lane_occupancy = LatencyStat(window)  # unit: fraction
        self.bucket_hits: Counter = Counter()
        self.counters = {c: 0 for c in self.COUNTERS}
        self.real_rows_total = 0
        self.padded_rows_total = 0

    # ------------------------------------------------------------ record
    def inc(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] += n

    def observe_request(self, phases_ms: Dict[str, float]):
        """One answered request's per-phase latency (ms); ``total`` is
        derived as the sum so the split always partitions it."""
        with self._lock:
            total = 0.0
            for p in PHASES:
                ms = float(phases_ms.get(p, 0.0))
                self.latency[p].add(ms)
                total += ms
            self.latency["total"].add(total)
            self.counters["responses_total"] += 1

    def observe_batch(self, bucket_key: str, real_rows: int,
                      padded_rows: int):
        with self._lock:
            self.counters["batches_total"] += 1
            self.bucket_hits[bucket_key] += 1
            self.real_rows_total += int(real_rows)
            self.padded_rows_total += int(padded_rows)
            if padded_rows:
                self.occupancy.add(real_rows / padded_rows)

    def observe_decode(self, steps, saved):
        """One request's decode-step accounting: ``steps`` actually
        executed, ``saved`` = max_length - steps the early exit (or
        mid-flight retirement) refused to pay."""
        if steps is None:
            return
        with self._lock:
            self.decode_steps.add(float(steps))
            self.counters["decode_steps_total"] += int(steps)
            self.counters["decode_steps_saved_total"] += int(saved or 0)

    def observe_lanes(self, live: int, width: int):
        """Continuous-batching lane occupancy at one chunk boundary."""
        with self._lock:
            self.counters["decode_chunks_total"] += 1
            if width:
                self.lane_occupancy.add(live / width)

    # ------------------------------------------------------------ export
    def snapshot(self) -> dict:
        with self._lock:
            occ = self.occupancy.snapshot()
            dec = self.decode_steps.snapshot()
            lanes = self.lane_occupancy.snapshot()
            return {
                "latency_ms": {p: s.snapshot()
                               for p, s in self.latency.items()},
                "batch_occupancy": {
                    "mean": round(self.real_rows_total
                                  / self.padded_rows_total, 4)
                    if self.padded_rows_total else None,
                    "p50": occ["p50_ms"],  # fraction, reservoir window
                    "real_rows_total": self.real_rows_total,
                    "padded_rows_total": self.padded_rows_total,
                },
                # the *_ms suffixes below come from LatencyStat's generic
                # snapshot; units here are decoder steps / lane fraction
                "decode_steps": {
                    "count": dec["count"], "mean": dec["mean_ms"],
                    "p50": dec["p50_ms"], "p95": dec["p95_ms"],
                    "p99": dec["p99_ms"],
                },
                "lane_occupancy": {
                    "count": lanes["count"], "mean": lanes["mean_ms"],
                    "p50": lanes["p50_ms"],
                },
                "bucket_hits": dict(self.bucket_hits),
                **self.counters,
            }

    def to_prometheus(self, prefix: str = "paddle_tpu_serving") -> str:
        return _serving_prometheus(self, prefix)


def _serving_prometheus(m: "ServingMetrics", prefix: str) -> str:
    s = m.snapshot()
    lines = []
    for c in m.COUNTERS:
        lines.append(f"# TYPE {prefix}_{c} counter")
        lines.append(f"{prefix}_{c} {s[c]}")
    lines.append(f"# TYPE {prefix}_latency_ms summary")
    for phase, st in s["latency_ms"].items():
        for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                       ("0.99", "p99_ms")):
            v = st[key]
            if v is not None:
                lines.append(
                    f'{prefix}_latency_ms{{phase="{phase}",'
                    f'quantile="{q}"}} {v}')
        lines.append(
            f'{prefix}_latency_ms_count{{phase="{phase}"}} '
            f'{st["count"]}')
        lines.append(
            f'{prefix}_latency_ms_sum{{phase="{phase}"}} '
            f'{st["sum_ms"]}')
    occ = s["batch_occupancy"]
    lines.append(f"# TYPE {prefix}_batch_occupancy gauge")
    if occ["mean"] is not None:
        lines.append(f"{prefix}_batch_occupancy {occ['mean']}")
    lines.append(f"# TYPE {prefix}_decode_steps summary")
    for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
        v = s["decode_steps"][key]
        if v is not None:
            lines.append(
                f'{prefix}_decode_steps{{quantile="{q}"}} {v}')
    lines.append(
        f'{prefix}_decode_steps_count {s["decode_steps"]["count"]}')
    lines.append(f"# TYPE {prefix}_lane_occupancy gauge")
    if s["lane_occupancy"]["mean"] is not None:
        lines.append(
            f"{prefix}_lane_occupancy {s['lane_occupancy']['mean']}")
    lines.append(f"# TYPE {prefix}_bucket_hits counter")
    for bucket, hits in sorted(s["bucket_hits"].items()):
        lines.append(
            f'{prefix}_bucket_hits{{bucket="{bucket}"}} {hits}')
    return "\n".join(lines) + "\n"

"""Dynamic micro-batching engine: queue, coalesce, deadline, shed, drain.

The lean counterpart of ``paddle_tpu/serving/batcher.py``. One worker
thread coalesces whatever is waiting of the head request's kind
(``score`` or ``generate``), up to ``max_batch``, within a
``batch_timeout`` window into the smallest admissible batch bucket, runs
it (``predict_rows`` or ``generate_rows``), and fans the results back
out; a generate answer is ``{"sequences": [{"tokens", "score"}, ...]}``,
beams best first. Behaviours, all typed (``serving/errors.py``):

- a bounded queue: past ``queue_depth`` a request is shed ``Overloaded``
  with a ``retry_after_ms`` drain estimate;
- per-request deadlines, checked in the queue and after compute;
- drain: ``begin_drain()`` closes admission (``ShuttingDown``) while the
  worker answers every queued request; ``shutdown()`` waits for it;
- lane isolation: a malformed row found at batch time is probed out,
  replaced with a padding row and answered ``BadRequest`` alone.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional

from paddle_tpu_torch import ops
from paddle_tpu_torch.serving.errors import (BadRequest, DeadlineExceeded,
                                             Overloaded, ServingError,
                                             ShuttingDown)

logger = logging.getLogger("paddle_tpu_torch.serving")

# errors a malformed sample raises while the feeder converts it
_CONVERSION_ERRORS = (BadRequest, ValueError, TypeError, KeyError,
                      OverflowError)


class _Request:
    __slots__ = ("sample", "kind", "enqueue_t", "deadline", "event",
                 "result", "error")

    def __init__(self, sample, kind: str, deadline: Optional[float]):
        self.sample = sample
        self.kind = kind
        self.enqueue_t = time.perf_counter()
        self.deadline = deadline  # absolute perf_counter time, or None
        self.event = threading.Event()
        self.result = None
        self.error: Optional[ServingError] = None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class ServingEngine:
    """One predictor + one worker thread + one bounded queue."""

    def __init__(self, predictor, *, max_batch: Optional[int] = None,
                 batch_timeout_ms: float = 5.0, queue_depth: int = 64,
                 default_deadline_ms: Optional[float] = None):
        self.predictor = predictor
        self.max_batch = int(max_batch or predictor.batch_buckets[-1])
        if self.max_batch > predictor.batch_buckets[-1]:
            raise ValueError(
                f"max_batch {self.max_batch} exceeds the largest warmed "
                f"batch bucket {predictor.batch_buckets[-1]}")
        self.batch_timeout_ms = float(batch_timeout_ms)
        self.queue_depth = int(queue_depth)
        self.default_deadline_ms = default_deadline_ms
        self._cond = threading.Condition()
        self._queue: List[_Request] = []
        self._draining = False
        self._batch_ewma_ms = 10.0  # drain-time estimator seed
        self._inflight = 0  # rows of the batch running now (worker-written)
        self._thread: Optional[threading.Thread] = None
        self.fatal: Optional[BaseException] = None

    # ------------------------------------------------------------ control
    def start(self, warmup: bool = True) -> "ServingEngine":
        if warmup and not self.predictor.warmed:
            self.predictor.warmup(log=logger.info)
        self._thread = threading.Thread(target=self._work,
                                        name="serving-batcher", daemon=True)
        self._thread.start()
        return self

    def queue_len(self) -> int:
        with self._cond:
            return len(self._queue)

    def health(self) -> dict:
        """Liveness vs readiness (the ``/healthz`` payload), plus the
        kernel launch counts of this process."""
        live = self.fatal is None
        warmed = bool(self.predictor.warmed)
        ready = live and warmed and not self._draining
        if ready:
            status = "ok"
        elif self._draining:
            status = "draining"
        elif live and not warmed:
            status = "warming"
        else:
            status = "unhealthy"
        return {
            "status": status, "live": live, "ready": ready,
            "warmed": warmed, "draining": self._draining,
            "queue_depth": self.queue_len(),
            "inflight": self._inflight,
            "backlog_ms": round(self._retry_after_ms(), 1),
            "model_version": self.predictor.model_version,
            "fatal": repr(self.fatal) if self.fatal else None,
            "kernels": ops.kernel_counts(),
        }

    def begin_drain(self):
        """Close admission; queued and in-flight work still completes."""
        with self._cond:
            first = not self._draining
            self._draining = True
            self._cond.notify_all()
        if first:
            logger.info("serving: draining (admission closed)")

    def shutdown(self, drain: bool = True, timeout: float = 30.0):
        """Drain (default) or abort the queue, then stop the worker."""
        with self._cond:
            self._draining = True
            if not drain:
                for r in self._queue:
                    r.error = ShuttingDown(
                        "server shutting down; request not started")
                    r.event.set()
                self._queue.clear()
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # ---------------------------------------------------------- admission
    def _retry_after_ms(self) -> float:
        backlog_batches = max(len(self._queue), 1) / self.max_batch
        return max(self.batch_timeout_ms,
                   self._batch_ewma_ms * backlog_batches)

    def submit(self, sample, *, kind: str = "score",
               deadline_ms: Optional[float] = None, beam_size=None,
               max_length=None) -> _Request:
        """Admit one request of ``kind`` (``score`` or ``generate``, whose
        ``beam_size`` / ``max_length`` must be the warmed pair); raises
        typed errors synchronously. Wait on the returned request's
        ``.event``, then read ``.result`` or ``.error``."""
        if self.fatal is not None:
            raise ServingError(f"serving worker died: {self.fatal!r}")
        if kind == "generate":
            self.predictor.check_gen_opts(beam_size, max_length)
        elif kind != "score":
            raise BadRequest(f"unknown request kind {kind!r}")
        self.predictor.check_sample(sample)
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline = (time.perf_counter() + float(deadline_ms) / 1e3
                    if deadline_ms else None)
        req = _Request(tuple(sample), kind, deadline)
        with self._cond:
            if self.fatal is not None:
                raise ServingError(f"serving worker died: {self.fatal!r}")
            if self._draining:
                raise ShuttingDown("server is draining; retry elsewhere",
                                   retry_after_ms=self._retry_after_ms())
            if len(self._queue) >= self.queue_depth:
                raise Overloaded(
                    f"queue depth {len(self._queue)} at the bound "
                    f"{self.queue_depth}",
                    retry_after_ms=self._retry_after_ms())
            self._queue.append(req)
            self._cond.notify_all()
        return req

    def infer(self, sample, *, kind: str = "score",
              deadline_ms: Optional[float] = None,
              wait_timeout: float = 120.0, **gen_opts):
        """Synchronous submit-and-wait; raises the request's typed error
        or returns its result."""
        req = self.submit(sample, kind=kind, deadline_ms=deadline_ms,
                          **gen_opts)
        if not req.event.wait(wait_timeout):
            raise DeadlineExceeded(
                f"no answer within wait_timeout={wait_timeout}s")
        if req.error is not None:
            raise req.error
        return req.result

    # ------------------------------------------------------------- worker
    def _expire_locked(self, now: float):
        live = []
        for r in self._queue:
            if r.expired(now):
                r.error = DeadlineExceeded(
                    "deadline passed while queued "
                    f"(queued {1e3 * (now - r.enqueue_t):.1f} ms)")
                r.event.set()
            else:
                live.append(r)
        self._queue[:] = live

    def _collect(self) -> Optional[List[_Request]]:
        """Block for the next coalesced batch; None when drained dry."""
        with self._cond:
            while True:
                self._expire_locked(time.perf_counter())
                if self._queue:
                    break
                if self._draining:
                    return None
                self._cond.wait(0.1)
            head = self._queue[0]
            window_end = time.perf_counter() + self.batch_timeout_ms / 1e3
            if head.deadline is not None:
                window_end = min(window_end, head.deadline)
            while True:
                now = time.perf_counter()
                self._expire_locked(now)
                batch = [r for r in self._queue
                         if r.kind == head.kind][:self.max_batch]
                if (len(batch) >= self.max_batch or self._draining
                        or now >= window_end):
                    break
                self._cond.wait(window_end - now)
            taken = set(map(id, batch))
            self._queue[:] = [r for r in self._queue if id(r) not in taken]
            # claimed before the lock drops: a drain poll must never see
            # an empty queue and no in-flight rows while a batch is pending
            self._inflight = len(batch)
            return batch

    def _work(self):
        while True:
            batch = None
            try:
                batch = self._collect()
                if batch is None:
                    logger.info("serving: worker drained and stopped")
                    return
                if batch:
                    try:
                        self._run_batch(batch)
                    finally:
                        self._inflight = 0
            except BaseException as e:  # noqa: BLE001 — a worker bug
                self.fatal = e
                logger.error("serving worker died: %r", e)
                err = ServingError(f"serving worker died: {e!r}")
                # answer everything in flight and queued, or its callers
                # would block forever
                with self._cond:
                    pending = (batch or []) + self._queue
                    self._queue.clear()
                for r in pending:
                    if not r.event.is_set():
                        r.error = r.error or err
                        r.event.set()
                raise

    def _predict(self, kind: str, rows):
        if kind == "generate":
            return self.predictor.generate_rows(rows)
        return self.predictor.predict_rows(rows)

    @staticmethod
    def _decode(kind: str, outs, lane: int):
        if kind == "generate":
            tokens, scores, lengths = outs
            return {"sequences": [
                {"tokens": tokens[lane, k, :int(lengths[lane, k])].tolist(),
                 "score": float(scores[lane, k])}
                for k in range(tokens.shape[1])]}
        return {"outputs": {name: v[lane].tolist()
                            for name, v in outs.items()}}

    def _run_batch(self, reqs: List[_Request]):
        kind = reqs[0].kind
        rows = [r.sample for r in reqs]
        t0 = time.perf_counter()
        try:
            outs, _info = self._predict(kind, rows)
        except _CONVERSION_ERRORS as batch_err:
            # probe per lane, answer the bad rows alone, and score the
            # rest with padding rows in the bad lanes
            probe = self.predictor.probe_rows(rows)
            if all(err is None for err in probe):
                # no single lane reproduces it: a batch-level problem
                for r in reqs:
                    r.error = (batch_err if isinstance(batch_err, BadRequest)
                               else BadRequest(str(batch_err)))
                    r.event.set()
                return
            clean = list(rows)
            for i, err in enumerate(probe):
                if err is not None:
                    clean[i] = self.predictor.padding_row()
                    reqs[i].error = (err if isinstance(err, BadRequest)
                                     else BadRequest(str(err)))
            outs, _info = self._predict(kind, clean)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        self._batch_ewma_ms += 0.25 * (wall_ms - self._batch_ewma_ms)
        now = time.perf_counter()
        for i, r in enumerate(reqs):
            if r.error is None:
                r.result = self._decode(kind, outs, i)
                if r.expired(now):
                    r.error = DeadlineExceeded(
                        "computed, but past the deadline "
                        f"(total {1e3 * (now - r.enqueue_t):.1f} ms)")
            r.event.set()

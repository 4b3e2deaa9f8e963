"""Dynamic micro-batching engine: queue, coalesce, deadline, shed, drain.

The counterpart of ``paddle_tpu/serving/batcher.py``. One worker thread
coalesces whatever is waiting of the head request's kind (``score`` or
``generate``), up to ``max_batch``, within a ``batch_timeout`` window into
the smallest admissible batch bucket, runs it (``predict_rows`` or
``generate_rows``), and fans the results back out; a generate answer is
``{"sequences": [{"tokens", "score"}, ...]}``, beams best first. Every
request, batch and decode lands in ``metrics`` (``serving/metrics.py``).
Behaviours, all typed (``serving/errors.py``):

- a bounded queue: past ``queue_depth`` a request is shed ``Overloaded``
  with a ``retry_after_ms`` drain estimate;
- per-request deadlines, checked in the queue and after compute;
- drain: ``begin_drain()`` closes admission (``ShuttingDown``) while the
  worker answers every queued request; ``shutdown()`` waits for it;
- lane isolation: a malformed row found at batch time is probed out,
  replaced with a padding row and answered ``BadRequest`` alone;
- continuous batching (``continuous_batching=True``): the generate path
  drives the predictor's ``DecodeSession`` chunk by chunk instead of
  running a coalesced batch until its longest search ends. At every chunk
  boundary finished lanes retire (their callers answered at once),
  expired lanes are answered ``DeadlineExceeded`` mid-decode and freed,
  and queued generate requests are encoded once and admitted into the
  free lanes, unless a request of another kind waits (then the session
  drains and the worker serves the queue in order).

The JAX engine's replay sink, workload recorder, chaos hooks, trace spans
and ``apply_config`` are not ported.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from paddle_tpu_torch import ops
from paddle_tpu_torch.serving.errors import (BadRequest, DeadlineExceeded,
                                             Overloaded, ServingError,
                                             ShuttingDown)
from paddle_tpu_torch.serving.metrics import ServingMetrics

logger = logging.getLogger("paddle_tpu_torch.serving")

# errors a malformed sample raises while the feeder converts it
_CONVERSION_ERRORS = (BadRequest, ValueError, TypeError, KeyError,
                      OverflowError)


class _Request:
    __slots__ = ("sample", "kind", "enqueue_t", "deadline", "event",
                 "result", "error", "timings")

    def __init__(self, sample, kind: str, deadline: Optional[float]):
        self.sample = sample
        self.kind = kind
        self.enqueue_t = time.perf_counter()
        self.deadline = deadline  # absolute perf_counter time, or None
        self.event = threading.Event()
        self.result = None
        self.error: Optional[ServingError] = None
        self.timings: Dict[str, float] = {}

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class ServingEngine:
    """One predictor + one worker thread + one bounded queue."""

    def __init__(self, predictor, *, max_batch: Optional[int] = None,
                 batch_timeout_ms: float = 5.0, queue_depth: int = 64,
                 default_deadline_ms: Optional[float] = None,
                 continuous_batching: bool = False,
                 metrics: Optional[ServingMetrics] = None):
        self.predictor = predictor
        self.max_batch = int(max_batch or predictor.batch_buckets[-1])
        if self.max_batch > predictor.batch_buckets[-1]:
            raise ValueError(
                f"max_batch {self.max_batch} exceeds the largest warmed "
                f"batch bucket {predictor.batch_buckets[-1]}")
        self.batch_timeout_ms = float(batch_timeout_ms)
        self.queue_depth = int(queue_depth)
        self.default_deadline_ms = default_deadline_ms
        self.continuous_batching = bool(continuous_batching)
        self._session = None  # the DecodeSession, built in start()
        self.metrics = metrics or ServingMetrics()
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
        if self.continuous_batching and self._session is None:
            if self.predictor.engine is None:
                logger.warning(
                    "continuous_batching requested but the model has no "
                    "generation group — standing down to plain batching")
                self.continuous_batching = False
            else:
                # one warmed session for the engine's life; None = the
                # predictor stood down with its own warning
                self._session = self.predictor.build_session(
                    self.max_batch)
                if self._session is None:
                    self.continuous_batching = False
        self._thread = threading.Thread(target=self._work,
                                        name="serving-batcher", daemon=True)
        self._thread.start()
        return self

    def queue_len(self) -> int:
        with self._cond:
            return len(self._queue)

    def backlog_hint_ms(self) -> float:
        """Drain-time estimate (EWMA batch time x queued batches): the
        429's ``retry_after_ms``. A lock-free read of an estimator."""
        return self._retry_after_ms()

    def health(self) -> dict:
        """Liveness vs readiness (the ``/healthz`` payload; ``/livez``
        reads ``live``), the precision tier and its gate's verdict, and
        the kernel launch counts of this process."""
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
            "backlog_ms": round(self.backlog_hint_ms(), 1),
            "model_version": self.predictor.model_version,
            "fatal": repr(self.fatal) if self.fatal else None,
            "quant": self.predictor.quant_health(),
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
                    self.metrics.inc("shed_total")
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
                self.metrics.inc("shed_total")
                raise Overloaded(
                    f"queue depth {len(self._queue)} at the bound "
                    f"{self.queue_depth}",
                    retry_after_ms=self._retry_after_ms())
            self._queue.append(req)
            self.metrics.inc("requests_total")
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
                r.timings["queue_wait"] = 1e3 * (now - r.enqueue_t)
                r.event.set()
                self.metrics.inc("deadline_exceeded_total")
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
                        if (self._session is not None
                                and batch[0].kind == "generate"):
                            self._run_generate_continuous(batch)
                        else:
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
                self.metrics.inc("internal_error_total")
                raise

    # ------------------------------------------------- continuous decode
    def _steal_queued(self, kind: str, n: int) -> List[_Request]:
        """Pop up to ``n`` queued requests of ``kind`` (expiring stale
        ones first): admission at a chunk boundary. Draining does not
        close it, since queued work is answered during a drain.

        Fairness: while a request of another kind waits, nothing is
        stolen; the continuous loop then drains its live lanes and
        returns to ``_collect``, which serves the queue in arrival order.
        Otherwise a stream of generate traffic that keeps one lane live
        would starve queued score requests."""
        if n <= 0:
            return []
        with self._cond:
            self._expire_locked(time.perf_counter())
            if any(r.kind != kind for r in self._queue):
                return []
            take = [r for r in self._queue if r.kind == kind][:n]
            for r in take:
                self._queue.remove(r)
            if take:
                self._cond.notify_all()
            return take

    def _admit_lane(self, sess, lane: int, req: _Request,
                    now: float) -> bool:
        """Encode one request and splice it into ``lane``. A malformed
        request fails alone here (typed 400). Only the feeder and encoder
        conversion is the client's fault: a failure in ``sess.admit`` is
        a server bug and goes to the worker-fatal path."""
        t0 = time.perf_counter()
        try:
            outer = self.predictor.encode_rows([req.sample])
        except _CONVERSION_ERRORS as e:
            req.error = e if isinstance(e, BadRequest) else BadRequest(str(e))
            req.event.set()
            self.metrics.inc("bad_request_total")
            return False
        sess.admit(lane, outer, row=0)
        req.timings["queue_wait"] = 1e3 * (now - req.enqueue_t)
        req.timings["pad_overhead"] = 1e3 * (time.perf_counter() - t0)
        req.timings["compute"] = 0.0
        return True

    def _retire_lane(self, sess, lane: int, req: _Request):
        """Answer a finished lane and free it; its service time (admission
        to answer, queue wait excluded) feeds the drain estimator."""
        td0 = time.perf_counter()
        tokens, scores, lengths, steps = sess.peek(lane)
        sess.release(lane)
        req.result = {"sequences": [
            {"tokens": tokens[k, :int(lengths[k])].tolist(),
             "score": float(scores[k])}
            for k in range(tokens.shape[0])]}
        now = time.perf_counter()
        req.timings["decode"] = 1e3 * (now - td0)
        self.metrics.observe_decode(steps, sess.L - steps)
        if req.expired(now):
            req.error = DeadlineExceeded(
                "computed, but past the deadline "
                f"(total {1e3 * (now - req.enqueue_t):.1f} ms)")
            self.metrics.inc("deadline_exceeded_total")
        else:
            self.metrics.observe_request(req.timings)
        req.event.set()
        service_ms = max(0.0, 1e3 * (now - req.enqueue_t)
                         - req.timings.get("queue_wait", 0.0))
        self._batch_ewma_ms += 0.25 * (service_ms - self._batch_ewma_ms)

    def _run_generate_continuous(self, reqs: List[_Request]):
        """Drive the decode session until the seed batch and everything
        admitted from the queue at chunk boundaries is answered; return
        to ``_collect`` only when no lane is live."""
        sess = self._session
        pending = deque(reqs)
        lanes: Dict[int, _Request] = {}
        started = False
        try:
            while True:
                # admit into free lanes: the seed batch first, then the
                # queue (admission mid-decode)
                free = deque(sess.free_lanes())
                while free:
                    if not pending:
                        pending.extend(
                            self._steal_queued("generate", len(free)))
                        if not pending:
                            break
                    req = pending.popleft()
                    now = time.perf_counter()
                    if req.expired(now):
                        req.error = DeadlineExceeded(
                            "deadline passed while queued "
                            f"(queued {1e3 * (now - req.enqueue_t):.1f} "
                            "ms)")
                        req.event.set()
                        self.metrics.inc("deadline_exceeded_total")
                        continue
                    lane = free.popleft()
                    if self._admit_lane(sess, lane, req, now):
                        lanes[lane] = req
                        if started:
                            self.metrics.inc(
                                "continuous_admissions_total")
                    else:
                        free.append(lane)  # admission failed; still free
                self._inflight = len(lanes)
                if not lanes:
                    return
                # one chunk for every live lane
                t0 = time.perf_counter()
                sess.run_chunk()
                # one copy of the lane flags serves the deadline sweep
                # and the retire sweep (and waits for the chunk)
                active, fin, t = sess.poll()
                chunk_ms = 1e3 * (time.perf_counter() - t0)
                started = True
                self.metrics.observe_lanes(len(lanes), sess.width)
                for req in lanes.values():
                    req.timings["compute"] += chunk_ms
                # deadlines hold mid-decode: an expired lane is answered
                # and freed now, not at the search's end
                now = time.perf_counter()
                for lane, req in list(lanes.items()):
                    if req.expired(now):
                        req.error = DeadlineExceeded(
                            "deadline passed mid-decode "
                            f"(total {1e3 * (now - req.enqueue_t):.1f} "
                            f"ms, {int(t[lane])} steps in)")
                        req.event.set()
                        self.metrics.inc("deadline_exceeded_total")
                        sess.release(lane)
                        del lanes[lane]
                # retire finished lanes
                for lane in range(sess.width):
                    if not (active[lane] and (fin[lane]
                                              or t[lane] >= sess.L)):
                        continue
                    req = lanes.pop(lane, None)
                    if req is not None:
                        self._retire_lane(sess, lane, req)
        except BaseException as e:  # noqa: BLE001 — a worker bug
            # answer every live lane and the unadmitted tail before
            # _work's handler answers the queue
            err = ServingError(f"serving worker died: {e!r}")
            for req in list(lanes.values()) + list(pending):
                if not req.event.is_set():
                    req.error = req.error or err
                    req.event.set()
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
        t_assemble = time.perf_counter()
        kind = reqs[0].kind
        rows = [r.sample for r in reqs]
        t0 = time.perf_counter()
        try:
            outs, info = self._predict(kind, rows)
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
                    self.metrics.inc("bad_request_total")
                return
            clean = list(rows)
            for i, err in enumerate(probe):
                if err is not None:
                    clean[i] = self.predictor.padding_row()
                    reqs[i].error = (err if isinstance(err, BadRequest)
                                     else BadRequest(str(err)))
                    self.metrics.inc("bad_request_total")
            outs, info = self._predict(kind, clean)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        self._batch_ewma_ms += 0.25 * (wall_ms - self._batch_ewma_ms)
        self.metrics.observe_batch(
            info["bucket"], real_rows=sum(r.error is None for r in reqs),
            padded_rows=info["padded_rows"])
        for i, r in enumerate(reqs):
            if r.error is not None:  # a malformed lane, already typed
                r.event.set()
                continue
            if kind == "generate":
                # convoy accounting: every rider pays the batch's step
                # count (continuous mode records each lane's own)
                self.metrics.observe_decode(info.get("decode_steps"),
                                            info.get("steps_saved"))
            td0 = time.perf_counter()
            r.result = self._decode(kind, outs, i)
            now = time.perf_counter()
            r.timings = {"queue_wait": 1e3 * (t_assemble - r.enqueue_t),
                         "pad_overhead": info["pad_ms"],
                         "compute": info["compute_ms"],
                         "decode": 1e3 * (now - td0)}
            if r.expired(now):
                r.error = DeadlineExceeded(
                    "computed, but past the deadline "
                    f"(total {1e3 * (now - r.enqueue_t):.1f} ms)")
                self.metrics.inc("deadline_exceeded_total")
            else:
                self.metrics.observe_request(r.timings)
            r.event.set()

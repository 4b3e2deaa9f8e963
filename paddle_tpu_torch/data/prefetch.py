"""The input pipeline: the port of ``paddle_tpu/data/prefetch.py``'s
``LengthBuckets``, ``PrefetchPipeline`` and ``prefetch_reader``.

- :class:`LengthBuckets`: pad ragged lengths up to a small menu of
  padded lengths.
- :class:`PrefetchPipeline`: one background thread reads a pass's raw
  batches, converts them (decode, pad, bucket: the feeder) on the host
  and starts their copy to the device, with ``depth`` batches in flight
  (the reference's ``--use_async_load_data`` double buffer,
  ``DataProvider.h:249``). On a CUDA device the copy goes from pinned
  host memory, ``non_blocking``, on a side stream, and records an event;
  the consumer's stream waits on that event before the step reads the
  batch, so the step sees the bytes a synchronous copy would give it.
  A worker's exception re-raises at the consumer, after the batches
  already prepared. ``close()`` stops the worker; iteration closes it at
  the end.
- :func:`prefetch_reader`: a reader whose every pass streams through a
  fresh pipeline; marked ``is_prefetched``, so the trainer consumes its
  feeds as they are.

The JAX package's ``RecompileGuard`` and ``jit_cache_size`` watch jit
retraces, which PyTorch's eager execution does not have.
"""

from __future__ import annotations

import bisect
import threading
import time
from queue import Empty, Full, Queue
from typing import Callable, Optional, Sequence

import torch

_END = object()


class _Failure:
    """A worker-thread exception, carried through the queue."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class LengthBuckets:
    """Pad-to-bucket policy for ragged sequence lengths.

    ``edges`` is a small ascending set of padded lengths (e.g.
    ``[32, 64, 128]``). A raw max-length pads to the smallest edge that
    holds it; lengths beyond the last edge pad to the next multiple of it.
    """

    def __init__(self, edges: Sequence[int]):
        edges = sorted(int(e) for e in edges)
        if not edges or edges[0] < 1:
            raise ValueError(f"bucket edges must be positive ints: {edges}")
        if len(set(edges)) != len(edges):
            raise ValueError(f"duplicate bucket edges: {edges}")
        self.edges = edges

    def pad_len(self, n: int) -> int:
        """Smallest bucket holding a raw length ``n``."""
        n = max(int(n), 1)
        i = bisect.bisect_left(self.edges, n)
        if i < len(self.edges):
            return self.edges[i]
        last = self.edges[-1]
        return ((n + last - 1) // last) * last

    def __repr__(self):
        return f"LengthBuckets({self.edges})"


def _args_of(feed):
    from paddle_tpu_torch.core.argument import Argument
    return {k: a for k, a in feed.items() if isinstance(a, Argument)}


class PrefetchPipeline:
    """A bounded background-thread input pipeline over one pass.

    ``reader``: a zero-argument callable giving the pass's raw batches.
    ``feeder``: the batch -> feed converter run in the worker (a
    ``DataFeeder`` converts on the host there: ``convert(batch,
    host=True)``). ``device``: where the batches land (default: the
    feeder's). ``depth``: batches in flight (2 = double buffer).

    Iterate it (or call :meth:`get`). ``data_wait`` sums the consumer's
    seconds blocked on the queue."""

    def __init__(self, reader: Callable, feeder: Optional[Callable] = None,
                 device=None, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._reader = reader
        self._feeder = feeder
        if device is None:
            device = getattr(feeder, "device", None) or "cpu"
        self.device = torch.device(device)
        self._q: Queue = Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = False
        self.depth = depth
        self.data_wait = 0.0
        self.batches = 0
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._thread = threading.Thread(
            target=self._work, name="prefetch-worker", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- worker
    def _convert(self, raw):
        if self._feeder is None:
            return raw
        if hasattr(self._feeder, "convert"):
            return self._feeder.convert(raw, host=True)
        return self._feeder(raw)

    def _place(self, feed):
        """(feed on the device, the copy's event or None, the pinned host
        tensors the copy reads)."""
        from paddle_tpu_torch.core.argument import Argument
        if self._stream is None:
            def move(t):
                return None if t is None else t.to(self.device)
            return ({k: Argument(value=move(a.value), mask=move(a.mask),
                                 state=a.state)
                     for k, a in _args_of(feed).items()}, None, ())
        pinned, out = [], {}
        with torch.cuda.stream(self._stream):
            def move(t):
                if t is None or t.is_cuda:
                    return t
                p = t.pin_memory()
                pinned.append(p)
                return p.to(self.device, non_blocking=True)
            for k, a in _args_of(feed).items():
                out[k] = Argument(value=move(a.value), mask=move(a.mask),
                                  state=a.state)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event, tuple(pinned)

    def _work(self):
        try:
            for raw in self._reader():
                if self._stop.is_set():
                    return
                if not self._put(self._place(self._convert(raw))):
                    return
            self._put(_END)
        except BaseException as e:  # noqa: BLE001: crosses the thread
            self._put(_Failure(e))

    def _put(self, item) -> bool:
        """A blocking put that honours close(); False when shut down."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except Full:
                continue
        return False

    # ----------------------------------------------------------- consumer
    def get(self):
        """The next prepared feed; StopIteration at the pass's end; a
        worker's exception re-raised at its place in the queue. On the
        card the current stream waits for the feed's copy first."""
        if self._closed:
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        self.data_wait += time.perf_counter() - t0
        if item is _END:
            self._closed = True
            raise StopIteration
        if isinstance(item, _Failure):
            self._closed = True
            raise item.exc
        feed, event, _ = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for a in feed.values():
                for t in (a.value, a.mask):
                    if t is not None and t.is_cuda:
                        # the allocator must not reuse the side stream's
                        # block while this stream still reads it
                        t.record_stream(stream)
        self.batches += 1
        return feed

    def __iter__(self):
        try:
            while True:
                try:
                    yield self.get()
                except StopIteration:
                    return
        finally:
            self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        """Stop the worker and release its blocked put; idempotent."""
        self._closed = True
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except Empty:
                break
        self._thread.join(timeout=5.0)


def prefetch_reader(reader: Callable, feeder: Optional[Callable] = None,
                    device=None, depth: int = 2) -> Callable:
    """A reader whose every call streams through a fresh
    :class:`PrefetchPipeline`; it yields prepared feeds on the device and
    marks itself ``is_prefetched``, so the trainer skips its own
    feeder."""

    def prefetched(*args):
        src = (lambda: reader(*args)) if args else reader
        return iter(PrefetchPipeline(src, feeder=feeder, device=device,
                                     depth=depth))

    prefetched.is_prefetched = True
    return prefetched

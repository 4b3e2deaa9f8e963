"""Periodic checkpoint and exact resume: the port of
``paddle_tpu/dist/checkpoint.py``'s ``Checkpointer``.

- Cadence: ``saving_period`` (every N passes) and
  ``saving_period_by_batches`` (every N batches inside a pass), the v1
  trainer's flags (``Trainer.cpp:454-462``).
- Files: ``checkpoint-pNNNNN-bNNNNNNNN.npz`` with its ``.meta`` sidecar
  (MD5 and the pass/batch metadata) and the ``LATEST`` pointer, each
  written to a temporary file, fsynced and renamed
  (``trainer/checkpoint.py``: the JAX package's format, so either package
  restores the other's directory).
- Off the hot path (``background=True``): the device-to-host copy stays
  on the caller's thread (the step loop changes the tensors right after),
  the serialisation, fsync, rename and garbage collection run on one
  writer thread. A writer's error re-raises on the trainer's thread at
  the next save or ``flush`` (a chaos kill as itself).
- Garbage collection keeps the newest ``KEEP`` generations, ordered by
  (pass, batch) parsed from the names, never by mtime; the ``LATEST``
  target always stays.
- ``restore`` returns the newest intact generation: a file without its
  sidecar is skipped with a warning, one whose bytes fail the MD5 or do
  not parse is quarantined (renamed ``.bad``), and the previous
  generation restored.
The master-reader lease of the JAX package (``resume_lease``,
``sync_pass``) belongs to its ``dist/master.py``, not ported.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import re
import threading
import time
from typing import Any, Optional, Tuple

from paddle_tpu_torch.testing import chaos as _chaos
from paddle_tpu_torch.trainer.checkpoint import (load_checkpoint,
                                                 snapshot_arrays,
                                                 write_snapshot)

logger = logging.getLogger("paddle_tpu_torch.checkpoint")

_GEN_RE = re.compile(r"^checkpoint-p(\d+)-b(\d+)\.npz$")


def _gen_key(name: str):
    """Total order on checkpoint file names by generation: (parsed?,
    pass, end of pass?, batch, name). The end-of-pass save (batch 0) is
    the newest of its pass; foreign names sort oldest."""
    m = _GEN_RE.match(name)
    if not m:
        return (0, 0, False, 0, name)
    pass_id, batch_id = int(m.group(1)), int(m.group(2))
    return (1, pass_id, batch_id == 0, batch_id, name)


def _latest_name(directory: str) -> Optional[str]:
    try:
        with open(os.path.join(directory, "LATEST")) as f:
            return f.read().strip() + ".npz"
    except FileNotFoundError:
        return None


def _scan(directory: str):
    if not os.path.isdir(directory):
        return []
    return [n for n in os.listdir(directory)
            if n.startswith("checkpoint-") and n.endswith(".npz")]


def candidates(directory: str):
    """Generation file names of ``directory``, newest first: the LATEST
    target, then the directory by generation (which covers a torn
    pointer)."""
    names = []
    latest = _latest_name(directory)
    if latest:
        names.append(latest)
    names.extend(n for n in sorted(_scan(directory), key=_gen_key,
                                   reverse=True) if n not in names)
    return names


class Checkpointer:
    """Cadenced, integrity-checked, garbage-collected checkpoint writer."""

    KEEP = 3  # generations kept (the JAX package's default)
    # age before an orphaned '.tmp' is swept: a young one may be another
    # process's write in progress (a shared save directory)
    ORPHAN_TMP_AGE_S = 60.0

    def __init__(self, directory: str, *, saving_period: int = 1,
                 saving_period_by_batches: Optional[int] = None,
                 background: bool = False):
        self.dir = directory
        self.saving_period = max(1, saving_period)
        self.saving_period_by_batches = saving_period_by_batches
        self.background = background
        os.makedirs(self.dir, exist_ok=True)
        self._q: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._worker_err: Optional[BaseException] = None
        # seconds the caller's thread spent in each save (the host copy,
        # and in the foreground the write too)
        self.save_seconds = []

    # ------------------------------------------------------------ write
    def _ckpt_path(self, pass_id: int, batch_id: int) -> str:
        return os.path.join(self.dir,
                            f"checkpoint-p{pass_id:05d}-b{batch_id:08d}")

    def save(self, params, opt_state, *, pass_id: int, batch_id: int = 0,
             end_of_pass: bool = False, trainer_state: Optional[Any] = None):
        """Unconditional save, pointer update and garbage collection.
        ``params``, ``opt_state`` and ``trainer_state`` may be zero-argument
        callables. The copy to the host happens here, on the caller's
        thread; in background mode only the file I/O is deferred."""
        t0 = time.perf_counter()
        meta = {"pass_id": pass_id, "batch_id": batch_id,
                "end_of_pass": end_of_pass, "time": time.time()}
        path = self._ckpt_path(pass_id, batch_id)
        arrays = snapshot_arrays(params, opt_state, trainer_state)
        if self.background:
            self._raise_worker_err()
            self._ensure_worker()
            try:
                self._q.put_nowait((path, arrays, meta))
            except queue.Full:
                logger.warning(
                    "checkpoint writer backlog (disk slower than the save "
                    "cadence): blocking the step loop until a generation "
                    "drains")
                self._q.put((path, arrays, meta))
        else:
            self._write(path, arrays, meta)
        self.save_seconds.append(time.perf_counter() - t0)
        return path

    def _write(self, path: str, arrays, meta: dict):
        real = write_snapshot(path, arrays, meta)
        # the pointer after the data is durable: recovery reads the
        # pointer, verifies, and falls back to the directory scan
        tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(os.path.basename(path))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, "LATEST"))
        self._gc()
        logger.info("checkpoint saved: %s", path)
        if _chaos._ACTIVE is not None:
            _chaos._ACTIVE.hit("checkpoint", path=real)
        return path

    # ------------------------------------------------- background plumbing
    def _ensure_worker(self):
        if self._worker is not None and self._worker.is_alive():
            return
        # at most 2 generations in flight: a third save blocks (with a
        # warning) rather than dropping a due generation
        self._q = queue.Queue(maxsize=2)
        self._worker = threading.Thread(target=self._work, daemon=True,
                                        name="checkpoint-writer")
        self._worker.start()

    def _work(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                self._write(*item)
            except BaseException as e:  # surfaced at the next save/flush
                self._worker_err = e
                logger.error("background checkpoint write failed: %r", e)
            finally:
                self._q.task_done()

    def _raise_worker_err(self):
        if self._worker_err is not None:
            err, self._worker_err = self._worker_err, None
            if not isinstance(err, Exception):
                raise err  # a chaos kill parked by the writer: as itself
            raise RuntimeError("background checkpoint writer failed") from err

    def flush(self):
        """Drain pending background writes (no-op in the foreground)."""
        if self._q is not None:
            self._q.join()
        self._raise_worker_err()

    def close(self):
        if self._worker is not None and self._worker.is_alive():
            self._q.join()
            self._q.put(None)
            self._worker.join(timeout=10.0)
        self._worker = None
        self._raise_worker_err()

    def maybe_save(self, params, opt_state, *, pass_id: int,
                   batch_id: int = 0, end_of_pass: bool = False,
                   trainer_state: Optional[Any] = None) -> bool:
        """The cadence around ``save``."""
        due = end_of_pass and (pass_id + 1) % self.saving_period == 0
        if (self.saving_period_by_batches and batch_id
                and batch_id % self.saving_period_by_batches == 0):
            due = True
        if not due:
            return False
        self.save(params, opt_state, pass_id=pass_id, batch_id=batch_id,
                  end_of_pass=end_of_pass, trainer_state=trainer_state)
        return True

    def _gc(self):
        ckpts = sorted(_scan(self.dir), key=_gen_key)
        latest = _latest_name(self.dir)
        for name in ckpts[:-self.KEEP]:
            if name == latest:
                continue
            for suffix in ("", ".meta"):
                try:
                    os.remove(os.path.join(self.dir, name + suffix))
                except FileNotFoundError:
                    pass
        # a kill in a write leaves a '.tmp' that nothing else matches
        now = time.time()
        for name in os.listdir(self.dir):
            if name.startswith("checkpoint-") and name.endswith(".tmp"):
                path = os.path.join(self.dir, name)
                try:
                    if now - os.path.getmtime(path) >= self.ORPHAN_TMP_AGE_S:
                        os.remove(path)
                except FileNotFoundError:
                    pass

    # ------------------------------------------------------------- read
    def _quarantine(self, path: str, err: BaseException):
        """Move a corrupt generation aside (``.bad``), so that no later
        restore or garbage collection reads it; not fatal."""
        logger.warning("quarantining corrupt checkpoint %s as %s.bad: %s",
                       path, path, err)
        for suffix in ("", ".meta"):
            try:
                os.replace(path + suffix, path + suffix + ".bad")
            except FileNotFoundError:
                pass

    def restore(self) -> Optional[Tuple[dict, dict, dict]]:
        """(params, opt_flat, meta) of the newest intact generation, or
        None. ``meta["trainer_state"]`` holds its ``state::`` arrays where
        it has any. A generation without its sidecar is skipped with a
        warning; one whose bytes or sidecar are corrupt is quarantined."""
        self.flush()
        for name in candidates(self.dir):
            path = os.path.join(self.dir, name)
            if not os.path.exists(path):
                continue
            if not os.path.exists(path + ".meta"):
                logger.warning("skipping checkpoint %s: no .meta sidecar "
                               "(a torn save)", path)
                continue
            try:
                with open(path + ".meta") as f:
                    meta = json.load(f)
                params, opt_flat, state = load_checkpoint(path, meta=meta)
            except Exception as e:  # a torn .npz raises BadZipFile etc.
                self._quarantine(path, e)
                continue
            if state:
                meta["trainer_state"] = state
            logger.info("restored checkpoint %s (pass %s batch %s)", path,
                        meta.get("pass_id"), meta.get("batch_id"))
            return params, opt_flat, meta
        return None

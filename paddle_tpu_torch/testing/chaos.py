"""Deterministic fault injection for the training loop: the port's copy of
the kill and checkpoint faults of ``paddle_tpu/testing/chaos.py``.

The trainer's step loop and the checkpoint writer carry named hook
points; a :class:`FaultPlan` decides, from (site, hit count) alone,
whether a hit kills the process or corrupts the checkpoint file just
written. The same plan gives the same fault schedule on every run.

Sites wired in the port:

- ``step_done``: end of each training iteration, after the checkpoint
  cadence ran (a kill there resumes from the newest durable file);
- ``checkpoint``: a checkpoint generation just became durable (info
  ``path``); a ``corrupt`` fault mutates it.

Fault types: ``kill`` (``mode`` ``"exit"`` = ``os._exit(exit_code)``, the
hard process death; ``"raise"`` = raise :class:`ChaosKilled`, the
in-process stand-in tests catch) and ``corrupt`` (``truncate``,
``bitflip``, ``bitflip_meta`` or ``delete_meta`` of the checkpoint at
``info["path"]``). A fault fires at the ``at``-th hit of its site
(counted from 1), or at every hit without ``at``.

A plan serialised as JSON in ``PADDLE_TPU_CHAOS_PLAN`` is armed by
:func:`install_from_env` (the CLI calls it)::

    {"faults": [
      {"type": "kill", "site": "step_done", "at": 5, "mode": "exit"}]}

Zero cost when disabled: every hook site checks ``chaos._ACTIVE is not
None``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, List, Optional

logger = logging.getLogger("paddle_tpu_torch.chaos")

ENV_VAR = "PADDLE_TPU_CHAOS_PLAN"
SITES = ("step_done", "checkpoint")

# the one global the hook sites poll; None == chaos disabled
_ACTIVE: Optional["FaultPlan"] = None


class ChaosKilled(BaseException):
    """In-process stand-in for a process kill (``mode: "raise"``). A
    BaseException, so ``except Exception`` recovery cannot swallow it."""


def _corrupt_file(path: str, mode: str):
    """Mutate a just-written checkpoint generation in place."""
    npz = path if path.endswith(".npz") else path + ".npz"
    if mode == "truncate":
        with open(npz, "r+b") as f:
            f.truncate(max(1, os.path.getsize(npz) // 2))
    elif mode == "bitflip":
        with open(npz, "r+b") as f:
            f.seek(max(0, os.path.getsize(npz) // 2))
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([(b[0] ^ 0xFF) if b else 0xFF]))
    elif mode == "bitflip_meta":
        with open(npz + ".meta", "r+b") as f:
            b = f.read(1)
            f.seek(0)
            f.write(bytes([(b[0] ^ 0x01) if b else 0x58]))
    elif mode == "delete_meta":
        try:
            os.remove(npz + ".meta")
        except FileNotFoundError:
            pass
    else:
        raise ValueError(f"unknown corrupt mode {mode!r}")
    logger.warning("chaos: corrupted checkpoint %s (%s)", npz, mode)


class FaultPlan:
    """A deterministic schedule of faults over named sites. Thread-safe:
    the per-site hit counters sit under one lock (the background
    checkpoint writer hits ``checkpoint`` from its thread)."""

    def __init__(self, faults: Optional[List[Dict[str, Any]]] = None,
                 exit_code: int = 17):
        self.faults = [dict(f) for f in (faults or [])]
        for f in self.faults:
            if f.get("site") not in SITES:
                raise ValueError(f"chaos site {f.get('site')!r} is not "
                                 f"wired in the port; sites: {SITES}")
            if f.get("type") not in ("kill", "corrupt"):
                raise ValueError(f"chaos fault type {f.get('type')!r}: the "
                                 "port has kill and corrupt")
        self.exit_code = int(exit_code)
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}

    def to_json(self) -> str:
        return json.dumps({"exit_code": self.exit_code,
                           "faults": self.faults})

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        """A plan as the JAX package's ``PADDLE_TPU_CHAOS_PLAN`` spells
        it (its ``seed`` is not read: the port has no random trigger)."""
        d = json.loads(text)
        return cls(faults=d.get("faults"), exit_code=d.get("exit_code", 17))

    def hit(self, site: str, **info):
        """One arrival at ``site``: may corrupt the file at
        ``info["path"]``, raise :class:`ChaosKilled` or end the process,
        per the plan. Returns the fired fault types."""
        with self._lock:
            n = self._hits.get(site, 0) + 1
            self._hits[site] = n
            due = [f for f in self.faults if f["site"] == site
                   and int(f.get("at", n)) == n]
        for f in due:
            if f["type"] == "kill":
                mode = f.get("mode", "exit")
                logger.warning("chaos: kill at %s hit %d (%s)", site, n,
                               mode)
                if mode == "raise":
                    raise ChaosKilled(f"chaos kill at {site} hit {n}")
                os._exit(f.get("exit_code", self.exit_code))
            elif "path" in info:
                _corrupt_file(info["path"], f.get("mode", "truncate"))
        return tuple(f["type"] for f in due)

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)


def install(plan: Optional[FaultPlan]):
    """Make ``plan`` the active plan (None disables chaos)."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def install_from_env(env: Optional[Dict[str, str]] = None
                     ) -> Optional[FaultPlan]:
    """Install the plan serialised in ``$PADDLE_TPU_CHAOS_PLAN``; no-op
    when it is unset."""
    text = (env or os.environ).get(ENV_VAR, "")
    if not text:
        return None
    plan = FaultPlan.from_json(text)
    logger.warning("chaos plan armed from env: %d faults", len(plan.faults))
    return install(plan)


class chaos_plan:
    """``with chaos_plan(FaultPlan(...)) as plan:``: a scoped install that
    always uninstalls, even when the body dies to a ChaosKilled."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        install(self.plan)
        return self.plan

    def __exit__(self, *exc):
        install(None)
        return False

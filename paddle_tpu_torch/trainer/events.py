"""Training event objects delivered to user event handlers.

Mirror of ``python/paddle/v2/event.py`` as ``paddle_tpu/trainer/events.py``
has it: BeginPass/EndPass, BeginIteration/EndIteration, TestResult. The
trainer calls ``event_handler(event)`` at the same points the reference
does (``python/paddle/v2/trainer.py:108-175``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


class Event:
    pass


@dataclasses.dataclass
class BeginPass(Event):
    pass_id: int


@dataclasses.dataclass
class EndPass(Event):
    pass_id: int
    evaluator: Optional[Dict[str, float]] = None


@dataclasses.dataclass
class BeginIteration(Event):
    pass_id: int
    batch_id: int


@dataclasses.dataclass
class EndIteration(Event):
    pass_id: int
    batch_id: int
    cost: float
    evaluator: Optional[Dict[str, float]] = None


@dataclasses.dataclass
class TestResult(Event):
    pass_id: int
    cost: float
    evaluator: Optional[Dict[str, float]] = None

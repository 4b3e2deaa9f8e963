"""Evaluators: the port of ``paddle_tpu/trainer/evaluators.py``.

``classification_error`` is the per-batch stat producer
(``ClassificationErrorEvaluator``, Evaluator.cpp); ``Accumulator`` sums it
on the host across batches (the CurrentEval/TotalEval split in
``TrainerInternal.cpp:160-170``).
"""

from __future__ import annotations

from typing import Dict

import torch

from paddle_tpu_torch.core.argument import Argument


def classification_error(output: Argument, label: Argument,
                         row_mask: torch.Tensor = None):
    """(errors, count) of rows whose argmax != label. ``row_mask`` ([B]
    f32, batch-bucket padding) removes dead rows from both; a sequence
    output counts its live tokens instead."""
    pred = output.value.argmax(dim=-1)
    wrong = (pred != label.value.to(pred.dtype)).to(torch.float32)
    if output.mask is not None:
        wrong = wrong * output.mask
        count = output.mask.sum()
    elif row_mask is not None:
        wrong = wrong * row_mask
        count = row_mask.sum()
    else:
        count = torch.tensor(float(wrong.shape[0]))
    return wrong.sum(), count


class Accumulator:
    """Host-side metric accumulation across batches."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, float] = {}

    def add(self, name: str, total, count):
        self.totals[name] = self.totals.get(name, 0.0) + float(total)
        self.counts[name] = self.counts.get(name, 0.0) + float(count)

    def result(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1.0)
                for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()

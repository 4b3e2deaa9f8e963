"""Learning-rate schedules, the port of ``paddle_tpu/optim/schedules.py``.

Mirrors ``paddle/parameter/LearningRateScheduler.cpp`` (created from
``OptimizationConfig.learning_rate_schedule`` with args ``decay_a``/
``decay_b``): constant, poly, caffe_poly, exp, discexp, linear, manual and
pass_manual. ``t`` is the number of samples processed, as in the
reference. The rate is a host scalar: every operation runs in float32
(``np.float32``), as the JAX package computes it on the device, so both
packages produce the same rate bit for bit up to the ``power`` routine.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def parse_manual_segments(args: str):
    """Parse ``learning_rate_args`` for the ``manual``/``pass_manual``
    schedules: ``"seg0:lr0,seg1:lr1,..."`` where segN is a cumulative
    sample (manual) or pass (pass_manual) boundary
    (``LearningRateScheduler.cpp``, SegmentsScheduler)."""
    segs = []
    for part in args.split(","):
        boundary, factor = part.split(":")
        segs.append((float(boundary), float(factor)))
    return segs


def learning_rate_at(schedule: str, lr0: float, a: float, b: float, t,
                     args: str = "", num_passes=0) -> np.float32:
    t = _F(t)
    if schedule in ("constant", "", None):
        return _F(lr0)
    if schedule == "poly":
        return _F(lr0) * np.power(_F(1.0) + _F(a) * t, _F(-b))
    if schedule == "caffe_poly":
        return _F(lr0) * np.power(_F(1.0) - t / _F(a), _F(b))
    if schedule == "exp":
        return _F(lr0) * np.power(_F(a), t / _F(b))
    if schedule == "discexp":
        return _F(lr0) * np.power(_F(a), np.floor(t / _F(b)))
    if schedule == "linear":
        return np.maximum(_F(lr0) - _F(a) * t, _F(b))
    if schedule in ("manual", "pass_manual"):
        # piecewise-constant over cumulative samples (manual) or pass id
        # (pass_manual); the last segment extends to infinity as in the
        # reference (SegmentsScheduler falls through to the final value)
        key = _F(num_passes) if schedule == "pass_manual" else t
        segs = parse_manual_segments(args)
        lr = _F(lr0 * segs[-1][1])
        for boundary, factor in reversed(segs[:-1]):
            if key < _F(boundary):
                lr = _F(lr0 * factor)
        return lr
    raise KeyError(f"unknown learning_rate_schedule {schedule!r}")

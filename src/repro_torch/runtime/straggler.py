"""Straggler detection (port of ``repro.runtime.straggler``).

The monitor keeps an EWMA + variance of step times and flags outliers
(> mean + k*std and > slack*mean).  The training loop reports the number of
flagged steps; the resilient driver (``runtime/fault_tolerance.py``)
commits an early checkpoint on each, and an elastic resume resets the
statistics.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    mean: float
    std: float


class StragglerMonitor:
    def __init__(self, alpha: float = 0.05, k_std: float = 4.0,
                 slack: float = 1.5, warmup_steps: int = 10):
        self.alpha = alpha
        self.k_std = k_std
        self.slack = slack
        self.warmup = warmup_steps
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.n = 0
        self.events: List[StragglerEvent] = []
        self._t0: Optional[float] = None

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self, step: int) -> Optional[StragglerEvent]:
        if self._t0 is None:
            # start_step never ran for this step: nothing valid to measure
            return None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(step, dt)

    def reset(self):
        """Forget the timing statistics (not the recorded events)."""
        self.mean = None
        self.var = 0.0
        self.n = 0
        self._t0 = None

    def observe(self, step: int, dt: float) -> Optional[StragglerEvent]:
        self.n += 1
        if self.mean is None:
            self.mean = dt
            return None
        is_outlier = False
        std = self.var ** 0.5
        if self.n > self.warmup:
            is_outlier = dt > self.mean + self.k_std * std and dt > self.slack * self.mean
        if not is_outlier:
            # EWMA updates exclude outliers so one straggler doesn't poison stats
            d = dt - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
            return None
        ev = StragglerEvent(step, dt, self.mean, std)
        self.events.append(ev)
        return ev

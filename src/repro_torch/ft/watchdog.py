"""Straggler / hang detection: per-step wall-time EMA watchdog.

On real pods, a straggling host shows up as a slow step on every host (SPMD
lockstep).  The watchdog flags steps slower than ``threshold x EMA`` and
escalates after ``patience`` consecutive flags — the trainer responds by
checkpoint-and-restart (which re-schedules around the sick host) per
standard practice.  A copy of ``repro.ft.watchdog`` (pure Python); the step
times it sees are host times, which run ahead of the card until its launch
queue fills.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class StepWatchdog:
    threshold: float = 3.0
    patience: int = 3
    decay: float = 0.9
    warmup: int = 5

    ema: Optional[float] = None
    seen: int = 0
    consecutive: int = 0
    events: List[dict] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> bool:
        """Record step time; returns True when escalation is warranted."""
        dt = time.perf_counter() - self._t0
        return self.record(step, dt)

    def record(self, step: int, dt: float) -> bool:
        self.seen += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_slow = self.seen > self.warmup and dt > self.threshold * self.ema
        if is_slow:
            self.consecutive += 1
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
        else:
            self.consecutive = 0
            self.ema = self.decay * self.ema + (1 - self.decay) * dt
        return self.consecutive >= self.patience

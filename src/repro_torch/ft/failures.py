"""Failure injection for fault-tolerance tests (simulated preemptions).

A copy of ``repro.ft.failures`` (pure Python).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Set


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Raises SimulatedFailure at the configured steps (once each).

    Configure via ``fail_at`` or env REPRO_FAIL_AT="7,23".
    """
    fail_at: Set[int] = field(default_factory=set)
    fired: Set[int] = field(default_factory=set)

    def __post_init__(self):
        env = os.environ.get("REPRO_FAIL_AT", "")
        if env:
            self.fail_at |= {int(x) for x in env.split(",") if x}

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")

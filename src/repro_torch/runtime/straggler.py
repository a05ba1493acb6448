"""Straggler detection: per-host step-time EWMA with deviation flags (a
copy of ``repro/runtime/straggler.py``, which imports no JAX).

At pod scale the slowest host sets the step time (synchronous SPMD).
The monitor tracks an EWMA and EW-variance of per-host step durations
(heartbeats); hosts exceeding ``threshold`` sigma above the fleet EWMA
for ``patience`` consecutive steps are flagged. The driver's policy
hook then decides: warn, exclude from the next elastic re-mesh
(runtime.elastic), or trigger a checkpoint-and-restart.

This is the framework-level analogue of MapReduce speculative
execution — but for SPMD the remedy is re-meshing, not task
duplication (you cannot speculate half an all-reduce).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional


@dataclasses.dataclass
class HostStat:
    ewma: float = 0.0
    ewvar: float = 0.0
    n: int = 0
    strikes: int = 0


class StragglerMonitor:
    def __init__(self, num_hosts: int, *, alpha: float = 0.2,
                 threshold: float = 3.0, patience: int = 3,
                 on_straggler: Optional[Callable[[int, float], None]]
                 = None):
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.hosts = [HostStat() for _ in range(num_hosts)]
        self.on_straggler = on_straggler
        self.flagged: set[int] = set()

    def fleet_ewma(self) -> float:
        vals = [h.ewma for h in self.hosts if h.n > 0]
        return sum(vals) / len(vals) if vals else 0.0

    def fleet_std(self) -> float:
        vals = [h.ewvar for h in self.hosts if h.n > 0]
        return math.sqrt(sum(vals) / len(vals)) if vals else 0.0

    def record(self, host: int, step_time: float) -> bool:
        """Returns True if this host is (still) flagged a straggler."""
        h = self.hosts[host]
        if h.n == 0:
            h.ewma = step_time
        delta = step_time - h.ewma
        h.ewma += self.alpha * delta
        h.ewvar = (1 - self.alpha) * (h.ewvar + self.alpha * delta ** 2)
        h.n += 1
        fleet = self.fleet_ewma()
        std = max(self.fleet_std(), 1e-6, 0.05 * fleet)
        if h.n >= 3 and step_time > fleet + self.threshold * std:
            h.strikes += 1
        else:
            h.strikes = 0
            self.flagged.discard(host)
        if h.strikes >= self.patience and host not in self.flagged:
            self.flagged.add(host)
            if self.on_straggler:
                self.on_straggler(host, step_time)
        return host in self.flagged

    def healthy_hosts(self) -> list[int]:
        return [i for i in range(len(self.hosts))
                if i not in self.flagged]

"""Per-phase timing — the framework's profiling facility (counterpart of
solve_keyframe_pose_graph_tpu/utils/timing.py).

The reference's only profiling is ElapsedTime tic/toc prints around solver
phases (utils/ElapsedTime.h, PoseGraphSLAM.cpp:1916-1922). Here: a
context-manager stopwatch that accumulates named phase timings and emits
structured JSON, so every trigger's breakdown (allocation, guesses, build,
device solve, write-back) is machine-readable.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.last[name] = dt

    def snapshot(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name] / max(self.counts[name], 1),
                "last_ms": 1000.0 * self.last.get(name, 0.0),
            }
            for name in self.totals
        }

    def report_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self.last.clear()

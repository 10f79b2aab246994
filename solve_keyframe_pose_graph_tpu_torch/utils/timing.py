"""Per-phase timing and the program's spans — the framework's profiling
facility (counterpart of solve_keyframe_pose_graph_tpu/utils/timing.py,
which keeps the totals alone).

The reference's only profiling is ElapsedTime tic/toc prints around solver
phases (utils/ElapsedTime.h, PoseGraphSLAM.cpp:1916-1922). Here: a
context-manager stopwatch that accumulates named phase timings and emits
structured JSON, so every trigger's breakdown (allocation, guesses, build,
device solve, write-back) is machine-readable.

Each phase is also a span, stamped on CLOCK_MONOTONIC (time.monotonic, the
clock the benchmark's stamps use). span(name) is a phase that keeps no
totals, for a module that holds no PhaseTimer (ops/graphs.py).
Spans nest per thread: a span's path is its parent's path, "/", its name.
While a Record is open on a thread (recording(), the engine's trigger),
every span that thread closes goes into it as (path, start, end): a Record
holds one thread's spans. While a torch profiler is recording, each
span also opens record_function("kpg." + name), so that it sits in the
profile beside the kernels it launched, on the profile's own clock. With
no Record and no profiler a span costs two clock reads and a check.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _profiler

_tls = threading.local()      # per thread: the open Record, the span path


class Record:
    """The spans of one unit of work (a trigger), from the one thread that
    ran it, on the monotonic clock from t_start."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.spans: list = []         # (path, start, end), as they close

    def spans_ms(self) -> dict:
        """{path: [ms from t_start to its first start, total ms]}: a path
        that ran more than once sums its durations."""
        out: dict = {}
        for path, t0, t1 in self.spans:
            at = 1000.0 * (t0 - self.t_start)
            prev = out.get(path)
            out[path] = ([at, 1000.0 * (t1 - t0)] if prev is None else
                         [min(prev[0], at), prev[1] + 1000.0 * (t1 - t0)])
        return out

    def total_ms(self, *names) -> Optional[float]:
        """The summed ms of every span whose name is one of `names`, at any
        depth; None where there is none."""
        ms = [1000.0 * (t1 - t0) for path, t0, t1 in self.spans
              if path.rsplit("/", 1)[-1] in names]
        return sum(ms) if ms else None


@contextlib.contextmanager
def recording(record: Record):
    """This thread's spans go into `record` within the context, their paths
    starting afresh at its top level."""
    saved = (getattr(_tls, "record", None), getattr(_tls, "path", ""))
    _tls.record, _tls.path = record, ""
    try:
        yield record
    finally:
        _tls.record, _tls.path = saved


class _Span:
    __slots__ = ("name", "timer", "record", "parent", "range", "t0")

    def __init__(self, name: str, timer: Optional["PhaseTimer"] = None):
        self.name = name
        self.timer = timer

    def __enter__(self):
        self.record = getattr(_tls, "record", None)
        self.parent = parent = getattr(_tls, "path", "")
        _tls.path = f"{parent}/{self.name}" if parent else self.name
        self.range = None
        # the profiler's own state: the Python-side flag stays set after
        # torch.autograd._disable_profiler(), which the benchmark ends its
        # session with
        if torch._C._autograd._profiler_enabled():
            self.range = _profiler.record_function("kpg." + self.name)
            self.range.__enter__()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic()
        if self.range is not None:
            self.range.__exit__(*exc)
        path = _tls.path
        _tls.path = self.parent
        if self.record is not None:
            self.record.spans.append((path, self.t0, t1))
        if self.timer is not None:
            self.timer.add(self.name, t1 - self.t0)
        return False


def span(name: str) -> _Span:
    """A span with no totals (see the module note)."""
    return _Span(name)


class PhaseTimer:
    """Totals, counts and the last duration per phase name. The engine's
    threads (its solver loop, warmup and background escalation) and the
    status query share one, so each update and snapshot takes its lock."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}
        self._lock = threading.Lock()

    def phase(self, name: str) -> _Span:
        """A span whose duration also goes into the totals."""
        return _Span(name, self)

    def add(self, name: str, seconds: float) -> None:
        """Count `seconds` under `name`, measured elsewhere, as a phase."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1
            self.last[name] = seconds

    def snapshot(self) -> dict:
        with self._lock:
            return {
                name: {
                    "total_s": self.totals[name],
                    "count": self.counts[name],
                    "mean_ms": 1000.0 * self.totals[name]
                    / max(self.counts[name], 1),
                    "last_ms": 1000.0 * self.last.get(name, 0.0),
                }
                for name in self.totals
            }

    def report_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2)

    def reset(self):
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.last.clear()

"""Colored logging + periodic status (TermColor / queue-printer analogs;
counterpart of solve_keyframe_pose_graph_tpu/utils/log.py).

The reference logs with raw ANSI escape strings (utils/TermColor.h) and runs
a 1 Hz queue-length printer thread (keyframe_pose_graph_slam_node.cpp:62-71
-> NodeDataManager.cpp:257-269). Here: a logging.Formatter with per-level
colors plus a StatusPrinter that renders the same one-line summary
(node/edge counts, kidnap status, solver state) on demand or on an interval.
"""

from __future__ import annotations

import logging
import sys
import time

RESET = "\033[0m"
COLORS = {
    logging.DEBUG: "\033[36m",      # cyan
    logging.INFO: "\033[32m",       # green
    logging.WARNING: "\033[33m",    # yellow
    logging.ERROR: "\033[31m",      # red
    logging.CRITICAL: "\033[91m",   # iRED
}

SOLVER_STATUS = {
    -1: "idle", 0: "sleep", 1: "setup", 2: "solving", 3: "done",
}


class ColorFormatter(logging.Formatter):
    def __init__(self, fmt="%(asctime)s %(levelname)s %(name)s: %(message)s"):
        super().__init__(fmt, datefmt="%H:%M:%S")

    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            color = COLORS.get(record.levelno, "")
            return f"{color}{msg}{RESET}"
        return msg


def get_logger(name: str = "kpg", level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(ColorFormatter())
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class StatusPrinter:
    """Periodic one-line pipeline status (the 1 Hz printer thread analog)."""

    def __init__(self, store, engine, interval_s: float = 1.0,
                 logger=None):
        self.store = store
        self.engine = engine
        self.interval_s = interval_s
        self.logger = logger or get_logger()
        self._last = 0.0

    def line(self) -> str:
        st = SOLVER_STATUS.get(self.engine.status, "?")
        kid = "KIDNAPPED" if self.store.current_kidnap_status else "ok"
        return (f"nodes={self.store.node_len} edges={self.store.edge_len} "
                f"worlds={self.store.n_worlds()} "
                f"solved_until={self.engine.solved_until} "
                f"solver={st} kidnap={kid} "
                f"triggers={self.engine.trigger_id} "
                f"convergences={self.engine.n_solve_convergences}")

    def tick(self, force: bool = False) -> None:
        now = time.monotonic()
        if force or now - self._last >= self.interval_s:
            self._last = now
            self.logger.info(self.line())

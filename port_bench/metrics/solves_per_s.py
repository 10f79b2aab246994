"""solves_per_s (solves/s): the triggers that solved and returned in the
window, over the window's seconds; in a traced run, both outside the span
in which the profiler session held the solver thread
(records.loop_triggers)."""

from port_bench.harness import records


def read(rec):
    rows, seconds = records.loop_triggers(rec)
    return len(rows) / seconds if seconds > 0 else None

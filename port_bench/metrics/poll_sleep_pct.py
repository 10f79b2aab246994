"""poll_sleep_pct (%): the share of the window in which the solver thread
was between a trigger() that found no new loop edge and its next call:
the product's poll sleep (SolverEngine.run), from the trigger stamps; in a
traced run, of the window outside the span in which the profiler session
held the solver thread (records.profiler_hold)."""

from port_bench.harness import records


def _overlap(a0, a1, b0, b1):
    return max(0.0, min(a1, b1) - max(a0, b0))


def read(rec):
    t0, t1 = rec["t0"], rec["t_end"]
    on, off = records.profiler_hold(rec)
    rows = rec["triggers"]
    slept = 0.0
    for a, b in zip(rows, rows[1:]):
        if not a["fired"]:
            lo, hi = max(a["ret"], t0), min(b["call"], t1)
            slept += _overlap(lo, hi, t0, t1) - _overlap(lo, hi, on, off)
    seconds = t1 - t0 - (off - on)
    return 100.0 * slept / seconds if seconds > 0 else None

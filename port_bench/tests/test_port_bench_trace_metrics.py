"""The readers of the program's own spans (edge_wait_ms, lock_wait_ms,
launch_ms, result_wait_ms) on a synthetic record, and on one whose
solve_stats rows lack their fields, as a program without the spans
writes them; in a traced run, only the solves that returned before its
profiler session."""

from __future__ import annotations

import pytest

from port_bench.harness import manifest

NAMES = ("edge_wait_ms", "lock_wait_ms", "launch_ms", "result_wait_ms")


def _record(traced: bool = True):
    def stats(taken, wait_sum, lock, launch, read):
        row = {"node_len": 5110, "edge_len": 13, "cg_iterations": 200,
               "problem_build_ms": 4.0, "trigger_wall_ms": 138.0}
        if traced:
            row.update(edges_taken=taken, edge_wait_sum_ms=wait_sum,
                       edge_wait_max_ms=None if not taken else wait_sum,
                       lock_wait_ms=lock, launch_ms=launch,
                       result_wait_ms=read)
        return row

    return {
        "t0": 100.0, "t_end": 101.0,
        "triggers": [
            # before the window: left out
            {"call": 99.0, "ret": 99.5, "fired": True,
             "stats": stats(4, 4000.0, 50.0, 9.0, 900.0)},
            {"call": 100.5, "ret": 100.64, "fired": True,
             "stats": stats(3, 1500.0, 0.5, 0.25, 60.0)},
            # a poll that found nothing
            {"call": 100.64, "ret": 100.64, "fired": False, "stats": None},
            {"call": 100.64, "ret": 100.78, "fired": True,
             "stats": stats(1, 100.0, 1.5, 0.75, 80.0)},
            # a solve whose edges all lacked a stamp, on the eager path
            {"call": 100.78, "ret": 100.9, "fired": True,
             "stats": stats(0, 0.0, 2.5, None, None)},
        ],
    }


READ = {
    "edge_wait_ms": (1500.0 + 100.0) / (3 + 1),
    "lock_wait_ms": (0.5 + 1.5 + 2.5) / 3,
    "launch_ms": (0.25 + 0.75) / 2,
    "result_wait_ms": (60.0 + 80.0) / 2,
}
# with the profiler session started at 100.7: the first solve alone
BEFORE_70 = {
    "edge_wait_ms": 1500.0 / 3,
    "lock_wait_ms": 0.5,
    "launch_ms": 0.25,
    "result_wait_ms": 60.0,
}


@pytest.mark.parametrize("name", NAMES)
def test_reader(name):
    assert manifest.reader(name)(_record()) == pytest.approx(READ[name])


@pytest.mark.parametrize("name", NAMES)
def test_reader_leaves_out_the_profiled_solves(name):
    """A traced run's profiler session starts at profile t_on: the solves
    that returned from then on (under the session and after it) are left
    out, as they read the profiler's cost."""
    rec = _record()
    rec["triggers"] += [
        {"call": 100.9, "ret": 100.95, "fired": True,
         "stats": dict(rec["triggers"][1]["stats"], edges_taken=5,
                       edge_wait_sum_ms=9000.0, lock_wait_ms=40.0,
                       launch_ms=7.0, result_wait_ms=700.0)}]
    rec["profile"] = {"t_on": 100.92, "t_off": 100.99}
    assert manifest.reader(name)(rec) == pytest.approx(READ[name])
    rec["profile"] = {"t_on": 100.7, "t_off": 100.99}
    assert manifest.reader(name)(rec) == pytest.approx(BEFORE_70[name])


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_rows_without_the_spans(name):
    assert manifest.reader(name)(_record(traced=False)) is None


@pytest.mark.parametrize("name", NAMES)
def test_in_the_manifest(name):
    bench = manifest.load()
    m = [m for m in bench["per_layer"] if m["name"] == name]
    assert len(m) == 1 and "workloads" not in m[0]
    assert (m[0]["source"], m[0]["moves"], m[0]["unit"]) == (
        "program_span", "loop_latency_p95_ms", "ms")

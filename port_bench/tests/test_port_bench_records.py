"""The latency arithmetic and every metric reader on a synthetic record."""

from __future__ import annotations

import numpy as np
import pytest

from port_bench.harness import manifest, records, roofline


def _record():
    t0 = 100.0
    stats = (lambda n, e, cg, build, wall: {
        "node_len": n, "edge_len": e, "cg_iterations": cg,
        "problem_build_ms": build, "trigger_wall_ms": wall,
        "trigger_captures": 0, "lm_iterations": 10})
    triggers = [
        # a solve before the window, then a poll that found nothing
        {"call": 99.0, "ret": 99.5, "fired": True, "edge_len": 10,
         "device_solve_ms": 400.0, "stats": stats(5100, 10, 300, 4.0, 410.0)},
        {"call": 99.5, "ret": 99.5, "fired": False, "edge_len": 10,
         "device_solve_ms": None, "stats": None},
        # asleep until 100.5; then two solves in the window
        {"call": 100.5, "ret": 100.64, "fired": True, "edge_len": 13,
         "device_solve_ms": 130.0, "stats": stats(5110, 13, 200, 4.0, 138.0)},
        {"call": 100.64, "ret": 100.78, "fired": True, "edge_len": 14,
         "device_solve_ms": 132.0, "stats": stats(5111, 14, 220, 6.0, 140.0)},
        {"call": 100.78, "ret": 100.78, "fired": False, "edge_len": 14,
         "device_solve_ms": None, "stats": None},
        {"call": 101.28, "ret": 101.28, "fired": False, "edge_len": 14,
         "device_solve_ms": None, "stats": None},
    ]
    return {
        "t0": t0, "t_end": t0 + 1.0, "seconds": 1.0, "drain_s": 0.0,
        "setup_s": 12.5, "memory_peak_bytes": 300 * 2 ** 20,
        # edges 10, 11, 12 due at 100.0, 100.1, 100.55; 13 at 100.6
        "edges": {"due": [100.0, 100.1, 100.55, 100.6],
                  "done": [100.64, 100.64, 100.64, 100.78],
                  "first_index": 10},
        "queries": [[100.0, 100.001, True], [100.5, 100.504, True],
                    [101.5, 101.6, True]],
        "triggers": triggers,
        "capacity": {"initial_nodes": 1024, "initial_edges": 256},
        "formulation": {"fanout": 5, "bcr_levels": 2, "dtype": "float32"},
        "profile": {
            "solves": [t["stats"] for t in triggers[2:4]],
            "span_ns": 280_000_000, "busy_ns": 252_000_000,
            "by_name": {
                "void band_matvec_kernel<float>(...)": [420, 420 * 8_000],
                "void gj_inv_kernel<float>(...)": [60, 60 * 9_000],
                "void gemvx<float>(...)": [10_000, 40_000_000],
                "elementwise": [30_000, 150_000_000]},
            "gaps": [["build", 4_000_000]], "k1_counted": 420},
    }


def test_edge_latencies():
    rec = _record()
    lat = records.edge_latencies_ms(rec)
    assert lat == pytest.approx([640.0, 540.0, 90.0, 180.0])
    assert records.percentile(lat, 50) == pytest.approx(360.0)
    assert records.percentile(lat, 95) == pytest.approx(625.0)


def test_an_uncorrected_edge_counts_to_the_drains_end():
    rec = _record()
    rec["edges"]["done"][3] = None
    rec["drain_s"] = 2.0
    assert records.edge_latencies_ms(rec)[3] == pytest.approx(2400.0)


def test_query_latencies():
    # the query due at 101.5 is past the window
    assert records.query_latencies_ms(_record()) == pytest.approx([1.0, 4.0])


def test_window_rows():
    rec = _record()
    assert len(records.window_triggers(rec)) == 2
    assert [r["edge_len"] for r in records.window_solves(rec)] == [13, 14]
    assert records.profiled_bucket(rec) == (8192, 256)


READ = {
    "loop_latency_p95_ms": 625.0,
    "solves_per_s": 2.0,
    "setup_s": 12.5,
    # asleep from 100.0 (the window's start) to 100.5 and from 100.78
    "poll_sleep_pct": 100.0 * (0.5 + 0.22),
    "trigger_host_ms": ((138.0 - 126.0) + (140.0 - 126.0)) / 2,
    "problem_build_ms": 5.0,
    "solve_ms": 126.0,
    "cg_iters_per_solve": 210.0,
    "precond_gemv_ms": 20.0,
    "device_idle_pct": 10.0,
    "device_mem_peak_mb": 300.0,
}


@pytest.mark.parametrize("name", sorted(READ))
def test_reader(name):
    assert manifest.reader(name)(_record()) == pytest.approx(READ[name])


def test_roofline_readers():
    rec = _record()
    k1 = manifest.reader("k1_roofline")(rec)
    want = roofline.k1_launch_s(8192, 5, 4) / 8e-6 * 100
    assert k1 == pytest.approx(want)
    # 7.47 MB at N = 8192, F = 5 against 3.35 TB/s
    assert roofline.k1_launch_s(8192, 5, 4) * 3.35e12 == pytest.approx(
        228 * 8192 * 4)
    # 8192 nodes: 1639 super-nodes, padded to 2048; two levels and a root
    assert roofline.k2_blocks(8192, 5, 2) == [1024, 512, 512]
    k2 = manifest.reader("k2_roofline")(rec)
    it = roofline.k2_iteration_s(8192, 5, 2, 4)
    assert k2 == pytest.approx(100 * it * 20 / (60 * 9e-6))


def test_the_profilers_hold_is_left_out_of_the_loop():
    """In a traced run the solver loop's host-clock metrics leave out the
    span in which the profiler session held the solver thread."""
    rec = _record()
    rec["profile"].update(t_on=100.7, t_off=100.9)
    rows, seconds = records.loop_triggers(rec)
    assert [r["edge_len"] for r in rows] == [13] and seconds == \
        pytest.approx(0.8)
    assert manifest.reader("solves_per_s")(rec) == pytest.approx(1 / 0.8)
    # asleep 100.0-100.5, and 100.9-101.0 of 100.78-101.0
    assert manifest.reader("poll_sleep_pct")(rec) == pytest.approx(
        100 * 0.6 / 0.8)


def test_readers_return_nothing_without_a_profile():
    rec = _record()
    rec["profile"] = None
    for name in ("precond_gemv_ms", "k1_roofline", "k2_roofline",
                 "device_idle_pct"):
        assert manifest.reader(name)(rec) is None


def test_percentile_is_numpys():
    v = np.arange(101.0)
    assert records.percentile(v, 95) == 95.0
    assert records.percentile([], 95) is None

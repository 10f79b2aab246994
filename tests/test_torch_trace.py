"""PyTorch port: the program's own spans and counters (utils/timing.py).

A trigger's solve_stats row carries its spans on the monotonic clock
(t_start, t_end, spans_ms), its lock waits, launch and host-read times,
the poll's sleeps so far and its new loop edges' waits in the store; the
spans sit in a torch profile as kpg.* ranges while one records; the
server's status query reports the ingest, assembler and poll counters.
Each engine runs on the CPU at a tiny size."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu.utils import timing as jtiming
from solve_keyframe_pose_graph_tpu_torch import config as c
from solve_keyframe_pose_graph_tpu_torch.compose.composer import Composer
from solve_keyframe_pose_graph_tpu_torch.graph import messages as msgs
from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.runtime_server import (
    PoseGraphServer,
)
from solve_keyframe_pose_graph_tpu_torch.solver.engine import SolverEngine
from solve_keyframe_pose_graph_tpu_torch.utils import timing

from test_torch_threads import one_torch_thread  # noqa: F401

T0, DT = 1_000_000_000, 100_000_000
GRAPH = synthetic.circle_graph(n_nodes=40, n_loops=6, seed=3)


def _config(**stream):
    # two LM iterations of a tiny graph: the spans, not the solve, are
    # under test
    return c.Config(
        solver=c.SolverConfig(dtype="float64", adaptive_fp64=False,
                              max_lm_iterations=2, max_cg_iterations=8),
        stream=c.StreamConfig(**stream),
        capacity=c.CapacityConfig(initial_nodes=64, initial_edges=16))


def _engine(store=None, **stream):
    store = GraphStore() if store is None else store
    return store, SolverEngine(store, _config(**stream), device="cpu")


def _nodes(store, n=GRAPH.n_nodes):
    for i in range(n):
        store.add_node(T0 + i * DT, GRAPH.vio_q[i], GRAPH.vio_t[i])


def _edge(store, k):
    a, b = map(int, GRAPH.loop_pairs[k])
    return store.add_loop_edge_by_index(a, b, GRAPH.loop_q[k],
                                        GRAPH.loop_t[k], 1.0)


class _Clock:
    def __init__(self, now):
        self.now = now

    def __call__(self):
        return self.now


def test_edge_waits_on_a_patched_clock(monkeypatch):
    store, eng = _engine()
    _nodes(store)
    clock = _Clock(1.0)
    monkeypatch.setattr(time, "monotonic", clock)
    _edge(store, 0)
    clock.now = 1.2
    _edge(store, 1)
    clock.now = 1.5
    assert eng.trigger()
    row = eng.solve_stats[-1]
    assert row["edge_from"] == 0 and row["edges_taken"] == 2
    assert row["edge_wait_sum_ms"] == pytest.approx(800.0)
    assert row["edge_wait_max_ms"] == pytest.approx(500.0)
    assert row["t_start"] == 1.5


def test_an_edge_counted_before_its_stamp_is_left_out():
    """The native store counts an edge before its binding appends the
    stamp: a trigger between the two reads the stamps there are."""
    store, eng = _engine()
    _nodes(store)
    for k in range(3):
        _edge(store, k)
    late = store.edge_arrivals.pop()
    assert eng.trigger()
    row = eng.solve_stats[-1]
    assert (row["edge_from"], row["edges_taken"]) == (0, 2)
    assert row["edge_wait_max_ms"] >= 0.0
    store.edge_arrivals.append(late)        # the binding catches up
    _edge(store, 3)
    assert eng.trigger()
    row = eng.solve_stats[-1]
    assert (row["edge_from"], row["edges_taken"]) == (3, 1)


def test_edges_loaded_from_disk_carry_no_wait(tmp_path):
    store, _ = _engine()
    _nodes(store)
    for k in range(3):
        _edge(store, k)
    path = str(tmp_path / "g.json")
    store.save_as_json(path)
    loaded = GraphStore.load_from_json(path)
    assert np.isnan(loaded.edge_arrivals).all()
    _, eng = _engine(loaded)
    assert eng.trigger()
    row = eng.solve_stats[-1]
    assert row["edges_taken"] == 0 and row["edge_wait_sum_ms"] == 0.0
    assert row["edge_wait_max_ms"] is None


def _children(spans, parent):
    depth = parent.count("/") + 1 if parent else 0
    return [v[1] for p, v in spans.items() if p.count("/") == depth
            and (not parent or p.startswith(parent + "/"))]


def _check_nesting(row):
    """Every span inside [t_start, t_end], and no span's children, nor the
    top level's spans, summing past it."""
    wall = 1000.0 * (row["t_end"] - row["t_start"])
    assert row["trigger_wall_ms"] == pytest.approx(wall)
    spans = row["spans_ms"]
    for path, (at, ms) in spans.items():
        assert at >= 0.0 and ms >= 0.0, path
        assert at + ms <= wall + 1e-6, path
    assert sum(_children(spans, "")) <= wall + 1e-6
    for path, (_, ms) in spans.items():
        assert sum(_children(spans, path)) <= ms + 1e-6, path
    json.dumps(row)


def test_a_rows_spans_nest_inside_the_trigger():
    store, eng = _engine()
    _nodes(store)
    for k in range(4):
        _edge(store, k)
    assert eng.trigger()
    row = eng.solve_stats[-1]
    spans = row["spans_ms"]
    for path in ("world_mapping", "first_contact", "initial_guesses",
                 "priors", "device_solve", "device_solve/prepare",
                 "device_solve/prepare/problem_build",
                 "device_solve/device_lock_wait", "device_solve/to_host",
                 "write_back", "state_lock_wait"):
        assert path in spans, path
    _check_nesting(row)
    # the CPU solve has no composed executable to launch or read
    assert row["launch_ms"] is None and row["result_wait_ms"] is None
    assert row["lock_wait_ms"] >= 0.0
    assert eng.timer.counts["trigger_total"] == 1


def test_lock_wait_counts_a_held_state_lock():
    """Another thread holds state_lock for 50 ms across the trigger's
    write-back: the row's lock wait holds it."""
    store, eng = _engine()
    _nodes(store)
    for k in range(4):
        _edge(store, k)
    inner = eng._solve_to_host
    holding = threading.Event()

    def hold():
        with eng.state_lock:
            holding.set()
            time.sleep(0.05)

    def solve_then_hold(*a, **kw):
        out = inner(*a, **kw)
        threading.Thread(target=hold).start()
        holding.wait()
        return out

    eng._solve_to_host = solve_then_hold
    assert eng.trigger()
    row = eng.solve_stats[-1]
    assert row["spans_ms"]["state_lock_wait"][1] >= 40.0
    assert row["lock_wait_ms"] >= 40.0


def test_run_counts_its_poll_sleeps():
    store, eng = _engine()
    polls = []

    def stop():
        polls.append(1)
        return len(polls) > 3

    eng.run(poll_hz=50.0, stop_when=stop)
    assert eng.poll_sleeps == 3
    assert eng.poll_sleep_s >= 3 * 0.02 * 0.9
    _nodes(store)
    _edge(store, 0)
    assert eng.trigger()
    assert eng.solve_stats[-1]["poll_sleep_s"] == eng.poll_sleep_s


def test_the_profile_holds_the_spans_in_order(monkeypatch):
    store, eng = _engine()
    _nodes(store)
    for k in range(4):
        _edge(store, k)

    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    with monkeypatch.context() as m:
        m.setattr(torch.autograd.profiler, "record_function", refused)
        assert eng.trigger()
    _edge(store, 4)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert eng.trigger()
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.name.startswith("kpg.")]
    assert names == ["kpg." + n for n in (
        "world_mapping", "first_contact",
        "initial_guesses", "state_lock_wait", "priors",
        "device_solve", "device_lock_wait",
        "prepare", "state_lock_wait", "problem_build",      # _cover
        "device_lock_wait", "to_host",
        "state_lock_wait",                                  # its bucket
        "state_lock_wait", "write_back")]


def test_the_status_query_reports_the_trace_counters():
    store = GraphStore()
    server = PoseGraphServer(store, _config(), device="cpu")
    for i in range(5):
        server.handle_line(json.dumps(msgs.NodePoseMsg(
            T0 + i * DT, GRAPH.vio_q[i], GRAPH.vio_t[i]).to_json()))
    server.handle_line(json.dumps(msgs.LoopEdgeMsg(
        T0, T0 + 4 * DT, GRAPH.loop_q[0], GRAPH.loop_t[0]).to_json()))
    server.composer.assemble()
    server.engine.run(poll_hz=100.0,
                      stop_when=lambda: server.engine.poll_sleeps > 0)
    got = json.loads(server.handle_line(json.dumps(
        {"kind": "query", "what": "status"})))["trace"]
    assert got["ingest"]["messages"] == 6
    assert 0.0 <= got["ingest"]["lock_wait_max_s"] <= \
        got["ingest"]["lock_wait_s"]
    assert got["assembler"]["assembles"] == 1
    assert 0.0 <= got["assembler"]["state_lock_hold_max_s"] == \
        got["assembler"]["state_lock_hold_s"]
    assert got["poll"]["sleeps"] == 1 and got["poll"]["sleep_s"] > 0.0
    # the trigger's time by part, as the engine's timer has it
    phases = got["phases"]
    for name in ("world_mapping", "first_contact", "initial_guesses",
                 "priors", "device_solve", "prepare", "problem_build",
                 "to_host", "write_back", "state_lock_wait",
                 "device_lock_wait", "trigger_total", "poll_sleep"):
        assert phases[name]["count"] >= 1, name
    assert phases == json.loads(json.dumps(phases))
    assert store.edge_len == 1 and len(store.edge_arrivals) == 1


def test_composer_counts_its_hold_of_the_state_lock():
    store, eng = _engine()
    _nodes(store, 5)
    comp = Composer(store, eng)
    comp.assemble()
    comp.assemble()
    tr = comp.trace
    assert tr["assembles"] == 2
    assert 0.0 < tr["state_lock_hold_max_s"] <= tr["state_lock_hold_s"]


def test_phase_timer_add_matches_reference():
    """add() records a phase measured elsewhere as the reference's timer
    records one: the same JSON document."""
    ours, ref = timing.PhaseTimer(), jtiming.PhaseTimer()
    for name, dt in (("build", 0.25), ("solve", 1.5), ("build", 0.5)):
        ours.add(name, dt)
        ref.totals[name] += dt
        ref.counts[name] += 1
        ref.last[name] = dt
    assert ours.report_json() == ref.report_json()
    with ours.phase("write_back"), ref.phase("write_back"):
        pass
    doc, want = json.loads(ours.report_json()), json.loads(ref.report_json())
    assert set(doc) == set(want) and doc["write_back"]["count"] == 1


class _Yielding(float):
    """A duration whose addition lets another thread run between the read
    and the write of a total."""

    def __radd__(self, other):
        time.sleep(0)
        return float(other) + float(self)


def test_phase_timer_counts_every_add_across_threads():
    """The engine's threads share one timer: no update is lost."""
    timer, n, k = timing.PhaseTimer(), 8, 400

    def work():
        for _ in range(k):
            timer.add("state_lock_wait", _Yielding(0.5))

    threads = [threading.Thread(target=work) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert timer.counts["state_lock_wait"] == n * k
    assert timer.totals["state_lock_wait"] == 0.5 * n * k
    assert timer.snapshot()["state_lock_wait"]["count"] == n * k


def test_a_span_outside_a_record_keeps_nothing():
    rec = timing.Record(time.monotonic())
    with timing.span("launch"):
        with timing.recording(rec):
            with timing.span("launch"), timing.span("result_wait"):
                pass
        with timing.span("result_wait"):
            pass
    assert [p for p, _, _ in rec.spans] == ["launch/result_wait", "launch"]
    assert rec.total_ms("launch", "result_wait") >= 0.0
    assert rec.total_ms("to_host") is None


def test_a_two_world_stream_counts_its_worlds():
    """VIO lost after node 19, back before node 25: a trigger refused
    while kidnapped, then one with two worlds each anchored, then one
    whose inter-world edge merges them and re-bases world 1's solved
    nodes. The rows' world counters and the status query's kidnap_polls
    read what the stream implies."""
    store = GraphStore()
    server = PoseGraphServer(store, _config(), device="cpu")
    eng = server.engine

    def send(msg):
        server.handle_line(json.dumps(msg.to_json()))

    def node(i):
        send(msgs.NodePoseMsg(T0 + i * DT, GRAPH.vio_q[i], GRAPH.vio_t[i]))

    def edge(a, b):
        send(msgs.LoopEdgeMsg(T0 + a * DT, T0 + b * DT, GRAPH.loop_q[0],
                              GRAPH.loop_t[0]))

    for i in range(20):
        node(i)
    send(msgs.KidnapIndicatorMsg(T0 + 19 * DT + 1, "kidnapped"))
    for i in range(20, 25):
        node(i)
    edge(22, 2)                                 # in the dead zone
    assert not eng.trigger() and eng.kidnap_polls == 1
    send(msgs.KidnapIndicatorMsg(T0 + 25 * DT - 1, "unkidnapped"))
    for i in range(25, 40):
        node(i)
    edge(12, 3)
    assert eng.trigger()
    keys = ("worlds", "sets", "priors", "first_contacts", "rebased_nodes",
            "mapped_nodes", "dead_nodes")
    row = eng.solve_stats[-1]
    assert [row[k] for k in keys] == [2, 2, 2, 0, 0, 15, 5]
    edge(30, 5)                                 # world 1 meets world 0
    assert eng.trigger()
    row = eng.solve_stats[-1]
    assert [row[k] for k in keys] == [2, 1, 1, 1, 15, 0, 5]
    assert not eng.trigger() and eng.kidnap_polls == 1
    got = json.loads(server.handle_line(json.dumps(
        {"kind": "query", "what": "status"})))["trace"]
    assert got["poll"]["kidnap_polls"] == 1

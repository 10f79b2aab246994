"""PyTorch port: the solver loop's wait for work (SolverEngine.run).

After a trigger that fires nothing, run() waits on the store's wake, which
each loop edge's append sets once the edge is whole and each kidnap's end
sets, for at most the poll's period. While a gate of the trigger is shut
(the robot kidnapped, an escalated re-solve in flight) new edges do not
end the wait, so refused triggers keep the poll's rate. Every solve still runs on the loop's thread, through
the engine's trigger. Each engine runs on the CPU at a tiny size; the
poll's period is long (5 s at 0.2 Hz) wherever a wake is under test, so a
loop that slept out its period would fail."""

import json
import socket
import threading
import time

import pytest

from solve_keyframe_pose_graph_tpu_torch.graph import messages as msgs
from solve_keyframe_pose_graph_tpu_torch.graph import native
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.runtime_server import (
    PoseGraphServer,
)
from solve_keyframe_pose_graph_tpu_torch.solver.engine import SolverEngine

from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_trace import DT, GRAPH, T0, _config, _edge, _nodes

SLOW_HZ = 0.2                 # a 5 s period
WOKEN_S = 0.25                # an edge's trigger starts within this
JOIN_S = 30.0


class _Calls:
    """Wraps engine.trigger on the instance, as the benchmark's harness
    does: each call's thread, start and return times, whether it fired,
    and the engine's trigger id after it."""

    def __init__(self, eng):
        self.eng = eng
        self.inner = eng.trigger
        self.rows: list = []
        self.cv = threading.Condition()
        eng.trigger = self

    def __call__(self) -> bool:
        t_call = time.monotonic()
        fired = self.inner()
        with self.cv:
            self.rows.append(dict(
                thread=threading.get_ident(), call=t_call,
                ret=time.monotonic(), fired=bool(fired),
                trigger=self.eng.trigger_id,
                edge_len=self.eng.prev_edge_len))
            self.cv.notify_all()
        return fired

    def wait_for(self, pred, timeout: float = JOIN_S) -> None:
        with self.cv:
            assert self.cv.wait_for(lambda: pred(self.rows), timeout)


def _run(eng, poll_hz, stop_when):
    th = threading.Thread(target=eng.run,
                          kwargs=dict(poll_hz=poll_hz, stop_when=stop_when),
                          daemon=True)
    th.start()
    return th


def _join(th):
    th.join(timeout=JOIN_S)
    assert not th.is_alive()


def _engine(store=None):
    store = GraphStore() if store is None else store
    return store, SolverEngine(store, _config(), device="cpu")


def _fired(eng):
    return lambda: bool(eng.solve_stats)


def test_an_edge_ends_the_wait():
    """An edge added from another thread while run() waits starts a fired
    trigger at once, not after the 5 s period."""
    store, eng = _engine()
    _nodes(store)
    calls = _Calls(eng)
    th = _run(eng, SLOW_HZ, _fired(eng))
    calls.wait_for(lambda rows: rows)             # the first, empty, poll
    time.sleep(0.05)
    t_add = time.monotonic()
    _edge(store, 0)
    _join(th)
    row = eng.solve_stats[-1]
    assert row["t_start"] - t_add < WOKEN_S
    assert row["edges_taken"] == 1
    assert [r["fired"] for r in calls.rows] == [False, True]


def test_an_edge_landing_after_the_count_read_still_wakes():
    """An edge appended between the trigger's read of edge_len and the
    wait after it: the trigger fires nothing, and the wait that follows
    ends at once, since the wake was cleared before the trigger."""

    class LateStore(GraphStore):
        late = None

        @property
        def edge_len(self):
            n = self._e
            late, self.late = self.late, None
            if late is not None:
                late()                # lands after the count was read
            return n

    store, eng = _engine(LateStore())
    _nodes(store)
    landed = []

    def land():
        landed.append(time.monotonic())
        _edge(store, 0)

    store.late = land
    calls = _Calls(eng)
    _join(_run(eng, SLOW_HZ, _fired(eng)))
    assert [r["fired"] for r in calls.rows] == [False, True]
    row = eng.solve_stats[-1]
    assert row["t_start"] - landed[0] < WOKEN_S
    assert row["poll_wakes"] == eng.poll_wakes == 1


@pytest.mark.parametrize("gate", ["kidnap", "escalation"])
def test_a_shut_gate_keeps_the_poll_rate_and_its_opening_wakes(gate):
    """While the trigger's gate is shut (kidnapped, or an escalated
    re-solve in flight), 20 edges over most of a 2 s period refuse at most
    two triggers (a loop woken by each edge would refuse 20); the gate's
    opening (the kidnap's end, the re-solve's thread ending) starts a
    fired trigger at once."""
    store, eng = _engine()
    _nodes(store)
    calls = _Calls(eng)
    th = _run(eng, 0.5, _fired(eng))
    calls.wait_for(lambda rows: rows)             # the first, empty, poll
    if gate == "kidnap":
        last = T0 + (GRAPH.n_nodes - 1) * DT
        store.kidnap_indicator(last + 1, "kidnapped")

        def open_gate():
            store.kidnap_indicator(last + 2, "unkidnapped")
    else:
        done = threading.Event()
        eng._bg_thread = threading.Thread(target=done.wait, args=(JOIN_S,),
                                          daemon=True)
        eng._bg_thread.start()
        open_gate = done.set
    for k in range(20):
        _edge(store, k % GRAPH.n_loops)
        time.sleep(0.08)
    refused = sum(not r["fired"] for r in calls.rows) - 1
    t_open = time.monotonic()
    open_gate()
    _join(th)
    assert 1 <= refused <= 2
    assert eng.kidnap_polls == (refused if gate == "kidnap" else 0)
    row = eng.solve_stats[-1]
    assert row["t_start"] - t_open < WOKEN_S
    assert row["edges_taken"] == 20
    assert sum(not r["fired"] for r in calls.rows) == refused + 1


def test_poll_wakes_are_counted_in_the_rows_and_the_status():
    """A wait with no edge lasts the period and is no wake; one that an
    edge ends is. The fired row and the status query's trace.poll carry
    the count, the timer's snapshot the wakes' seconds."""
    store = GraphStore()
    server = PoseGraphServer(store, _config(), device="cpu")
    eng = server.engine

    def send(msg):
        server.handle_line(json.dumps(msg.to_json()))

    for i in range(GRAPH.n_nodes):
        send(msgs.NodePoseMsg(T0 + i * DT, GRAPH.vio_q[i], GRAPH.vio_t[i]))
    calls = _Calls(eng)
    period = 0.5
    th = _run(eng, 1.0 / period, _fired(eng))
    calls.wait_for(lambda rows: len(rows) >= 2)   # one full wait between
    assert eng.poll_sleeps >= 1 and eng.poll_wakes == 0
    assert eng.poll_sleep_s >= 0.9 * period
    a, b = map(int, GRAPH.loop_pairs[0])
    send(msgs.LoopEdgeMsg(T0 + a * DT, T0 + b * DT, GRAPH.loop_q[0],
                          GRAPH.loop_t[0]))
    _join(th)
    row = eng.solve_stats[-1]
    assert row["poll_wakes"] == eng.poll_wakes == 1
    assert row["poll_sleep_s"] == eng.poll_sleep_s
    poll = json.loads(server.handle_line(json.dumps(
        {"kind": "query", "what": "status"})))["trace"]["poll"]
    assert poll["wakes"] == 1 and poll["sleeps"] == eng.poll_sleeps
    woken = eng.timer.snapshot()["poll_wake"]
    assert woken["count"] == 1 and woken["total_s"] < 0.9 * period


class _Recorder:
    """Stands in for a store's wake: each set() records what the store
    holds at that moment."""

    def __init__(self, store):
        self.store = store
        self.seen: list = []

    def set(self):
        s = self.store
        self.seen.append((s.edge_len, len(s.edge_mask),
                          len(s.edge_arrivals)))


@pytest.mark.parametrize("use_native", [False, True])
def test_the_store_wakes_once_the_edge_is_whole(use_native):
    """Each loop edge's append sets the wake after its mask entry and its
    arrival stamp; a kidnap's end sets it; a node or a kidnap's start does
    not."""
    if use_native:
        if native.load_library() is None:
            pytest.skip("native core not built")
        store = native.make_store(native=True)
        assert type(store) is native.NativeGraphStore
    else:
        store = GraphStore()
    assert not store.wake.is_set()
    rec = store.wake = _Recorder(store)
    _nodes(store, 10)
    store.add_loop_edge_by_index(9, 2, GRAPH.loop_q[0], GRAPH.loop_t[0], 1.0)
    store.add_loop_edge(T0 + 8 * DT, T0 + 1 * DT, GRAPH.loop_q[1],
                        GRAPH.loop_t[1], 1.0)
    assert rec.seen == [(1, 1, 1), (2, 2, 2)]
    store.kidnap_indicator(T0 + 9 * DT + 1, "kidnapped")
    assert len(rec.seen) == 2
    store.kidnap_indicator(T0 + 9 * DT + 2, "unkidnapped")
    assert len(rec.seen) == 3


def test_every_solve_runs_on_the_solver_thread(tmp_path):
    """Edges streamed over the server's socket while run() is live: every
    solve_stats row came through the engine's trigger, wrapped on the
    instance as the benchmark's harness wraps it, on the thread that runs
    run(). A traced benchmark run's count of K1 launches rests on this."""
    store = GraphStore()
    server = PoseGraphServer(store, _config(), device="cpu")
    eng = server.engine
    calls = _Calls(eng)
    loops = []
    inner_run = eng.run

    def run(*a, **kw):
        loops.append(threading.get_ident())
        return inner_run(*a, **kw)

    eng.run = run
    sock_path = str(tmp_path / "kpg.sock")
    th = threading.Thread(target=server.serve,
                          kwargs=dict(socket_path=sock_path, poll_hz=2.0),
                          daemon=True)
    th.start()
    client = socket.socket(socket.AF_UNIX)
    for _ in range(200):
        try:
            client.connect(sock_path)
            break
        except OSError:
            time.sleep(0.05)
    f = client.makefile("rw")

    def send(msg):
        f.write(json.dumps(msg.to_json()) + "\n")
        f.flush()

    by_later: dict = {}
    for k in range(GRAPH.n_loops):
        a, b = map(int, GRAPH.loop_pairs[k])
        by_later.setdefault(max(a, b), []).append((k, a, b))
    sent = 0
    for i in range(GRAPH.n_nodes):
        send(msgs.NodePoseMsg(T0 + i * DT, GRAPH.vio_q[i], GRAPH.vio_t[i]))
        for k, a, b in by_later.get(i, ()):
            send(msgs.LoopEdgeMsg(T0 + a * DT, T0 + b * DT, GRAPH.loop_q[k],
                                  GRAPH.loop_t[k]))
            sent += 1
            # each edge solved before the next is sent: one solve an edge
            calls.wait_for(lambda rows, n=sent: any(
                r["fired"] and r["edge_len"] == n for r in rows))
    f.write(json.dumps({"kind": "shutdown"}) + "\n")
    f.flush()
    f.readline()
    client.close()
    _join(th)
    assert len(loops) == 1
    fired = [r for r in calls.rows if r["fired"]]
    assert {r["thread"] for r in fired} == set(loops)
    assert len(fired) == GRAPH.n_loops
    assert [r["trigger"] for r in eng.solve_stats] == \
        [r["trigger"] for r in fired]
    assert eng.prev_edge_len == store.edge_len == GRAPH.n_loops

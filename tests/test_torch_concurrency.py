"""PyTorch port: tests/test_concurrency.py's threading stress through the
port: ingest, the engine's run() loop and the Composer (with the status
printer) on three threads over one store, the port's numpy store and its
bounded native store (graph/native.py), at the JAX test's 400 nodes and 60
loop edges with a kidnap interval mid-stream. A torn read or a shape race
raises in a worker and fails the test; the JAX test's invariants then hold
on the result. The engine runs on the CPU at the default Config."""

import threading
import time

import pytest

from solve_keyframe_pose_graph_tpu_torch.compose.composer import Composer
from solve_keyframe_pose_graph_tpu_torch.graph import native, synthetic
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.solver.engine import SolverEngine
from solve_keyframe_pose_graph_tpu_torch.utils.log import (
    StatusPrinter, get_logger,
)

from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("use_native", [False, True])
def test_concurrent_pipeline(use_native):
    if use_native:
        if native.load_library() is None:
            pytest.skip("native core not built")
        store = native.make_store(native=True)
        assert type(store) is native.NativeGraphStore
    else:
        store = GraphStore()

    g = synthetic.circle_graph(n_nodes=400, n_loops=60, seed=5)
    eng = SolverEngine(store, device="cpu")
    cmp_ = Composer(store, eng)
    errors = []
    done = threading.Event()

    t0 = 1_000_000_000
    dtn = 100_000_000
    edge_by_later = {}
    for k in range(g.n_loops):
        a, b = map(int, g.loop_pairs[k])
        edge_by_later.setdefault(max(a, b), []).append(k)

    def ingest():
        try:
            for i in range(g.n_nodes):
                # a kidnap interval mid-stream (fault injection)
                if i == 200:
                    store.kidnap_indicator(t0 + i * dtn - dtn // 2,
                                           "kidnapped")
                    store.kidnap_indicator(t0 + i * dtn - dtn // 3,
                                           "unkidnapped")
                store.add_node(t0 + i * dtn, g.vio_q[i], g.vio_t[i])
                for k in edge_by_later.get(i, []):
                    a, b = map(int, g.loop_pairs[k])
                    store.add_loop_edge(
                        t0 + a * dtn, t0 + b * dtn,
                        g.loop_q[k], g.loop_t[k], float(g.loop_w[k]))
                if i % 97 == 0:
                    time.sleep(0.001)
        except Exception as e:   # pragma: no cover
            errors.append(("ingest", repr(e)))
        finally:
            done.set()

    def solve_loop():
        try:
            eng.run(poll_hz=500.0, stop_when=done.is_set)
            eng.trigger()
        except Exception as e:   # pragma: no cover
            errors.append(("solver", repr(e)))

    def compose_loop():
        logger = get_logger("kpg-test-conc")
        logger.disabled = True
        sp = StatusPrinter(store, eng, logger=logger)
        try:
            while not done.is_set():
                comp = cmp_.assemble()
                if comp is not None:
                    assert len(comp.t) <= store.node_len + 1
                sp.tick(force=True)
                time.sleep(0.002)
        except Exception as e:   # pragma: no cover
            errors.append(("composer", repr(e)))

    threads = [threading.Thread(target=f)
               for f in (ingest, solve_loop, compose_loop)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert store.node_len == g.n_nodes
    # the solver thread's last trigger has run; the pipeline must solve
    eng.drain()
    eng.trigger()
    eng.drain()
    assert eng.solved_until == g.n_nodes - 1
    comp = cmp_.assemble()
    assert len(comp.t) == g.n_nodes
    last = [r for r in eng.solve_stats if "trigger_wall_ms" in r][-1]
    assert last["final_cost"] < last["initial_cost"]

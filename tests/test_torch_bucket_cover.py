"""PyTorch port: the engine's bucket cover (solver/engine.py), on the CPU.

A trigger whose exact (n_cap, e_cap, dtype) bucket is not in the engine's
_warmed_buckets solves in the smallest bucket there that holds it, as the
JAX engine's trigger does (its engine.py:691-700):
  (a) the counterpart of tests/test_engine.py's
      test_engine_bucket_cover_dispatch;
  (b) the same stream and set give the same box on every trigger in both
      packages' engines, fp64, with the same results;
  (c) an eager engine's warmup records the JAX package's ladder;
  (d) a graphed engine (the graphs' test doubles of
      tests/test_torch_graphs.py) after a proportional warmup covers a
      stream's off-ladder buckets without a capture, bit for bit an eager
      engine with the same set, and a trigger past every warmed bucket
      captures its own;
  (e) during a background warmup a trigger covers only with buckets
      already captured;
  (f) a 2-shard mesh engine solves in the cover, as the unmeshed one does;
  (g) a box that shrinks is a full build of the incremental builder;
  (h) the host fp64 rung's result does not depend on the box, nor does the
      device fp64 rung's where both boxes hold its 1024-multiple repack.
The boxes are read through a wrapper on the engine's lm_solve, as the JAX
test reads them through one on lm_solve_aot.
"""

import functools
import threading

import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu import config as jconfig
from solve_keyframe_pose_graph_tpu.ops import lm as jlm
from solve_keyframe_pose_graph_tpu.solver import engine as jengine
from solve_keyframe_pose_graph_tpu_torch import config as tconfig
from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.ops import lm as tlm
from solve_keyframe_pose_graph_tpu_torch.parallel import ShardedProblem
from solve_keyframe_pose_graph_tpu_torch.parallel.sharding import (
    ghost_capacity,
)
from solve_keyframe_pose_graph_tpu_torch.solver import cpu_rung
from solve_keyframe_pose_graph_tpu_torch.solver import engine as tengine
from solve_keyframe_pose_graph_tpu_torch.solver.engine import SolverEngine
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    build_problem_np,
)
from solve_keyframe_pose_graph_tpu_torch.utils import nse3

from test_engine import S, T0
from test_torch_engine import _Both
from test_torch_engine import _config as parity_config
from test_torch_graphs import _engine_config, graphed_cpu  # noqa: F401
from test_torch_sharded_lm import _config as mesh_config
from test_torch_sharded_lm import _stream as mesh_stream
from test_torch_threads import one_torch_thread  # noqa: F401

# the seeded VIO drift of every stream below
DRIFT = np.cumsum(np.random.default_rng(0).normal(scale=0.02, size=(1024, 3)),
                  axis=0)


def grow(store, n_from: int, n_to: int, new_edges: int, off: int = 200):
    """Nodes n_from..n_to-1 at x = i plus DRIFT, then `new_edges` loop
    edges from the newest nodes back `off` nodes (half the node's index
    where that is fewer), measured exactly."""
    for i in range(n_from, n_to):
        store.add_node(T0 + i * S, nse3.quat_identity(),
                       np.array([float(i), 0, 0]) + DRIFT[i])
    for j in range(new_edges):
        a = n_to - 1 - j
        b = a - min(off, a // 2)
        store.add_loop_edge(T0 + a * S, T0 + b * S, nse3.quat_identity(),
                            [float(a - b), 0, 0], 1.0)


def run_plan(store, eng, plan) -> None:
    """One trigger after each (node_len, new loop edges) of `plan`."""
    n = 0
    for node_len, new_edges in plan:
        grow(store, n, node_len, new_edges)
        n = node_len
        assert eng.trigger()
    eng.drain()


@pytest.fixture
def boxes(monkeypatch):
    """(n_cap, e_cap) of every lm_solve call, in order. The wrapper keeps
    lm_solve's signature, which ops/graphs.py reads."""
    seen = []
    real = tlm.lm_solve

    @functools.wraps(real)
    def spy(problem, **kw):
        seen.append((problem.n_cap, problem.e_cap))
        return real(problem, **kw)

    monkeypatch.setattr(tlm, "lm_solve", spy)
    return seen


def rows(eng) -> list:
    return [r for r in eng.solve_stats if "trigger_wall_ms" in r]


def poses(eng) -> np.ndarray:
    return np.array([np.concatenate(eng.get_node_pose(i))
                     for i in range(eng.n_opt_variables())])


def switches(eng) -> np.ndarray:
    return np.array([eng.get_switch(e) for e in range(eng.store.edge_len)])


def test_engine_bucket_cover_dispatch(boxes):
    """(a) tests/test_engine.py's test of the same name on the port at its
    default Config: the exact bucket (1024, 256) is not warmed and
    (2048, 512) is, so the trigger solves in (2048, 512), lands below a
    chi^2 of 1 (the JAX test's bar) and leaves the bucket in the set."""
    store = GraphStore()
    eng = SolverEngine(store, device="cpu")
    eng._warmed_buckets.add((2048, 512, "float32"))
    g = synthetic.circle_graph(n_nodes=60, n_loops=8, seed=2)
    t0, dt = 1_000_000_000, 100_000_000
    for i in range(g.n_nodes):
        store.add_node(t0 + i * dt, g.vio_q[i], g.vio_t[i])
    for k in range(g.n_loops):
        a, b = map(int, g.loop_pairs[k])
        store.add_loop_edge(t0 + a * dt, t0 + b * dt,
                            g.loop_q[k], g.loop_t[k], float(g.loop_w[k]))
    assert eng.trigger()
    eng.drain()
    assert boxes[0] == (2048, 512)
    assert eng.solve_stats[-1]["final_cost"] < 1.0
    assert (2048, 512, "float32") in eng._warmed_buckets


# (node_len, new loop edges) per trigger, with (256, 64) warmed: (128, 32)
# and (256, 32) take the cover (256, 64); (512, 32) has none and is solved
# in, after which the last trigger's exact bucket is in the set
PARITY_PLAN = ((100, 1), (200, 1), (300, 1), (320, 1))
PARITY_BOXES = [(256, 64), (256, 64), (512, 32), (512, 32)]


def test_same_boxes_and_results_as_the_jax_engine(monkeypatch, boxes):
    """(b) Both engines at fp64 with (256, 64) in the set, the same stream:
    the same box per trigger (two JAX compiles), poses to 1e-8 of their
    scale and switches to 1e-9, chi^2 to 1e-6 relative, the same LM and
    CG counts (_Both.check_poses)."""
    jax_boxes = []
    real = jlm.lm_solve_aot

    def spy(problem, **kw):
        jax_boxes.append((problem.n_cap, problem.e_cap))
        return real(problem, **kw)

    monkeypatch.setattr(jlm, "lm_solve_aot", spy)
    b = _Both()
    for eng in (b.jax, b.port):
        eng._warmed_buckets.add((256, 64, "float64"))
    n = 0
    for node_len, new_edges in PARITY_PLAN:
        grow(b, n, node_len, new_edges)
        n = node_len
        assert b.trigger()
    assert jax_boxes == boxes == PARITY_BOXES
    assert len(set(jax_boxes)) <= 3
    assert b.port._warmed_buckets == b.jax._warmed_buckets == {
        (256, 64, "float64"), (512, 32, "float64")}
    b.check_poses()
    assert len(b.port.solve_stats) == len(PARITY_PLAN)
    np.testing.assert_allclose(switches(b.port), switches(b.jax), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("proportional", [True, False])
def test_eager_warmup_records_the_reference_ladder(boxes, proportional):
    """(c) An eager engine's warmup puts the JAX package's _warmup_pairs
    in the set with the config's dtype, primes one solve at its first
    bucket, and returns and records that one as before."""
    caps = (jconfig.CapacityConfig(initial_nodes=128, initial_edges=32),
            tconfig.CapacityConfig(initial_nodes=128, initial_edges=32))
    cfg = _engine_config()
    eng = SolverEngine(GraphStore(), cfg, device="cpu")
    pairs = jengine._warmup_pairs(caps[0], 1000, 200, proportional)
    assert eng.warmup(1000, 200, proportional=proportional) == 1
    assert eng._warmed_buckets == {(n, e, "float32") for n, e in pairs}
    assert boxes == pairs[:1] == [(128, 32)]
    assert [(r["n_cap"], r["e_cap"], r["capture_s"])
            for r in eng.warmup_stats] == [(128, 32, None)]
    assert tengine._warmup_pairs(caps[1], 1000, 200, proportional) == pairs


# warmup(512, 128) on (128, 32) first buckets keeps (128|256, 32..64),
# (256, 128) and (512, 64..128); its plan's loops arrive at node 300, in
# (512, 32), which (512, 64) covers; then (512, 64) itself; then 130 loop
# edges, in (512, 256), which nothing warmed holds
LADDER_PLAN = ((300, 1), (400, 39), (500, 90))
LADDER_BOXES = [(512, 64), (512, 64), (512, 256)]


def test_graphed_stream_covers_off_ladder_buckets(graphed_cpu, boxes):
    """(d) After warmup(512, 128) a graphed engine's stream takes no
    capture in the cover and its exact ladder bucket, and captures the
    bucket past every warmed one; its poses, switches and counts are bit
    for bit those of an eager engine with the same set."""
    pairs = tengine._warmup_pairs(_engine_config().capacity, 512, 128)
    assert (512, 32) not in pairs and (512, 64) in pairs
    store = GraphStore()
    eng = SolverEngine(store, _engine_config(), device="cpu")
    assert eng._graphed()
    assert eng.warmup(512, 128) == len(pairs) == 7
    warmed = set(eng._warmed_buckets)
    assert warmed == {(n, e, "float32") for n, e in pairs}
    del boxes[:]
    run_plan(store, eng, LADDER_PLAN)
    assert boxes == LADDER_BOXES
    assert [r["trigger_captures"] for r in rows(eng)] == [0, 0, 1]

    twin_store = GraphStore()
    twin = SolverEngine(twin_store, _engine_config(), device="cpu")
    twin._warmed_buckets = set(warmed)
    del boxes[:]
    with tlm._eager_solves():
        run_plan(twin_store, twin, LADDER_PLAN)
    assert boxes == LADDER_BOXES
    assert twin._warmed_buckets == eng._warmed_buckets
    for key in ("node_len", "edge_len", "lm_iterations", "cg_iterations",
                "final_cost"):
        assert [r[key] for r in rows(eng)] == [r[key] for r in rows(twin)]
    assert np.array_equal(poses(eng), poses(twin))
    assert np.array_equal(switches(eng), switches(twin))


def test_background_warmup_covers_only_with_captured_buckets(graphed_cpu,
                                                             boxes):
    """(e) With the background warmup held after its first bucket, a
    trigger in (256, 32) finds no captured cover (the ladder's (256, 64)
    and up are not captured yet) and captures its own bucket; once the
    warmup is released and joined, a trigger in (512, 32) solves in the
    captured (512, 64) without a capture."""
    store = GraphStore()
    eng = SolverEngine(store, _engine_config(), device="cpu")
    gate = threading.Event()
    warm_one = eng._warm_one

    def held(n_cap, e_cap, *args):
        if (n_cap, e_cap) != (128, 32):
            assert gate.wait(timeout=120)
        warm_one(n_cap, e_cap, *args)

    eng._warm_one = held
    try:
        assert eng.warmup(512, 128, background=True) == 7
        assert eng._warmed_buckets == {(128, 32, "float32")}
        del boxes[:]
        grow(store, 0, 150, 1)
        assert eng.trigger()
        assert boxes == [(256, 32)]
        assert rows(eng)[-1]["trigger_captures"] == 1
    finally:
        gate.set()
    assert eng.warmup_join(timeout=120)
    assert len(eng.warmup_stats) == 7
    grow(store, 150, 300, 1)
    assert eng.trigger()
    assert boxes[-1] == (512, 64)
    assert rows(eng)[-1]["trigger_captures"] == 0


def test_mesh_engine_solves_in_the_cover(monkeypatch):
    """(f) A 2-shard CPU mesh engine with (256, 128) in its set solves
    every trigger of the mesh tests' stream in it, its shards' ghosts
    padded to that bucket's g_cap, and lands within 1e-8 of the pose scale
    of the unmeshed engine in the same box, with the same counts (the
    bars of tests/test_torch_sharded_lm.py's engine replay)."""
    seen = {1: [], 2: []}
    real = tlm.lm_solve

    @functools.wraps(real)
    def spy(problem, **kw):
        if isinstance(problem, ShardedProblem):
            g_cap = ghost_capacity(problem.n_cap, problem.e_cap,
                                   problem.fanout, 2)
            assert all(len(g) == g_cap for g in problem.layout.ghosts)
            seen[2].append((problem.n_cap, problem.e_cap))
        else:
            seen[1].append((problem.n_cap, problem.e_cap))
        return real(problem, **kw)

    monkeypatch.setattr(tlm, "lm_solve", spy)
    runs = {}
    for P in (1, 2):
        store = GraphStore()
        eng = SolverEngine(store, mesh_config(P), device="cpu")
        assert (eng.mesh is None) == (P == 1)
        eng._warmed_buckets.add((256, 128, "float64"))
        mesh_stream(store, eng)
        runs[P] = eng
    assert len(seen[2]) == len(seen[1]) >= 3
    assert seen[2] == seen[1] == [(256, 128)] * len(seen[1])
    p1, p2 = poses(runs[1]), poses(runs[2])
    np.testing.assert_allclose(p2, p1, rtol=0, atol=1e-8 * np.abs(p1).max())
    for a, b in zip(rows(runs[2]), rows(runs[1])):
        for key in ("node_len", "edge_len", "lm_iterations", "cg_iterations"):
            assert a[key] == b[key], key


def test_a_box_that_shrinks_is_a_full_build(boxes):
    """(g) With (512, 128) in the set the first trigger builds at that
    box; a smaller cover, (256, 128), entering the set (a warmer that has
    captured it since) moves the next trigger to it, a full build; the
    trigger after, in the same box, is a delta build. Bit for bit the
    engine without the incremental builder."""
    plans = {}
    for incremental in (True, False):
        cfg = parity_config()
        cfg = tconfig.Config(
            solver=cfg.solver, capacity=cfg.capacity, io=cfg.io,
            stream=tconfig.StreamConfig(async_dispatch=False,
                                        incremental_build=incremental))
        store = GraphStore()
        eng = SolverEngine(store, cfg, device="cpu")
        eng._warmed_buckets.add((512, 128, "float64"))
        del boxes[:]
        grow(store, 0, 100, 1)
        assert eng.trigger()
        eng._warmed_buckets.add((256, 128, "float64"))
        grow(store, 100, 110, 1)
        assert eng.trigger()
        grow(store, 110, 120, 1)
        assert eng.trigger()
        assert boxes == [(512, 128), (256, 128), (256, 128)]
        plans[incremental] = eng
    got = rows(plans[True])
    assert [r["full_builds"] for r in got] == [1, 2, 2]
    assert [r["delta_builds"] for r in got] == [0, 0, 1]
    assert np.array_equal(poses(plans[True]), poses(plans[False]))
    assert np.array_equal(switches(plans[True]), switches(plans[False]))


def _problem(n_cap: int, e_cap: int):
    """A 100-node, 10-loop circle graph in fp32 at the given box."""
    g = synthetic.circle_graph(n_nodes=100, n_loops=10, seed=4,
                               outlier_fraction=0.2)
    return build_problem_np(
        q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t,
        node_valid=np.ones(100, bool), loop_pairs=g.loop_pairs,
        loop_q=g.loop_q, loop_t=g.loop_t, loop_w=g.loop_w,
        loop_valid=np.ones(10, bool), switch=np.full(10, 0.99),
        prior_idx=np.array([0]), prior_q=g.vio_q[:1], prior_t=g.vio_t[:1],
        prior_w=np.array([1.1]), n_cap=n_cap, e_cap=e_cap, p_cap=16,
        dtype=np.float32, device="cpu")


@pytest.mark.parametrize("rung,exact,cover", [
    ("fp64-cpu", (128, 32), (512, 256)),
    ("fp64", (1024, 1024), (2048, 2048)),
])
def test_fp64_rungs_do_not_depend_on_the_box(rung, exact, cover):
    """(h) The host rung repacks to the live lengths, the device fp64 rung
    to the 1024-multiples that hold them (capped at the box): from two
    boxes that both hold that repack, the written-back part of the result
    (engine._to_host) is equal bit for bit."""
    kw = dict(max_iterations=3, max_cg_iterations=20)
    got = []
    for box in (exact, cover):
        problem = _problem(*box)
        if rung == "fp64-cpu":
            if not cpu_rung.available(kw):
                pytest.skip("host fp64 rung unavailable (libkpg_ldl.so / "
                            "scipy)")
            res, _ = cpu_rung.cpu_fp64_resolve(problem, kw)
        else:
            res = tlm.fp64_resolve(problem, kw)
        assert tuple(res.q.shape) == (box[0], 4)
        got.append(tengine._to_host(res, 100, 10))
    assert all(torch.equal(x, y) for x, y in zip(*got))
    assert float(got[0].final_cost) < float(got[0].initial_cost)

"""PyTorch port: the solve as captured graphs (ops/graphs.py), on the CPU.

A CUDA graph cannot be captured here, so these tests hold what a capture
needs and everything around it:
  * the LM setup and body issue no operation that reads a value on the
    host or copies one from it (each would break or corrupt a capture);
  * the loop rows' grouping has one shape per capacity bucket, and sums
    bit for bit as the grouping of the live rows alone;
  * a Program's static buffers and captured pieces (init, pre, cg_iter,
    post), run eagerly through test doubles of the capture (EagerGraph
    below) and of graph_loops' executables (HostLoops below: host while
    loops on the WHILE nodes' conditions), the only ones (the package has
    none), give eager lm_solve's results bit for bit, keep no state from one
    solve to the next, and match the JAX package's lm_solve_chunked
    (tests/test_torch_device_loops.py holds the loops themselves);
  * the engine's bucket ladder is the reference's, and a warmed stream
    takes no capture on its trigger path.
The captures themselves run on the card: chip_smoke.py phase 18.
"""


import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from solve_keyframe_pose_graph_tpu import config as jconfig
from solve_keyframe_pose_graph_tpu.ops import lm as jlm
from solve_keyframe_pose_graph_tpu.solver import engine as jengine
from solve_keyframe_pose_graph_tpu.solver.problem import (
    build_problem_np as jax_build,
)
from solve_keyframe_pose_graph_tpu_torch import config as tconfig
from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.ops import (
    _kernels, graph_loops, graphs,
)
from solve_keyframe_pose_graph_tpu_torch.ops import coarse as tcoarse
from solve_keyframe_pose_graph_tpu_torch.ops import gn as tgn
from solve_keyframe_pose_graph_tpu_torch.ops import lm as tlm
from solve_keyframe_pose_graph_tpu_torch.solver import engine as tengine
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    DUMP_ROWS, FIELDS, LoopRows, build_problem_np, loop_rows_by_node,
    problem_from_arrays,
)
from solve_keyframe_pose_graph_tpu_torch.utils import nse3

from test_engine import S, T0
from test_torch_threads import one_torch_thread  # noqa: F401

PRODUCT = dict(max_iterations=10, preconditioner="band+coarse", bcr_levels=2,
               max_cg_iterations=45)
# what breaks or corrupts a stream capture: a host read of a device value
# (_local_scalar_dense: .item(), bool(), int()), an output shape read from
# the data (nonzero, masked_select), torch.linalg's error check, and a
# tensor made from host data (lift_fresh: torch.tensor, a Python scalar
# assigned into a tensor)
FORBIDDEN = ("_local_scalar_dense", "nonzero", "lift_fresh", "masked_select",
             "_linalg_check_errors")


def _graph(n=300, loops=60, n_cap=512, e_cap=128, dtype=np.float32, seed=0,
           drop=7, builder=build_problem_np, **kw):
    """A circle graph with every `drop`-th loop edge masked (so masked rows
    sit between live ones as well as in the padding)."""
    g = synthetic.circle_graph(n_nodes=n, n_loops=loops, seed=seed,
                               outlier_fraction=0.2)
    live = np.ones(loops, bool)
    live[::drop] = False
    if builder is build_problem_np:
        kw.setdefault("device", "cpu")
    return builder(
        q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t,
        node_valid=np.ones(n, bool), loop_pairs=g.loop_pairs,
        loop_q=g.loop_q, loop_t=g.loop_t, loop_w=g.loop_w, loop_valid=live,
        switch=np.full(loops, 0.99), prior_idx=np.array([0]),
        prior_q=g.vio_q[:1], prior_t=g.vio_t[:1], prior_w=np.array([1.1]),
        n_cap=n_cap, e_cap=e_cap, p_cap=16, dtype=dtype, **kw)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("over", [
    {}, dict(residual_mode="4dof"), dict(precision="mixed"),
    dict(preconditioner="band*coarse"), dict(preconditioner="jacobi"),
    dict(use_switch=False, cg_q_tolerance=0.1, cg_warm_iters=2)],
    ids=["product", "4dof", "mixed", "two-grid", "jacobi", "options"])
def test_lm_setup_and_body_are_capturable(over):
    """The grouping, _lm_setup, its init and one LM iteration issue none of
    FORBIDDEN at the product configuration (and its variants)."""
    prob = _graph()
    setup = graphs.setup_of(prob, **dict(PRODUCT, **over))
    with _Ops() as ops:
        prob.loop_rows_by_node
        _, init, body = tlm._lm_setup(prob, **setup)
        state = body(init())
    assert not ops.seen & set(FORBIDDEN), ops.seen & set(FORBIDDEN)
    assert int(state.k) == 1


def _live_grouping(loop_b, loop_a, loop_mask, n: int) -> LoopRows:
    """The grouping of the live rows alone (the port's grouping before it
    took a fixed length): its shape follows the number of live edges."""
    node = torch.cat([loop_b, loop_a]).long()
    rows = torch.nonzero((loop_mask > 0.5).repeat(2)).squeeze(1)
    node = node[rows]
    order = torch.argsort(node, stable=True)
    return LoopRows(rows[order], torch.bincount(node, minlength=n), n)


def test_loop_rows_have_one_shape_per_bucket():
    rng = np.random.default_rng(0)
    n, e = 96, 40
    lb = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    la = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    shapes = set()
    for live in range(e + 1):
        mask = torch.zeros(e, dtype=torch.float64)
        mask[torch.from_numpy(rng.permutation(e)[:live])] = 1.0
        rows = loop_rows_by_node(lb, la, mask, n)
        shapes.add((tuple(rows.order.shape), tuple(rows.lengths.shape)))
        assert int(rows.lengths.sum()) == 2 * e
        assert int(rows.lengths[:n].sum()) == 2 * live
        # masked rows spread over short segments: one long segment
        # serialises its sum on the card
        assert int(rows.lengths[n:].max()) <= DUMP_ROWS
    assert len(shapes) == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fixed_grouping_sums_as_the_live_grouping(seed):
    """scatter_loop_rows and the coarse build give, bit for bit, what the
    grouping of the live rows alone gives, on random masks (masked rows
    carry nonzero values here: the fixed grouping must drop them)."""
    rng = np.random.default_rng(seed)
    n, e, group = 200, 150, 16
    lb = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    la = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    mask = torch.from_numpy((rng.random(e) < 0.6).astype(np.float64))
    fixed = loop_rows_by_node(lb, la, mask, n)
    live = _live_grouping(lb, la, mask, n)

    class P:
        pass

    a, b = P(), P()
    a.loop_rows_by_node, b.loop_rows_by_node = fixed, live
    vb, va = (torch.from_numpy(rng.normal(size=(e, 36))) for _ in range(2))
    assert torch.equal(tgn.scatter_loop_rows(a, vb, va),
                       tgn.scatter_loop_rows(b, vb, va))

    Dh = torch.from_numpy(rng.normal(size=(36, n)) * 0.01)
    Dh[0:36:7] += 10.0
    Bh = torch.from_numpy(rng.normal(size=(5, 36, n)) * 0.01)
    Aba = torch.from_numpy(rng.normal(size=(36, e)) * 0.01) * mask
    got, info = tcoarse.build_coarse_inverse_arrays(
        Dh, Bh, Aba, lb.long(), la.long(), fixed, 5, group)
    want, _ = tcoarse.build_coarse_inverse_arrays(
        Dh, Bh, Aba, lb.long(), la.long(), live, 5, group)
    assert int(info) == 0
    assert torch.equal(got, want)


def test_small_fp64_solve_matches_reference():
    """With masked loop edges between live ones, the fixed grouping's fp64
    solve matches the JAX package's lm_solve as tests/test_torch_lm.py
    holds it: equal counts, chi^2 to 1e-6."""
    jp = _graph(n=200, loops=40, n_cap=256, e_cap=64, dtype=np.float64,
                builder=jax_build)
    tp = problem_from_arrays({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                             "cpu")
    ref = jlm.lm_solve(jp, loop_impl="scatter", band_impl="aos", **PRODUCT)
    got = tlm.lm_solve(tp, **PRODUCT)
    for name in ("iterations", "successful_steps", "total_cg_iterations",
                 "distress_rejects"):
        assert int(getattr(got, name)) == int(getattr(ref, name)), name
    np.testing.assert_allclose(float(got.final_cost), float(ref.final_cost),
                               rtol=1e-6)


class EagerGraph:
    """Test double of a captured graph: replay() runs the captured function
    eagerly (on the CPU a Program's static buffers take the same writes)."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()

    def pool(self):
        return None


def _eager_capture(fn, device, pool=None):
    """graphs._capture's test double: (graph, capture_s, pool_bytes)."""
    return EagerGraph(fn), 0.0, 0


def holds(cond: graph_loops.Cond) -> bool:
    """The WHILE nodes' condition (csrc/graph_loops.cu set_cond), !done &&
    k < cap, read on the host."""
    return not bool(cond.done) and int(cond.k) < int(cond.cap)


class HostLoops:
    """Test double of graph_loops' executables (graph_loops.compose): the
    same loops over the pieces' replay(), as host while loops on the same
    conditions."""

    def __init__(self, pieces: dict, cg: graph_loops.Cond,
                 lm: graph_loops.Cond, device=None):
        self.pieces, self.cg, self.lm = pieces, cg, lm

    def _step(self) -> None:
        self.pieces["pre"].replay()
        while holds(self.cg):
            self.pieces["cg_iter"].replay()
        self.pieces["post"].replay()

    def launch(self, name: str) -> None:
        if name in ("init", "solve"):
            self.pieces["init"].replay()
        if name == "step":
            self._step()
        elif name == "solve":
            while holds(self.lm):
                self._step()


def graph_on_cpu(monkeypatch, capture=_eager_capture) -> None:
    """lm_solve takes the Programs on the CPU: `capture` as graphs._capture
    and HostLoops as graph_loops.compose."""
    monkeypatch.setattr(graphs, "on_card", lambda device: True)
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(graph_loops, "compose", HostLoops)


@pytest.fixture
def graphed_cpu(monkeypatch):
    """lm_solve and the engine take the graphs on the CPU, with EagerGraph
    as the capture and HostLoops as the executables; an empty cache before
    and after."""
    graph_on_cpu(monkeypatch)
    graphs.clear()
    yield
    graphs.clear()


def test_one_program_serves_two_problems_of_a_bucket(graphed_cpu):
    """Two Problems of one bucket through one Program, one after the
    other: each bit for bit the eager solve, with nothing left over from
    the first; the first result still holds after the second solve."""
    a, b = _graph(seed=0), _graph(n=280, loops=50, seed=1, drop=5)
    built = len(graphs.LOG)
    ga = tlm.lm_solve(a, **PRODUCT)
    kept = [v.clone() for v in ga]
    gb = tlm.lm_solve(b, **PRODUCT)
    assert len(graphs.LOG) == built + 1          # one build, then a replay
    for got, p in ((ga, a), (gb, b)):
        want = tlm._lm_solve_eager(p, **PRODUCT)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert all(torch.equal(x, y) for x, y in zip(ga, kept))
    assert int(gb.iterations) == 10 and int(ga.total_cg_iterations) > 0


def test_program_matches_reference_chunked_solve(graphed_cpu):
    """At fp64 the Program's launches follow the JAX package's
    lm_solve_chunked(chunk_iters=1): equal counts, chi^2 to 1e-6."""
    jp = _graph(n=200, loops=40, n_cap=256, e_cap=64, dtype=np.float64,
                builder=jax_build)
    tp = problem_from_arrays({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                             "cpu")
    ref = jlm.lm_solve_chunked(jp, chunk_iters=1, loop_impl="scatter",
                               band_impl="aos", **PRODUCT)
    got = tlm.lm_solve(tp, **PRODUCT)
    assert graphs.LOG[-1]["n_cap"] == 256
    for name in ("iterations", "successful_steps", "total_cg_iterations",
                 "distress_rejects", "converged"):
        assert int(getattr(got, name)) == int(getattr(ref, name)), name
    for name in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=1e-6)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(ref.t)).max())


def test_failed_capture_raises_and_caches_nothing(monkeypatch):
    """A capture that fails raises out of lm_solve: nothing carries on
    eagerly, and no Program is kept."""
    def broken(fn, device, pool=None):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    graph_on_cpu(monkeypatch, broken)
    graphs.clear()
    with pytest.raises(RuntimeError, match="capturing"):
        tlm.lm_solve(_graph(n=100, loops=10, n_cap=128, e_cap=32), **PRODUCT)
    assert not graphs._programs


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_failed_coarse_factorization_raises(monkeypatch, graphed):
    """The coarse Cholesky's info travels in the loop state, and a solve
    whose factorization failed raises after its loop, eager or replayed."""
    real = torch.linalg.cholesky_ex

    def failing(H):
        L, info = real(H)
        return L, torch.ones_like(info)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", failing)
    if graphed:
        graph_on_cpu(monkeypatch)
    graphs.clear()
    with pytest.raises(torch.linalg.LinAlgError, match="Cholesky"):
        tlm.lm_solve(_graph(n=100, loops=10, n_cap=128, e_cap=32),
                     **dict(PRODUCT, max_iterations=2))
    if graphed:
        # the fault is the problem's: its Program stays cached, and free
        (prog,) = graphs._programs.values()
        assert not prog.busy.locked()
    graphs.clear()


def test_replays_count_the_captured_launches(monkeypatch):
    """A launch counted while its thread captures goes into the capture's
    tally, not on the counters; a replay adds the tally."""
    def wrapper():
        pass

    wrapper.launches = 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with _kernels.capturing() as tally:
        _kernels.count_launch(wrapper, "kpg_fake_f32")
        _kernels.count_launch(wrapper, "kpg_fake_f32")
    assert wrapper.launches == 0 and tally == {(wrapper, "kpg_fake_f32"): 2}
    before = _kernels.ENTRY_LAUNCHES.get("kpg_fake_f32", 0)
    for _ in range(3):
        _kernels.add_launches(tally)
    _kernels.count_launch(wrapper, "kpg_fake_f32")
    assert wrapper.launches == 7
    assert _kernels.ENTRY_LAUNCHES["kpg_fake_f32"] == before + 7


def test_a_launch_outside_the_capture_raises(monkeypatch):
    """A launch counted in a capture on a stream that is not capturing ran
    once, eagerly: it raises instead of going into the tally."""
    def wrapper():
        pass

    wrapper.launches = 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    with _kernels.capturing() as tally:
        with pytest.raises(_kernels.KernelError, match="not capturing"):
            _kernels.count_launch(wrapper, "kpg_fake_f32")
    assert not tally and wrapper.launches == 0


def test_one_key_solved_on_two_threads(graphed_cpu):
    """Two threads solve two Problems of one key at once, passing one
    dispatch lock: one Program serves both in turn, each result bit for
    bit the eager solve."""
    probs = [_graph(n=100, loops=20, n_cap=128, e_cap=32, seed=0),
             _graph(n=90, loops=16, n_cap=128, e_cap=32, seed=1, drop=5)]
    kw = dict(PRODUCT, max_iterations=3)
    lock = threading.Lock()
    built = len(graphs.LOG)
    with ThreadPoolExecutor(max_workers=2) as pool:
        got = list(pool.map(lambda p: tlm.lm_solve(
            p, dispatch_lock=lock, **kw), probs))
    assert len(graphs.LOG) == built + 1 and len(graphs._programs) == 1
    for res, p in zip(got, probs):
        want = tlm._lm_solve_eager(p, **kw)
        assert all(torch.equal(x, y) for x, y in zip(res, want))


@pytest.mark.parametrize("proportional", [True, False])
def test_warmup_pairs_match_reference(proportional):
    for initial in ((1024, 256), (128, 32), (512, 512)):
        caps = [c.CapacityConfig(initial_nodes=initial[0],
                                 initial_edges=initial[1])
                for c in (jconfig, tconfig)]
        for max_nodes in (1, 100, 1024, 1500, 5000, 30000, 65536):
            for max_edges in (1, 200, 256, 2500, 10000, 30000, 65536):
                want = jengine._warmup_pairs(caps[0], max_nodes, max_edges,
                                             proportional)
                assert tengine._warmup_pairs(
                    caps[1], max_nodes, max_edges, proportional) == want


def _engine_config():
    return tconfig.Config(
        solver=tconfig.SolverConfig(dtype="float32", adaptive_fp64=False,
                                    max_lm_iterations=3),
        capacity=tconfig.CapacityConfig(initial_nodes=128, initial_edges=32))


def test_engine_warmup_captures_the_ladder(graphed_cpu):
    """warmup captures every bucket of the ladder (one Program each, a
    warmup_stats row each) and returns their number; a stream through the
    warmed buckets takes no capture on its trigger path, and one past
    them captures its own bucket."""
    store = GraphStore()
    eng = tengine.SolverEngine(store, _engine_config(), device="cpu")
    pairs = tengine._warmup_pairs(eng.config.capacity, 200, 40)
    built = len(graphs.LOG)
    assert eng.warmup(200, 40) == len(pairs) == len(graphs.LOG) - built == 4
    assert [(r["n_cap"], r["e_cap"]) for r in eng.warmup_stats] == pairs
    assert all(r["captured"] and r["first_replay_s"] > 0
               for r in eng.warmup_stats)
    assert eng.warmup(200, 40) == 4 and len(graphs.LOG) - built == 4
    assert not any(r["captured"] for r in eng.warmup_stats[4:])
    for i in range(300):
        store.add_node(T0 + i * S, nse3.quat_identity(), [float(i), 0, 0])
        if i in (60, 150, 260):
            store.add_loop_edge(T0 + i * S, T0 + (i - 50) * S,
                                nse3.quat_identity(), [50.0, 0, 0], 1.0)
            assert eng.trigger()
    rows = [r for r in eng.solve_stats if "trigger_wall_ms" in r]
    assert [r["trigger_captures"] for r in rows] == [0, 0, 1]


def test_background_warmup_takes_the_first_bucket_first(graphed_cpu):
    store = GraphStore()
    eng = tengine.SolverEngine(store, _engine_config(), device="cpu")
    built = len(graphs.LOG)
    assert eng.warmup(200, 40, background=True) == 4
    assert len(eng.warmup_stats) >= 1
    assert (eng.warmup_stats[0]["n_cap"], eng.warmup_stats[0]["e_cap"]) == \
        (128, 32)
    assert eng.warmup_join(timeout=120)
    assert [(r["n_cap"], r["e_cap"]) for r in eng.warmup_stats] == \
        tengine._warmup_pairs(eng.config.capacity, 200, 40)
    assert len(graphs.LOG) - built == 4

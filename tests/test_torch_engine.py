"""PyTorch port: the streaming engine's synchronous trigger path, replaying
the trigger-gating, streaming-growth, multi-world-kidnap, fp64-escalation
and async-dispatch scenarios of tests/test_engine.py through both engines.

Both run on the CPU with the same solver settings; the JAX engine is set to
the port's formulation (scatter loop matvec, AoS band build, the full
problem build). Plain scenarios run fp64 without escalation; the escalation
scenarios run fp32 with the ladder forced, and the exact-step fp64 rung's
poses must agree as closely. Every optimized pose must agree to 1e-8 of its
scale, and every trigger must fire in both."""

import dataclasses

import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu import config as jconfig
from solve_keyframe_pose_graph_tpu.graph.store import GraphStore as JaxStore
from solve_keyframe_pose_graph_tpu.solver.engine import (
    SolverEngine as JaxEngine,
)
from solve_keyframe_pose_graph_tpu_torch import config as tconfig
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.solver.engine import SolverEngine
from solve_keyframe_pose_graph_tpu_torch.utils import nse3

from test_engine import S, T0, yaw_quat
from test_torch_threads import one_torch_thread  # noqa: F401


def _config(c=tconfig):
    """The test config, built from the port's config module (`c=tconfig`)
    or the JAX package's (`c=jconfig`): each engine takes its own."""
    return c.Config(
        solver=c.SolverConfig(dtype="float64", adaptive_fp64=False,
                              loop_impl="scatter", band_impl="aos"),
        stream=c.StreamConfig(async_dispatch=False, incremental_build=False),
        # small first buckets keep both packages' CPU solves short
        capacity=c.CapacityConfig(initial_nodes=128, initial_edges=32),
        io=c.IOConfig(compile_cache_dir=""))


class _Both:
    """One store per engine, fed the same calls."""

    def __init__(self):
        self.stores = (JaxStore(), GraphStore())
        self.jax = JaxEngine(self.stores[0], _config(jconfig))
        self.port = SolverEngine(self.stores[1], _config(), device="cpu")

    def __getattr__(self, name):          # store calls go to both stores
        def call(*args, **kw):
            out = [getattr(s, name)(*args, **kw) for s in self.stores]
            assert out[0] == out[1] or (
                out[0] is None and out[1] is None), name
            return out[0]
        return call

    def trigger(self) -> bool:
        fired = (self.jax.trigger(), self.port.trigger())
        assert fired[0] == fired[1]
        return fired[0]

    def check_poses(self):
        n = self.stores[0].node_len
        assert self.port.n_opt_variables() == self.jax.n_opt_variables()
        assert self.port.solved_until == self.jax.solved_until
        ref = np.array([np.concatenate(self.jax.get_node_pose(i))
                        for i in range(self.jax.n_opt_variables())])
        got = np.array([np.concatenate(self.port.get_node_pose(i))
                        for i in range(self.port.n_opt_variables())])
        if n:
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-8 * max(np.abs(ref).max(), 1))
        for js, ts in zip(self.jax.solve_stats, self.port.solve_stats):
            for k in ("trigger", "node_len", "edge_len", "lm_iterations",
                      "successful_steps", "cg_iterations"):
                assert ts[k] == js[k], k
            np.testing.assert_allclose(ts["final_cost"], js["final_cost"],
                                       rtol=1e-6, atol=1e-12)
            assert ts["final_cost"] <= ts["initial_cost"]


def test_trigger_gating_matches_reference():
    b = _Both()
    assert not b.trigger()
    b.add_node(T0, nse3.quat_identity(), [0, 0, 0])
    b.add_node(T0 + S, nse3.quat_identity(), [1, 0, 0])
    assert not b.trigger()
    b.add_loop_edge(T0 + S, T0, nse3.quat_identity(), [-1.05, 0, 0], 1.0)
    assert b.trigger()
    assert b.port.solved_until == 1
    assert not b.trigger()
    b.mark_as_kidnapped(T0 + 2 * S)
    b.mark_as_unkidnapped(T0 + 3 * S)
    b.add_node(T0 + 4 * S, nse3.quat_identity(), [0, 0, 0])
    b.mark_as_kidnapped(T0 + 5 * S)
    b.add_loop_edge(T0 + S, T0, nse3.quat_identity(), [-1, 0, 0], 1.0)
    assert not b.trigger()
    b.mark_as_unkidnapped(T0 + 6 * S)
    assert b.trigger()
    b.check_poses()
    assert not b.port.collect() and not b.port.drain()


def test_streaming_growth_matches_reference():
    rng = np.random.default_rng(0)
    b = _Both()
    N = 120
    drift = np.cumsum(rng.normal(scale=0.02, size=(N, 3)), axis=0)
    for i in range(N):
        b.add_node(T0 + i * S, nse3.quat_identity(),
                   np.array([float(i), 0, 0]) + drift[i])
        if i > 0 and i % 30 == 0:
            b.add_loop_edge(T0 + i * S, T0 + (i - 20) * S,
                            nse3.quat_identity(), np.array([20.0, 0, 0]),
                            1.0)
            assert b.trigger()
            assert b.port.solved_until == i
            b.check_poses()
    assert b.port.trigger_id == 3


def test_multiworld_kidnap_merge_matches_reference():
    b = _Both()
    n0 = 40
    for i in range(n0):
        b.add_node(T0 + i * S, nse3.quat_identity(), [float(i), 0, 0])
    b.add_loop_edge(T0 + 30 * S, T0 + 10 * S, nse3.quat_identity(),
                    [-20.0, 0, 0], 1.0)
    assert b.trigger()
    b.kidnap_indicator(T0 + int((n0 + 0.5) * S), "kidnapped")
    for k in range(6):
        b.add_node(T0 + int((n0 + 1 + k * 0.5) * S), nse3.quat_identity(),
                   [100.0 + k, -50.0, 0])
    b.kidnap_indicator(T0 + int((n0 + 4.5) * S), "unkidnapped")
    q_w01 = yaw_quat(np.pi / 2)
    t_w01 = np.array([5.0, 7.0, 0.0])
    w1_nodes = [b.add_node(T0 + (n0 + 5 + j) * S, nse3.quat_identity(),
                           [float(j), 0, 0]) for j in range(30)]
    a, bb = w1_nodes[10], 20
    q_a_w0, t_a_w0 = nse3.pose_mul(q_w01, t_w01, nse3.quat_identity(),
                                   [10.0, 0, 0])
    qi, ti = nse3.pose_inv(nse3.quat_identity(), np.array([20.0, 0, 0]))
    q_bta, t_bta = nse3.pose_mul(qi, ti, q_a_w0, t_a_w0)
    b.add_loop_edge(T0 + (n0 + 15) * S, T0 + bb * S, q_bta, t_bta, 1.0)
    assert b.trigger()
    assert b.stores[1].worlds.find_setID_of_world_i(1) == 0
    b.check_poses()
    for j, idx in enumerate(w1_nodes):
        _, t_gt = nse3.pose_mul(q_w01, t_w01, nse3.quat_identity(),
                                [float(j), 0, 0])
        np.testing.assert_allclose(b.port.get_node_pose(idx)[1], t_gt,
                                   atol=0.2)


def test_load_state_freezes_restored_nodes_as_reference():
    """Checkpoint restore: restored poses are frozen (the reference marks
    them constant) while the live session solves around them."""
    b = _Both()
    rng = np.random.default_rng(3)
    n_old = 30
    q_old = np.tile(nse3.quat_identity(), (n_old, 1))
    t_old = np.stack([np.arange(n_old, dtype=float),
                      rng.normal(scale=0.01, size=n_old),
                      np.zeros(n_old)], -1)
    for eng in (b.jax, b.port):
        eng.load_state(q_old, t_old)
    for i in range(60):
        b.add_node(T0 + i * S, nse3.quat_identity(),
                   [float(i) + 0.03 * i, 0.0, 0.0])
    b.add_loop_edge(T0 + 55 * S, T0 + 15 * S, nse3.quat_identity(),
                    [-40.0, 0, 0], 1.0)
    assert b.trigger()
    b.check_poses()
    for i in range(n_old):
        np.testing.assert_array_equal(b.port.get_node_pose(i)[1], t_old[i])


def _escalating(background: bool, c=tconfig):
    """fp32 solves with the ladder forced (escalate_rejects=0), background
    or inline."""
    cfg = _config(c)
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, dtype="float32",
                                        adaptive_fp64=True,
                                        escalate_rejects=0),
        stream=dataclasses.replace(cfg.stream,
                                   background_escalation=background))


def _both_fp32_stream(background: bool, n: int, loop: tuple, offset: float):
    b = _Both()
    b.jax = JaxEngine(b.stores[0], _escalating(background, jconfig))
    b.port = SolverEngine(b.stores[1], _escalating(background), device="cpu")
    rng = np.random.default_rng(7)
    for i in range(n):
        b.add_node(T0 + i * S, nse3.quat_identity(),
                   [float(i), rng.normal() * 0.05, 0])
    i, j = loop
    t_rel = (np.asarray(b.stores[0].node_pose(i)[1])
             - np.asarray(b.stores[0].node_pose(j)[1]) + offset)
    b.add_loop_edge(T0 + i * S, T0 + j * S, nse3.quat_identity(), t_rel, 1.0)
    return b


def _assert_escalated_poses_match(b):
    n = b.stores[0].node_len
    ref = b.jax._opt_t[:n]
    np.testing.assert_allclose(b.port._opt_t[:n], ref, rtol=0,
                               atol=1e-8 * max(np.abs(ref).max(), 1))
    np.testing.assert_allclose(b.port._opt_q[:n], b.jax._opt_q[:n], rtol=0,
                               atol=1e-8)


def test_distressed_solve_escalates_inline_as_reference():
    """A distressed solve is re-solved on the fp64 ladder inside the
    trigger, as the reference engine does with background escalation off
    (tests/test_engine.py test_background_escalation_off_is_inline): the
    trigger's row records the rung and the written-back poses are the
    exact-step fp64 ones."""
    b = _both_fp32_stream(False, 40, (30, 5), 0.05)
    assert b.trigger()
    rows = [[r for r in e.solve_stats if "fp64_escalated" in r][-1]
            for e in (b.jax, b.port)]
    assert rows[1]["fp64_escalated"] == rows[0]["fp64_escalated"] \
        == "fp64-cpu"
    assert not [r for r in b.port.solve_stats
                if r.get("background_escalation")]
    np.testing.assert_allclose(rows[1]["final_cost"], rows[0]["final_cost"],
                               rtol=1e-9)
    _assert_escalated_poses_match(b)
    with pytest.raises(IndexError):
        b.port.get_node_pose(40)


def test_background_escalation_serves_fp32_then_lands_as_reference():
    """tests/test_engine.py test_background_escalation_serves_fp32_then_
    lands through both engines: the trigger serves its fp32 result (row
    "pending"), the escalated re-solve lands by drain() and its poses agree
    with the reference's."""
    b = _both_fp32_stream(True, 60, (50, 10), 0.1)
    assert b.trigger()
    for eng in (b.jax, b.port):
        row = [r for r in eng.solve_stats if "fp64_escalated" in r][-1]
        assert row["fp64_escalated"] == "pending"
        eng.drain()
    rows = [[r for r in e.solve_stats if r.get("background_escalation")][-1]
            for e in (b.jax, b.port)]
    assert "escalation_error" not in rows[1], rows[1]
    assert rows[1]["escalated_rung"] == rows[0]["escalated_rung"]
    assert rows[1]["applied"] is rows[0]["applied"] is True
    assert rows[1]["rung_stats"]["n_cap"] == 60     # live-length repack
    np.testing.assert_allclose(rows[1]["final_cost"], rows[0]["final_cost"],
                               rtol=1e-9)
    _assert_escalated_poses_match(b)


def test_async_dispatch_matches_sync_and_reference():
    """tests/test_engine.py test_async_dispatch_pipeline_matches_sync with
    the port engine in both modes, and the JAX engine's async run as the
    reference: after the final drain all land at the same fixed point."""
    def run(eng, store):
        rng = np.random.default_rng(5)
        for i in range(120):
            store.add_node(T0 + i * S, nse3.quat_identity(),
                           [float(i), rng.normal() * 0.05, 0])
            if i in (50, 80, 110):
                j = i - 40
                store.add_loop_edge(
                    T0 + i * S, T0 + j * S, nse3.quat_identity(),
                    np.asarray(store.node_pose(i)[1])
                    - np.asarray(store.node_pose(j)[1]), 1.0)
                assert eng.trigger()
        eng.drain()
        eng.trigger()
        eng.drain()
        return eng

    def cfg(async_mode, c=tconfig):
        cf = _config(c)
        return dataclasses.replace(cf, stream=dataclasses.replace(
            cf.stream, async_dispatch=async_mode))

    s_sync, s_async, s_ref = GraphStore(), GraphStore(), JaxStore()
    e_sync = run(SolverEngine(s_sync, cfg(False), device="cpu"), s_sync)
    e_async = run(SolverEngine(s_async, cfg(True), device="cpu"), s_async)
    e_ref = run(JaxEngine(s_ref, cfg(True, jconfig)), s_ref)
    assert e_async.solved_until == e_sync.solved_until == e_ref.solved_until
    su = e_sync.solved_until + 1
    np.testing.assert_allclose(e_async._opt_t[:su], e_sync._opt_t[:su],
                               atol=1e-8)
    np.testing.assert_allclose(e_async._opt_t[:su], e_ref._opt_t[:su],
                               atol=1e-8)
    assert len(e_async.solve_stats) == len(e_ref.solve_stats)
    assert not e_async.collect()


def _port_fp32_stream(background: bool, fp64_backend: str, n: int = 40):
    cfg = _escalating(background)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, fp64_backend=fp64_backend))
    store = GraphStore()
    eng = SolverEngine(store, cfg, device="cpu")
    rng = np.random.default_rng(7)
    for i in range(n):
        store.add_node(T0 + i * S, nse3.quat_identity(),
                       [float(i), rng.normal() * 0.05, 0])
    store.add_loop_edge(T0 + 30 * S, T0 + 5 * S, nse3.quat_identity(),
                        np.asarray(store.node_pose(30)[1])
                        - np.asarray(store.node_pose(5)[1]) + 0.05, 1.0)
    return eng


@pytest.mark.parametrize("kind", ["device_rung_kernel", "host_rung_numeric"])
def test_background_escalation_failure(monkeypatch, kind):
    """A kernel that fails on the device rung of a background escalation is
    raised on the solver loop (by drain(), once); a host rung's numeric
    failure is logged and the fp32 result kept, as in the reference
    engine."""
    from solve_keyframe_pose_graph_tpu_torch.ops import _kernels
    from solve_keyframe_pose_graph_tpu_torch.ops import band_matvec as k1
    from solve_keyframe_pose_graph_tpu_torch.solver import cpu_rung

    if kind == "device_rung_kernel":
        wrapper = k1.band_matvec

        def failing(D, B, x):           # the fp64 rung's K1 fails to launch
            if x.dtype == torch.float64:
                raise _kernels.KernelError(
                    "CUDA kernel band_matvec failed to launch")
            return wrapper(D, B, x)

        monkeypatch.setattr(k1, "band_matvec", failing)
        eng = _port_fp32_stream(True, "tpu")
    else:
        def failing(*a, **k):
            raise FloatingPointError("LDL pivot underflow")

        monkeypatch.setattr(cpu_rung, "cpu_fp64_resolve", failing)
        eng = _port_fp32_stream(True, "cpu")
    assert eng.trigger()
    served = eng._opt_t[:40].copy()
    if kind == "device_rung_kernel":
        with pytest.raises(_kernels.KernelError, match="band_matvec"):
            eng.drain()
    else:
        eng.drain()
    assert not eng.drain()                      # raised once, then clear
    row = [r for r in eng.solve_stats if r.get("background_escalation")][-1]
    assert "escalation_error" in row
    np.testing.assert_array_equal(eng._opt_t[:40], served)


def test_background_warmup_failure_is_raised_by_join(monkeypatch):
    from solve_keyframe_pose_graph_tpu_torch.ops import _kernels
    from solve_keyframe_pose_graph_tpu_torch.ops import lm as lm_ops

    def failing(*a, **k):
        raise _kernels.KernelError("nvcc failed (1) building gj_inv")

    monkeypatch.setattr(lm_ops, "lm_solve", failing)
    eng = SolverEngine(GraphStore(), _config(), device="cpu")
    eng.warmup(64, 16, background=True)
    with pytest.raises(_kernels.KernelError, match="nvcc"):
        eng.warmup_join(timeout=60)


def test_entry_points_default_to_the_card():
    """SolverEngine, PoseGraphServer and build_problem_np target "cuda"
    unless asked for the CPU; without a CUDA device the default raises at
    construction and nothing carries on on the CPU."""
    import inspect

    from solve_keyframe_pose_graph_tpu_torch.runtime_server import (
        PoseGraphServer,
    )
    from solve_keyframe_pose_graph_tpu_torch.solver import problem as tprob

    for fn in (SolverEngine.__init__, PoseGraphServer.__init__,
               tprob.build_problem_np):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert SolverEngine(GraphStore(), _config()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolverEngine(GraphStore(), _config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoseGraphServer(GraphStore(), _config())
    from test_torch_problem import _graph_kwargs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprob.build_problem_np(**_graph_kwargs())
    assert SolverEngine(GraphStore(), _config(),
                        device="cpu").device.type == "cpu"


@pytest.mark.parametrize("entry", ["engine", "server", "cli"])
def test_multi_device_config_is_refused(entry, tmp_path):
    """A cuda config asking for more cards than exist is refused at
    construction by every entry point, naming how many there are; the same
    mesh of CPU shards runs (parallel/), and a mesh passed in must have
    mesh.n_devices shards on the entry point's device type. Nothing runs
    on fewer devices than asked for, or on other ones."""
    from solve_keyframe_pose_graph_tpu_torch import cli
    from solve_keyframe_pose_graph_tpu_torch.parallel import make_mesh
    from solve_keyframe_pose_graph_tpu_torch.runtime_server import (
        PoseGraphServer,
    )

    have = torch.cuda.device_count()
    need = max(2, have + 1)
    cfg = _config()
    too_many = dataclasses.replace(
        cfg, mesh=dataclasses.replace(cfg.mesh, n_devices=need))
    if entry == "cli":
        path = tmp_path / "mesh.json"
        path.write_text(too_many.to_json())
        store = GraphStore()
        store.add_node(T0, nse3.quat_identity(), [0, 0, 0])
        store.save_as_json(str(tmp_path / "g.json"))
        argv = ["solve", "--input", str(tmp_path / "g.json"), "--output",
                str(tmp_path / "out.json"), "--config", str(path)]
        with pytest.raises(SystemExit,
                           match=f"needs {need} CUDA devices, {have} "
                           "available"):
            cli.main(argv + ["--device", "cuda"])
        assert cli.main(argv + ["--device", "cpu"]) == 0
        return
    make = SolverEngine if entry == "engine" else PoseGraphServer
    with pytest.raises(ValueError, match=f"need {need} cuda devices.*"
                       f"have {have}"):
        make(GraphStore(), too_many, device="cuda")
    with pytest.raises(ValueError, match=f"passed in has {need + 1} shards"):
        make(GraphStore(), too_many, device="cpu",
             mesh=make_mesh(devices=["cpu"] * (need + 1)))
    with pytest.raises(ValueError, match="device cuda but the mesh passed "
                       "in is on"):
        make(GraphStore(), too_many, device="cuda",
             mesh=make_mesh(devices=["cpu"] * need))
    meshed = make(GraphStore(), too_many, device="cpu")
    engine = meshed if entry == "engine" else meshed.engine
    assert len(engine.mesh) == need and engine.device.type == "cpu"
    assert make(GraphStore(), cfg, device="cpu").config.mesh.n_devices == 1


def test_anchors_come_from_the_solved_nodes_under_concurrent_ingest():
    """The server ingests beside the solver: nodes, a kidnap and a new
    world can land between the trigger's read of node_len and its soft
    anchors. The trigger then solves the nodes it read, anchored as if the
    late ones had not arrived. (The reference takes the new world's first
    node as an anchor and indexes its pose arrays with it, past their end
    once that node is beyond the capacity: 130 > 128 here.)"""

    class RacingStore(GraphStore):
        armed = False

        def node_worlds(self):
            if self.armed:                    # lands mid-trigger, once
                self.armed = False
                for j in range(30):           # world 0 goes on
                    self.add_node(T0 + (100 + j) * S, nse3.quat_identity(),
                                  [100.0 + j, 0, 0])
                kidnap(self)
                for j in range(30):           # world 1
                    self.add_node(T0 + (131 + j) * S, nse3.quat_identity(),
                                  [500.0 + j, 0, 0])
            return super().node_worlds()

    def kidnap(store):
        store.kidnap_indicator(T0 + 130 * S, "kidnapped")
        store.kidnap_indicator(T0 + 130 * S + S // 2, "unkidnapped")

    def feed(store):
        rng = np.random.default_rng(4)
        for i in range(100):
            store.add_node(T0 + i * S, nse3.quat_identity(),
                           [float(i), rng.normal() * 0.05, 0])
        store.add_loop_edge(T0 + 90 * S, T0 + 10 * S, nse3.quat_identity(),
                            [-80.0, 0.3, 0], 1.0)

    # the calm store has the same kidnap but none of the late nodes
    racing, calm = RacingStore(), GraphStore()
    feed(racing)
    feed(calm)
    kidnap(calm)
    racing.armed = True
    engines = [SolverEngine(s, _config(), device="cpu")
               for s in (racing, calm)]
    assert all(e.trigger() for e in engines)
    assert racing.node_len == 160 and racing.n_worlds() == 2
    assert racing.nodeidx_of_world_i_started(1) == 130
    rows = [e.solve_stats[-1] for e in engines]
    assert rows[0]["node_len"] == rows[1]["node_len"] == 100
    np.testing.assert_allclose(rows[0]["final_cost"], rows[1]["final_cost"],
                               rtol=1e-12, atol=1e-30)
    np.testing.assert_array_equal(engines[0]._opt_t[:100],
                                  engines[1]._opt_t[:100])


def test_initial_guess_table_fuzz_vs_literal_port():
    """tests/test_engine.py's fuzz through the port: >= 100 triggers of 60
    random kidnap / loop schedules (3+ worlds, merges, multi-hop world
    inference), at each of which the port's vectorized 4-case table
    (_set_initial_guesses) equals the literal per-node port of the
    reference loop (test_engine._initial_guesses_literal) bit for bit.
    The table reads the solved state, not how well it was solved, so the
    solves are one LM step of a few Jacobi-preconditioned CG iterations,
    which keeps the 200-odd CPU solves short."""
    from test_engine import _initial_guesses_literal

    cfg = _config()
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, max_lm_iterations=1, max_cg_iterations=4,
        preconditioner="jacobi"))
    rng = np.random.default_rng(1234)
    n_checked = 0
    for trial in range(60):
        store = GraphStore()
        eng = SolverEngine(store, cfg, device="cpu")

        orig_guesses = eng._set_initial_guesses

        def checked_guesses(node_len, node_worlds, eng=eng,
                            orig_guesses=orig_guesses):
            ql, tl = _initial_guesses_literal(eng, node_len, node_worlds)
            counts = orig_guesses(node_len, node_worlds)
            np.testing.assert_array_equal(eng._opt_q[:node_len], ql)
            np.testing.assert_array_equal(eng._opt_t[:node_len], tl)
            nonlocal n_checked
            n_checked += 1
            return counts

        eng._set_initial_guesses = checked_guesses

        t = T0
        kidnapped = False
        i = 0
        n_target = int(rng.integers(30, 80))
        while i < n_target:
            r = rng.random()
            if r < 0.08 and i > 8 and not kidnapped:
                store.kidnap_indicator(t, "kidnapped")
                kidnapped = True
                t += S
                continue
            if kidnapped and r < 0.5:
                store.kidnap_indicator(t, "unkidnapped")
                kidnapped = False
                t += S
                continue
            yaw = rng.normal() * 0.2
            store.add_node(t, yaw_quat(yaw),
                           [float(i), rng.normal() * 0.2, 0.0])
            if (not kidnapped and r > 0.85 and store.node_len > 10):
                j = int(rng.integers(0, store.node_len - 5))
                store.add_loop_edge(
                    t, store.node_timestamp(j), nse3.quat_identity(),
                    np.asarray(store.node_pose(store.node_len - 1)[1])
                    - np.asarray(store.node_pose(j)[1]), 1.0)
                eng.trigger()
            t += S
            i += 1
    assert n_checked >= 100, n_checked


def test_capacity_ceiling_enforced():
    """tests/test_engine.py's check: CapacityConfig.max_nodes / max_edges
    are hard ceilings at trigger time (the reference's static 30k arrays,
    PoseGraphSLAM.cpp:17-25)."""
    cfg = dataclasses.replace(_config(), capacity=tconfig.CapacityConfig(
        initial_nodes=16, initial_edges=8, max_nodes=32, max_edges=32))
    store = GraphStore()
    eng = SolverEngine(store, cfg, device="cpu")
    for i in range(40):
        store.add_node(T0 + i * S, nse3.quat_identity(), [float(i), 0, 0])
    store.add_loop_edge(T0 + 39 * S, T0, nse3.quat_identity(),
                        [39.0, 0, 0], 1.0)
    with pytest.raises(RuntimeError, match="capacity ceiling"):
        eng.trigger()


@pytest.mark.parametrize("adaptive,backend,loads", [
    (True, "auto", True), (True, "tpu", False), (False, "auto", False)])
def test_warmup_primes_the_host_rung(monkeypatch, adaptive, backend, loads):
    """warmup loads the host fp64 rung (the native LDL^T library and
    scipy) on a thread of its own when the config can escalate to it, as
    the reference's warmup primes its rung; not under fp64_backend="tpu"
    or without the ladder."""
    from solve_keyframe_pose_graph_tpu_torch.solver import cpu_rung
    from solve_keyframe_pose_graph_tpu_torch.solver import native_ldl

    if not cpu_rung.available():
        pytest.skip("host fp64 rung unavailable (libkpg_ldl.so / scipy)")
    monkeypatch.setattr(native_ldl, "_lib", None)
    cfg = _config()
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, adaptive_fp64=adaptive, fp64_backend=backend))
    eng = SolverEngine(GraphStore(), cfg, device="cpu")
    assert eng.warmup(128, 32) == 1
    assert eng.warmup_join(timeout=120)
    assert (eng._host_rung_thread is not None) is loads
    assert (native_ldl._lib is not None) is loads


def test_a_merge_trigger_is_not_escalated():
    """With the ladder forced (escalate_rejects=0), a one-world trigger is
    re-solved inline on it, and a trigger whose loop edge first joins two
    worlds is served as solved: its start placed a world by one edge, and
    the fp64 rung would repeat the same search (engine module note)."""
    store = GraphStore()
    eng = SolverEngine(store, _escalating(False), device="cpu")
    for i in range(20):
        store.add_node(T0 + i * S, nse3.quat_identity(), [float(i), 0, 0])
    store.add_loop_edge(T0 + 15 * S, T0 + 5 * S, nse3.quat_identity(),
                        [-10.0, 0, 0], 1.0)
    assert eng.trigger()
    assert eng.solve_stats[-1]["fp64_escalated"] == "fp64-cpu"
    store.kidnap_indicator(T0 + int(19.5 * S), "kidnapped")
    store.kidnap_indicator(T0 + int(20.5 * S), "unkidnapped")
    for j in range(10):
        store.add_node(T0 + (21 + j) * S, nse3.quat_identity(),
                       [float(j), 3.0, 0])
    store.add_loop_edge(T0 + 25 * S, T0 + 10 * S, nse3.quat_identity(),
                        [-6.0, 0, 0], 1.0)
    assert eng.trigger()
    row = eng.solve_stats[-1]
    assert row["first_contacts"] == 1 and row["mapped_nodes"] == 10
    assert row["fp64_escalated"] is False
    assert not [r for r in eng.solve_stats if r.get("background_escalation")]

"""PyTorch port: the LM solve over a mesh of CPU shards (parallel/
sharded_lm.py) against the port's single-device solve and the JAX
package's GSPMD-sharded solve, and the entry points' mesh path.

The bars are __graft_entry__.dryrun_multichip's fp64 certificate:
|d chi^2| <= 1e-9 max(1, |chi^2|), q and switches within 1e-9, t within
1e-8, with equal LM and CG counts. The single-device comparisons use a
graph whose solve is not sensitive to rounding: on some graphs (e.g.
__graft_entry__._make_problem(128, 16, 128, 16) under the band
preconditioner at the product defaults) a last-bit change of a sum flips
a CG stopping decision, and two single-device solves that differ only in
summation order land 1e-3 apart; no sharded solve can be held to 1e-9
there."""

import json

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from solve_keyframe_pose_graph_tpu.ops import lm as jlm
from solve_keyframe_pose_graph_tpu.parallel import (
    make_mesh as jax_mesh, shard_problem as jax_shard,
)
from solve_keyframe_pose_graph_tpu_torch import cli
from solve_keyframe_pose_graph_tpu_torch import config as tconfig
from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.ops import lm as tlm
from solve_keyframe_pose_graph_tpu_torch.parallel import (
    ShardedProblem, make_mesh, shard_problem,
)
from solve_keyframe_pose_graph_tpu_torch.solver.engine import SolverEngine
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    FIELDS, build_problem_np, problem_astype, problem_from_arrays,
)
from solve_keyframe_pose_graph_tpu_torch.utils import nse3

from test_cli_g2o import sphere_g2o  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401

PRODUCT = dict(max_iterations=10, max_cg_iterations=45, bcr_levels=2)


def cpu_mesh(P):
    return make_mesh(devices=["cpu"] * P)


def circle_problem(n=256, n_loops=32, n_cap=256, e_cap=32, **graph):
    g = synthetic.circle_graph(n_nodes=n, n_loops=n_loops, seed=0, **graph)
    return build_problem_np(
        q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t,
        node_valid=np.ones(n, bool), loop_pairs=g.loop_pairs,
        loop_q=g.loop_q, loop_t=g.loop_t, loop_w=g.loop_w,
        loop_valid=np.ones(n_loops, bool), switch=np.full(n_loops, 0.99),
        prior_idx=np.array([0]), prior_q=g.vio_q[:1], prior_t=g.vio_t[:1],
        prior_w=np.array([1.1]), n_cap=n_cap, e_cap=e_cap, p_cap=8,
        dtype=np.float64, device="cpu")


def assert_certificate(got, want, counts=True):
    """dryrun_multichip's bars."""
    c, c1 = float(got.final_cost), float(want.final_cost)
    assert abs(c - c1) <= 1e-9 * max(1.0, abs(c1)), (c, c1)
    for name, tol in (("q", 1e-9), ("t", 1e-8), ("switch", 1e-9)):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=tol, err_msg=name)
    if counts:
        for name in ("iterations", "successful_steps",
                     "total_cg_iterations"):
            assert int(getattr(got, name)) == int(getattr(want, name)), name


@pytest.mark.parametrize("preconditioner,mode,P,graph", [
    ("band+coarse", "6dof", 8, {}), ("band", "6dof", 4, {}),
    ("band+coarse", "4dof", 2,
     dict(n=250, n_loops=40, e_cap=64, outlier_fraction=0.1))])
def test_sharded_lm_matches_single_device(preconditioner, mode, P, graph):
    prob = circle_problem(**graph)
    kw = dict(PRODUCT, preconditioner=preconditioner, residual_mode=mode)
    want = tlm.lm_solve(prob, **kw)
    got = tlm.lm_solve(shard_problem(prob, cpu_mesh(P)), **kw)
    assert got.q.shape == want.q.shape and got.q.device == want.q.device
    assert float(got.final_cost) < 0.05 * float(got.initial_cost)
    assert_certificate(got, want)


@pytest.mark.parametrize("preconditioner", ["band", "band+coarse"])
def test_sharded_lm_matches_the_jax_gspmd_solve(preconditioner):
    """The 8-shard solve against the JAX package's lm_solve on its 8-device
    CPU mesh, on test_cli_g2o.py's sharded-solve inputs in fp64."""
    jp = ge._make_problem(n_nodes=128, n_loops=16, n_cap=128, e_cap=16,
                          dtype=np.float64)
    kw = dict(max_iterations=3, max_cg_iterations=10,
              preconditioner=preconditioner, coarse_group=16)
    want = jlm.lm_solve(jax_shard(jp, jax_mesh(8)), **kw)
    tp = problem_from_arrays({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                             "cpu")
    got = tlm.lm_solve(shard_problem(tp, cpu_mesh(8)), **kw)
    assert_certificate(got, want)


def test_escalation_rungs_take_a_sharded_problem(monkeypatch):
    """The host rung solves the gathered Problem (bitwise the unsharded
    rung); on the device ladder the mixed rung solves the ShardedProblem
    itself and the fp64 rung re-shards its fp64 repack over the same mesh.
    The fp64 rung runs CG to its cap of 100 iterations per LM step,
    where two fp64 CG runs whose sums differ only in order drift apart
    (30 iterations agree to 1e-15 on this graph, 100 to 1e-4), so its
    result is held to chi^2 within 1e-3 only."""
    prob32 = problem_astype(circle_problem(), torch.float32)
    mesh = cpu_mesh(4)
    sp = shard_problem(prob32, mesh)
    kw = dict(PRODUCT, preconditioner="band+coarse", max_iterations=3)
    want, rung, _ = tlm.escalate_resolve(prob32, kw, 0, fp64_backend="auto")
    got, rung_sh, _ = tlm.escalate_resolve(sp, kw, 0, fp64_backend="auto")
    assert rung_sh == rung == "fp64-cpu"
    for name in ("q", "t", "switch", "final_cost"):
        assert torch.equal(getattr(got, name), getattr(want, name))

    want, rung, _ = tlm.escalate_resolve(prob32, kw, 0, fp64_backend="tpu")
    solved = []
    real = tlm.lm_solve

    def spy(problem, **kw):
        solved.append(problem)
        return real(problem, **kw)

    monkeypatch.setattr(tlm, "lm_solve", spy)
    got, rung_sh, _ = tlm.escalate_resolve(sp, kw, 0, fp64_backend="tpu")
    assert rung_sh == rung == "fp64"
    mixed, p64 = solved
    assert mixed is sp
    assert isinstance(p64, ShardedProblem) and p64.mesh is mesh
    assert p64.dtype == torch.float64
    assert got.q.dtype == torch.float64 and got.q.shape == (256, 4)
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=1e-3)
    assert float(got.final_cost) < float(got.initial_cost)


def test_device_rung_on_a_mesh_that_is_not_a_power_of_two(monkeypatch):
    """The device rung repacks to multiples of lcm(1024, P): on 3 shards a
    capacity of 1536 stays 1536 (a repack to 1024, which 3 does not
    divide, could not be sharded again), and the sharded fp64 solve lands
    where the unsharded rung does, within the 1e-3 of the test above."""
    prob32 = problem_astype(circle_problem(n=100, n_loops=24, n_cap=1536,
                                           e_cap=24), torch.float32)
    kw = dict(PRODUCT, preconditioner="band", max_iterations=2)
    want, _, _ = tlm.escalate_resolve(prob32, kw, 0, fp64_backend="tpu")
    solved = []
    real = tlm.lm_solve

    def spy(problem, **kw):
        solved.append(problem)
        return real(problem, **kw)

    monkeypatch.setattr(tlm, "lm_solve", spy)
    sp = shard_problem(prob32, cpu_mesh(3))
    got, rung, _ = tlm.escalate_resolve(sp, kw, 0, fp64_backend="tpu")
    mixed, p64 = solved             # the mixed rung solves sp itself
    assert mixed is sp
    assert rung == "fp64" and isinstance(p64, ShardedProblem)
    assert (p64.n_cap, p64.e_cap, p64.n_shards) == (1536, 24, 3)
    assert got.q.dtype == torch.float64 and got.q.shape == (1536, 4)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=1e-3)
    assert float(got.final_cost) < float(got.initial_cost)


def _config(n_devices):
    c = tconfig
    return c.Config(
        solver=c.SolverConfig(dtype="float64", adaptive_fp64=False,
                              max_lm_iterations=5),
        capacity=c.CapacityConfig(initial_nodes=128, initial_edges=32),
        mesh=c.MeshConfig(n_devices=n_devices))


def _stream(store, eng, n=160, n_loops=120, seed=3):
    """n nodes with two kidnaps (10-node dead zones, each followed by a new
    VIO frame) and the circle's loop edges, triggering every 32 nodes."""
    g = synthetic.circle_graph(n_nodes=n, n_loops=n_loops, seed=seed,
                               outlier_fraction=0.1)
    rng = np.random.default_rng(seed)
    t0, dt = 1_000_000_000, 100_000_000
    q_w, t_w = nse3.quat_identity(), np.zeros(3)
    order = np.argsort(g.loop_pairs.max(axis=1), kind="stable")
    k = 0
    for i in range(n):
        if i in (50, 100):
            store.kidnap_indicator(t0 + i * dt - dt // 2, "kidnapped")
        if i in (60, 110):
            store.kidnap_indicator(t0 + i * dt - dt // 2, "unkidnapped")
            yaw = rng.uniform(-np.pi, np.pi)
            q_w = np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
            t_w = rng.normal(scale=10.0, size=3)
        q, t = nse3.pose_mul(q_w, t_w, g.vio_q[i], g.vio_t[i])
        store.add_node(t0 + i * dt, q, t)
        while k < n_loops and g.loop_pairs[order[k]].max() <= i:
            a, b = map(int, g.loop_pairs[order[k]])
            store.add_loop_edge_by_index(a, b, g.loop_q[order[k]],
                                         g.loop_t[order[k]],
                                         float(g.loop_w[order[k]]))
            k += 1
        if i % 32 == 31:
            eng.trigger()
    eng.drain()


def test_engine_replay_on_a_mesh_matches_one_device():
    """The stream's solves are well determined (as the module note asks):
    on outlier-free variants of it the last LM iterations move along flat
    directions at the level of rounding, and a 1-shard mesh, whose first
    steps are bitwise the unmeshed ones, lands 1e-4 of the scale away."""
    runs = {}
    for P in (1, 4):
        store = GraphStore()
        eng = SolverEngine(store, _config(P), device="cpu")
        assert (eng.mesh is None) == (P == 1)
        _stream(store, eng)
        runs[P] = (eng, np.array([np.concatenate(eng.get_node_pose(i))
                                  for i in range(eng.n_opt_variables())]))
    (e1, p1), (e4, p4) = runs[1], runs[4]
    assert store.n_worlds() == 3 and len(e4.solve_stats) >= 3
    assert store.worlds.find_setID_of_world_i(2) == 0     # all merged
    assert len(e4.solve_stats) == len(e1.solve_stats)
    np.testing.assert_allclose(p4, p1, rtol=0,
                               atol=1e-8 * np.abs(p1).max())
    for a, b in zip(e4.solve_stats, e1.solve_stats):
        for key in ("node_len", "edge_len", "lm_iterations", "cg_iterations"):
            assert a[key] == b[key], key
    assert e4.solve_stats[-1]["delta_builds"] == 0     # full builds only


def test_cli_config_driven_sharded_solve(sphere_g2o, tmp_path):  # noqa: F811
    """`kpg-solve-torch solve --config` with mesh.n_devices=8 on --device
    cpu against the unsharded CLI, at test_cli_g2o.py's tolerances."""
    path, _ = sphere_g2o
    cfgd = json.loads(tconfig.Config().to_json())
    cfgd["mesh"]["n_devices"] = 8
    cfgd["solver"]["max_lm_iterations"] = 6
    cfgp = str(tmp_path / "mesh.json")
    with open(cfgp, "w") as f:
        json.dump(cfgd, f)
    out_sh, out_1 = str(tmp_path / "sharded.json"), str(tmp_path / "one.json")
    assert cli.main(["solve", "--input", path, "--config", cfgp, "--output",
                     out_sh, "--device", "cpu"]) == 0
    assert cli.main(["solve", "--input", path, "--output", out_1,
                     "--max-iters", "6", "--device", "cpu"]) == 0
    sol_sh, sol_1 = (json.load(open(p)) for p in (out_sh, out_1))
    np.testing.assert_allclose(sol_sh["last_solve"]["final_cost"],
                               sol_1["last_solve"]["final_cost"], rtol=1e-2)

    def ts(sol):
        return np.array([[float(r.split(",")[3])
                          for r in n["w_T_c"].split(";")[:3]]
                         for n in sol["nodes"]])

    np.testing.assert_allclose(ts(sol_sh), ts(sol_1), atol=5e-2)

"""PyTorch port: Problem construction against the JAX package, and the
port's import hygiene (it imports neither jax nor the JAX package)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu.graph import synthetic
from solve_keyframe_pose_graph_tpu.solver import problem as jprob
from solve_keyframe_pose_graph_tpu_torch.solver import problem as tprob

from test_cli_g2o import sphere_g2o  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graph_kwargs(n=120, n_loops=30, seed=4):
    g = synthetic.circle_graph(n_nodes=n, n_loops=n_loops, seed=seed)
    node_valid = np.ones(n, bool)
    node_valid[50:53] = False                      # a kidnap dead zone
    loop_valid = np.ones(n_loops, bool)
    loop_valid[::7] = False
    free = np.ones(n, bool)
    free[:10] = False                              # restored, frozen
    return dict(
        q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t,
        node_valid=node_valid, loop_pairs=g.loop_pairs, loop_q=g.loop_q,
        loop_t=g.loop_t, loop_w=g.loop_w, loop_valid=loop_valid,
        switch=np.linspace(0.5, 0.99, n_loops), prior_idx=np.array([0, 60]),
        prior_q=g.vio_q[[0, 60]], prior_t=g.vio_t[[0, 60]],
        prior_w=np.array([1.1, 2.0]), node_free=free,
        n_cap=256, e_cap=64, p_cap=4)


def _fields(p):
    return {f: np.asarray(getattr(p, f)) for f in tprob.FIELDS}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_build_problem_matches_reference(dtype):
    kw = _graph_kwargs()
    ref = _fields(jprob.build_problem_np(dtype=dtype, **kw))
    port = tprob.build_problem_np(device="cpu", dtype=dtype, **kw)
    assert len(tprob.FIELDS) == 20
    for name in tprob.FIELDS:
        got = getattr(port, name)
        assert got.device.type == "cpu"
        assert tuple(got.shape) == ref[name].shape, name
        assert got.numpy().dtype == ref[name].dtype, name
        np.testing.assert_array_equal(got.numpy(), ref[name], err_msg=name)
    assert (port.n_cap, port.fanout, port.e_cap, port.p_cap) == (256, 5, 64, 4)
    assert port.dtype == (torch.float32 if dtype == np.float32
                          else torch.float64)


def test_build_problem_rejects_overflow():
    kw = _graph_kwargs()
    kw["e_cap"] = 16
    with pytest.raises(ValueError, match="capacities"):
        tprob.build_problem_np(device="cpu", **kw)


def test_problem_from_arrays_round_trips():
    ref = jprob.build_problem_np(dtype=np.float64, **_graph_kwargs())
    port = tprob.problem_from_arrays(_fields(ref), "cpu")
    back = tprob.problem_from_arrays(
        {f: getattr(port, f).numpy() for f in tprob.FIELDS}, "cpu")
    for name in tprob.FIELDS:
        np.testing.assert_array_equal(getattr(back, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_problem_astype_and_live_lengths():
    kw = _graph_kwargs()
    ref = jprob.build_problem_np(dtype=np.float64, **kw)
    port = tprob.problem_from_arrays(_fields(ref), "cpu")
    p32 = tprob.problem_astype(port, torch.float32)
    assert p32.q.dtype == torch.float32 and p32.loop_a.dtype == torch.int32
    np.testing.assert_array_equal(
        p32.t.numpy(), np.asarray(ref.t).astype(np.float32))
    assert tprob.live_lengths(port) == jprob.live_lengths(ref)


@pytest.mark.parametrize("n_len,e_len,gran", [(100, 20, 1), (100, 20, 64),
                                              (256, 64, 1)])
def test_repack_problem_matches_reference(n_len, e_len, gran):
    kw = _graph_kwargs()
    ref = jprob.repack_problem(jprob.build_problem_np(dtype=np.float64, **kw),
                               n_len, e_len, granularity=gran)
    port = tprob.build_problem_np(device="cpu", dtype=np.float64, **kw)
    got = tprob.repack_problem(port, n_len, e_len, granularity=gran)
    for name in tprob.FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert (got is port) == ((got.n_cap, got.e_cap) == (256, 64))


_ISOLATED = r"""
import importlib, pkgutil, sys

class Refuse:
    # refuses jax and every module of the JAX package
    def find_spec(self, name, path=None, target=None):
        top = name.partition(".")[0]
        if top in ("jax", "jaxlib", "solve_keyframe_pose_graph_tpu"):
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
import torch
torch.set_num_threads(1)        # as test_torch_threads pins the workers
import solve_keyframe_pose_graph_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke                       # its main() is guarded
import bench_torch                      # so is bench_torch's
assert bench_torch.metric_name(5000, 10000) == "lm_solve_5k10k_ms"
import bench_stream_torch               # and bench_stream_torch's
assert "streaming_2k_400" in bench_stream_torch.ROWS
assert len(names) >= 25, names
assert {pkg.__name__ + ".parallel." + m for m in
        ("sharding", "collectives", "sharded_lm", "sharded_pcg")} <= set(names)
assert pkg.__name__ + ".graph.datasets" in names

from solve_keyframe_pose_graph_tpu_torch import cli
from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
from solve_keyframe_pose_graph_tpu_torch.ops.lm import lm_solve
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    build_problem_np)

g = synthetic.circle_graph(n_nodes=64, n_loops=8, seed=0)
prob = build_problem_np(
    q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t,
    node_valid=np.ones(64, bool), loop_pairs=g.loop_pairs, loop_q=g.loop_q,
    loop_t=g.loop_t, loop_w=g.loop_w, loop_valid=np.ones(8, bool),
    switch=np.full(8, 0.99), prior_idx=np.array([0]), prior_q=g.vio_q[:1],
    prior_t=g.vio_t[:1], prior_w=np.array([1.1]), n_cap=64, e_cap=8,
    p_cap=2, device="cpu")
res = lm_solve(prob, max_iterations=3, preconditioner="band+coarse",
               coarse_group=16)
assert float(res.final_cost) < float(res.initial_cost)
for kw in (dict(residual_mode="4dof"), dict(preconditioner="band*coarse")):
    res = lm_solve(prob, max_iterations=3, max_cg_iterations=10,
                   coarse_group=16, **kw)
    assert float(res.final_cost) < float(res.initial_cost), kw
from solve_keyframe_pose_graph_tpu_torch.parallel import (
    make_mesh, shard_problem)
res = lm_solve(shard_problem(prob, make_mesh(2, device_type="cpu")),
               max_iterations=3, preconditioner="band+coarse",
               coarse_group=16)
assert float(res.final_cost) < float(res.initial_cost)
# the mixed rung, alone, on the device ladder and on the mesh
from solve_keyframe_pose_graph_tpu_torch.ops.lm import escalate_resolve
kw = dict(max_iterations=3, preconditioner="band+coarse", coarse_group=16)
res, rung, stats = escalate_resolve(prob, kw, 3, fp64_backend="tpu")
assert rung in ("mixed", "fp64") and res.q.dtype == torch.float64, rung
assert stats["mixed_lm_iterations"] >= 1
res = lm_solve(shard_problem(prob, make_mesh(2, device_type="cpu")),
               precision="mixed", **kw)
assert res.q.dtype == torch.float64
assert float(res.final_cost) < float(res.initial_cost)
from solve_keyframe_pose_graph_tpu_torch.graph import datasets
for make in datasets.DATASETS.values():
    assert make(n_nodes=200, n_loops=20, seed=3).n_nodes == 200
from solve_keyframe_pose_graph_tpu_torch.solver.incremental import (
    IncrementalBuilder)
builder = IncrementalBuilder()
for n, e in ((32, 4), (64, 8)):
    builder.build(
        q=g.vio_q[:n], t=g.vio_t[:n], vio_q=g.vio_q[:n], vio_t=g.vio_t[:n],
        node_valid=np.ones(n, bool), loop_pairs=g.loop_pairs[:e],
        loop_q=g.loop_q[:e], loop_t=g.loop_t[:e], loop_w=g.loop_w[:e],
        loop_valid=np.ones(e, bool), switch=np.full(e, 0.99),
        prior_idx=np.array([0]), prior_q=g.vio_q[:1], prior_t=g.vio_t[:1],
        prior_w=np.array([1.1]), n_cap=256, e_cap=128, p_cap=2,
        device="cpu")
assert (builder.full_builds, builder.delta_builds) == (1, 1)
assert cli.main(["solve", "--input", sys.argv[1], "--output", sys.argv[2],
                 "--max-iters", "2", "--device", "cpu"]) == 0
bad = sorted(m for m in sys.modules if m.partition(".")[0] in
             ("jax", "jaxlib", "solve_keyframe_pose_graph_tpu"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax(sphere_g2o, tmp_path):  # noqa: F811
    """Every module of the port (parallel/* included), chip_smoke.py,
    bench_torch.py and bench_stream_torch.py load, and CPU lm_solves (6-DOF with band+coarse and
    band*coarse, 4-DOF, and a 2-shard CPU mesh), the mixed rung (through the device ladder and
    on the mesh), the three dataset generators, two incremental builds and
    a CLI solve run, with jax and the JAX package refused by an import
    hook."""
    path, _ = sphere_g2o
    out_json = str(tmp_path / "solve.json")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _ISOLATED, path, out_json],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 25
    sol = json.load(open(out_json))
    assert len(sol["nodes"]) == 300 and sol["solved_until"] == 299

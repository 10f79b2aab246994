"""PyTorch port: the kpg-solve-torch CLI against the JAX package's CLI.

`solve`, `replay` and `ablate` run in-process on the sphere_g2o fixture of
tests/test_cli_g2o.py through both CLIs with one config file (fp64, the
port's formulation, as tests/test_torch_engine.py) and --device cpu for the
port. Batch outputs (solve, ablate) agree: poses to 1e-8 of the
trajectory's scale, chi^2 to 1e-8 relative. A replay chains truncated
solves, each of whose CG stops at a relative residual of 1e-2; where the
residual crosses that line within rounding of it, the two packages stop one
iteration apart, and the streams then differ at the forcing level. The
replay is held to that level: chi^2 to 1e-3 relative, poses to 1e-3 of the
scale."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu import cli as jcli
from solve_keyframe_pose_graph_tpu_torch import cli
from solve_keyframe_pose_graph_tpu_torch.config import CapacityConfig

from test_cli_g2o import sphere_g2o  # noqa: F401
from test_torch_engine import _config
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cfg") / "config.json")
    # one capacity bucket holds the whole fixture (300 nodes, 80 loops),
    # and a fixed coarse group keeps every trigger on one JAX compile
    cfg = _config()
    cfg = dataclasses.replace(
        cfg, capacity=CapacityConfig(initial_nodes=512, initial_edges=128),
        solver=dataclasses.replace(cfg.solver, coarse_group=16))
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return path


def _poses(path):
    sol = json.load(open(path))
    T = np.array([[[float(v) for v in row.split(",")]
                   for row in n["w_T_c"].split(";")] for n in sol["nodes"]])
    return sol, T


def _run_both(args, tmp_path, name):
    out = [str(tmp_path / f"{name}_{k}.json") for k in ("jax", "port")]
    assert jcli.main(args + ["--output", out[0]]) == 0
    assert cli.main(args + ["--output", out[1], "--device", "cpu"]) == 0
    return out


def _assert_solutions_match(paths, tol=1e-8):
    (ref, T_ref), (got, T_got) = (_poses(p) for p in paths)
    assert got["solved_until"] == ref["solved_until"]
    scale = max(np.abs(T_ref).max(), 1.0)
    np.testing.assert_allclose(T_got, T_ref, rtol=0, atol=tol * scale)
    np.testing.assert_allclose(got["switches"], ref["switches"], atol=tol)
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(got["last_solve"][k],
                                   ref["last_solve"][k], rtol=tol)
    return got


def test_cli_solve_matches_reference(sphere_g2o, config_path,  # noqa: F811
                                     tmp_path):
    path, _ = sphere_g2o
    paths = _run_both(["solve", "--input", path, "--config", config_path,
                       "--max-iters", "6"], tmp_path, "solve")
    sol = _assert_solutions_match(paths)
    assert len(sol["nodes"]) == 300 and sol["solved_until"] == 299
    assert sol["solve_stats"] and sol["solve_stats"][-1] == sol["last_solve"]
    assert sol["last_solve"]["final_cost"] < sol["last_solve"]["initial_cost"]
    viz = str(tmp_path / "viz")
    assert cli.main(["solve", "--input", path, "--config", config_path,
                     "--max-iters", "2", "--device", "cpu",
                     "--output", str(tmp_path / "v.json"),
                     "--viz-dir", viz]) == 0
    dump = json.load(open(os.path.join(viz, "viz_solve.json")))
    assert dump["strips"] and dump["loop_edges"] and dump["odom_residues"]


def test_cli_replay_matches_reference(sphere_g2o, config_path,  # noqa: F811
                                      tmp_path):
    path, _ = sphere_g2o
    args = ["replay", "--input", path, "--config", config_path,
            "--trigger-every", "150", "--max-iters", "4"]
    out = [str(tmp_path / f"replay_{k}.json") for k in ("jax", "port")]
    assert jcli.main(args + ["--output", out[0],
                             "--save-dir", str(tmp_path / "ck_jax")]) == 0
    assert cli.main(args + ["--output", out[1], "--device", "cpu",
                            "--save-dir", str(tmp_path / "ck_port")]) == 0
    assert _assert_solutions_match(out, tol=1e-3)["solved_until"] == 299
    ck = [json.load(open(tmp_path / d / "solved_posegraph.json"))
          for d in ("ck_jax", "ck_port")]
    assert len(ck[1]["SolvedPoseGraph"]) == len(ck[0]["SolvedPoseGraph"])
    assert ck[1]["WorldsData"] == ck[0]["WorldsData"]


def test_cli_ablate_matches_reference(sphere_g2o, config_path,  # noqa: F811
                                      tmp_path):
    path, _ = sphere_g2o
    out = _run_both(["ablate", "--input", path, "--config", config_path,
                     "--edges", "0,1", "--max-iters", "4"], tmp_path,
                    "ablate")
    ref, got = (json.load(open(p)) for p in out)
    np.testing.assert_allclose(got["baseline_chi2"], ref["baseline_chi2"],
                               rtol=1e-8)
    assert [r["edge"] for r in got["ablation"]] == [0, 1]
    for g, r in zip(got["ablation"], ref["ablation"]):
        np.testing.assert_allclose(g["chi2"], r["chi2"], rtol=1e-8)


def test_cli_device_cuda_without_cuda_exits_nonzero(sphere_g2o,  # noqa: F811
                                                    tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path, _ = sphere_g2o
    with pytest.raises(SystemExit) as exc:
        cli.main(["solve", "--input", path,
                  "--output", str(tmp_path / "x.json")])
    assert exc.value.code not in (0, None)
    assert "no CUDA device" in str(exc.value.code)
    assert not (tmp_path / "x.json").exists()
    assert cli.main(["info", "--input", path]) == 0


@pytest.mark.parametrize("entry", ["solve", "replay", "ablate", "server"])
def test_config_residual_family_and_preconditioner_reach_the_solve(
        sphere_g2o, tmp_path, monkeypatch, entry):  # noqa: F811
    """residual.mode="4dof" and solver.preconditioner="band*coarse" in a
    config JSON reach every lm_solve of the CLI's solve, replay and ablate
    and of the server's trigger, and the incremental build (on by default)
    is taken by the replay."""
    from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
    from solve_keyframe_pose_graph_tpu_torch.ops import lm as tlm
    from solve_keyframe_pose_graph_tpu_torch.runtime_server import (
        PoseGraphServer,
    )

    path, g = sphere_g2o
    cfg = _config()
    cfg = dataclasses.replace(
        cfg, capacity=CapacityConfig(initial_nodes=512, initial_edges=128),
        solver=dataclasses.replace(cfg.solver, coarse_group=16,
                                   preconditioner="band*coarse",
                                   max_lm_iterations=1,
                                   max_cg_iterations=5),
        residual=dataclasses.replace(cfg.residual, mode="4dof"),
        stream=dataclasses.replace(cfg.stream, incremental_build=True))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    seen = []
    solve = tlm.lm_solve

    def spy(problem, **kw):
        seen.append((kw["residual_mode"], kw["preconditioner"]))
        return solve(problem, **kw)

    monkeypatch.setattr(tlm, "lm_solve", spy)
    out = str(tmp_path / "out.json")
    args = {"solve": ["solve"],
            "replay": ["replay", "--trigger-every", "200"],
            "ablate": ["ablate", "--edges", "0"]}
    if entry == "server":
        store = GraphStore()
        server = PoseGraphServer(store, cfg, device="cpu")
        for i in range(40):
            store.add_node(1000 + i, g.q[i], g.t[i])
        store.add_loop_edge_by_index(0, 39, g.q[0], g.t[0], 1.0)
        assert server.engine.trigger()
    else:
        assert cli.main(args[entry] + ["--input", path, "--config",
                                       str(cfg_path), "--output", out,
                                       "--device", "cpu"]) == 0
    assert seen and set(seen) == {("4dof", "band*coarse")}
    if entry == "replay":
        rows = json.load(open(out))["solve_stats"]
        assert len(rows) >= 2 and rows[-1]["delta_builds"] >= 1

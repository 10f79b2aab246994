"""Whole runs: on the CPU at a tiny size (the program's eager CPU path,
device="cpu", which skips the harness's look for a card), the refusal
without a card, the check for JAX, and the comparison failing under the
faults that a served solve can have and under the control."""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile
import time
import types

import pytest
import torch

from conftest import TINY_CELL, ROOT
from port_bench import run
from port_bench.harness import manifest, stream, trace

SEED = 4_000_000_007
SECONDS = "3"


def _run(root, patch=None, seconds=SECONDS, trace_flag="0"):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", TINY_CELL, "--seed", str(SEED),
                       "--seconds", seconds, "--trace", trace_flag],
                      device="cpu", root=root, patch=patch)
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1]), lines


def test_last_line(tiny_root):
    res, lines = _run(tiny_root)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    # 30 keyframes in 3 s at 10/s, their loop edges, 600 pose queries
    assert res["attempted"] > 600
    bench = manifest.load(tiny_root)
    want = {m["name"] for m in manifest.metrics(bench, TINY_CELL, False)}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert res["device"]["count"] == 1
    assert set(res["checks"]) >= {"chi2_gap", "uncorrected_edges"}
    checks = [line for line in lines if line.startswith("[check]")]
    # the session's first solve, from the VIO poses, and the window's
    assert any("first=True" in line for line in checks)
    assert any("first=False" in line for line in checks)
    # set-up's steps account for setup_s but for the lead-in and the
    # clients' start
    [setup] = [line for line in lines if line.startswith("[setup]")]
    steps = dict(kv.split("=") for kv in setup.split()[1:])
    parts = sum(float(steps[k]) for k in (
        "start_s", "generate_s", "import_s", "card_s", "store_s",
        "capture_s", "prefix_s", "warm_s", "ready_s"))
    rest = float(steps["setup_s"]) - parts - 2.05
    assert -0.05 < rest < 0.5, steps


def _engine_patch(method, wrap):
    def patch(server):
        eng = server.engine
        setattr(eng, method, wrap(getattr(eng, method), eng))
    return patch


def _unchanged(inner, eng):
    """Every solve returns the state it started from."""
    def call(problem, kw, node_len, edge_len, *a):
        res, captures = inner(problem, kw, node_len, edge_len, *a)
        n, e = node_len, edge_len
        return res._replace(
            q=problem.q[:n].double().cpu(), t=problem.t[:n].double().cpu(),
            switch=problem.switch[:e].double().cpu()), captures
    return call


def _half_the_edges(inner, eng):
    """Every other loop edge left out of each solve."""
    def call(*a, **kw):
        problem, kwargs, build = inner(*a, **kw)
        problem.loop_mask[1::2] = 0.0
        return problem, kwargs, build
    return call


def _altered(inner, eng):
    """The newest node of each answer moved by 1 m where it is produced."""
    def call(res, problem, kw, node_len, *a):
        t = res.t.clone()
        t[node_len - 1, 0] += 1.0
        return inner(res._replace(t=t), problem, kw, node_len, *a)
    return call


@pytest.mark.parametrize("fault", [
    ("_solve_to_host", _unchanged),
    ("_prepare_solve", _half_the_edges),
    ("_finish_solve", _altered),
], ids=["state_unchanged", "half_the_edges", "answer_altered"])
def test_a_fault_is_not_correct(tiny_root, fault):
    res, _ = _run(tiny_root, patch=_engine_patch(*fault))
    assert res["correct"] is False
    assert res["checks"]["chi2_gap"]["value"] > \
        res["checks"]["chi2_gap"]["limit"]


def test_the_control_is_not_correct(tiny_root):
    """The reference in TF32 put in the program's place, from the starts
    of the answers that a run judges, fails the comparison (one of its
    numbers); the program's own answers pass it."""
    from port_bench import control
    bench = manifest.load(tiny_root)
    cfg = manifest.config(bench, manifest.workload(bench, TINY_CELL)[
        "config"], tiny_root)
    rec = stream.run(TINY_CELL, SEED, float(SECONDS), False,
                     t_start=time.monotonic(), device="cpu", bench=bench,
                     root=tiny_root)
    got = control.readings(cfg, rec, tiny_root)
    assert got["program"] and len(got["tf32"]) == len(got["program"])
    lim = cfg["limits"]
    for name, fails in (("program", False), ("tf32", True)):
        over = [x["chi2_gap"] > lim["chi2_gap"] for x in got[name]
                if not x["first"]]
        over += [x["start_gap"] > lim["first_gap"] for x in got[name]
                 if x["first"]]
        assert any(over) is fails, got


@pytest.mark.parametrize("profile", [
    {"device_events": 0, "solves": [{"cg_iterations": 100}],
     "k1_counted": 100},
    {"device_events": 5000, "solves": [{"cg_iterations": 100}],
     "k1_counted": 100, "by_name": {"band_matvec_kernel<float>": [99, 1]}},
], ids=["no_device_events", "k1_launches_differ"])
def test_an_unsound_trace_gives_no_result(profile):
    with pytest.raises(SystemExit) as e:
        run._trace_sound({"profile": profile})
    assert "no result" in str(e.value.code)
    profile = dict(profile, device_events=5000,
                   by_name={"band_matvec_kernel<float>": [100, 1]})
    run._trace_sound({"profile": profile})


def test_a_deep_tmpdir_still_serves(tiny_root, tmp_path, monkeypatch):
    """A TMPDIR so deep that the socket's path passes the 107 bytes that
    AF_UNIX takes: the run still serves, by the socket's name in that
    directory, and gives back the working directory it found."""
    deep = tmp_path / ("d" * 120)
    deep.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(deep))
    assert len(os.fsencode(deep / "port_bench" / "1.sock")) > 107
    cwd = os.getcwd()
    res, _ = _run(tiny_root)
    assert res["correct"] is True and res["failed"] == 0
    assert os.getcwd() == cwd


def test_refuses_without_a_card(tiny_root, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", TINY_CELL, "--seed", "1", "--seconds", "1",
                  "--trace", "0"], device="cuda", root=tiny_root)
    assert e.value.code not in (0, None)
    assert "{" not in capsys.readouterr().out


def test_refuses_where_only_the_benchmark_is(tmp_path):
    """A directory with only BENCHMARK.json and port_bench: the program is
    not there to import."""
    import shutil
    import subprocess
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(f"{ROOT}/port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    cell = bench["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        cell, "--seed", "7", "--seconds", "1", "--trace",
                        "0"], cwd=tmp_path, capture_output=True, text=True,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                            "TMPDIR": str(tmp_path)}, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip().endswith("}")


def _recording_popen(monkeypatch) -> list:
    started = []
    popen = stream.subprocess.Popen

    def record(*a, **kw):
        started.append(popen(*a, **kw))
        return started[-1]
    monkeypatch.setattr(stream.subprocess, "Popen", record)
    return started


def _program_fails(monkeypatch):
    """The program's server module cannot be imported."""
    monkeypatch.setitem(sys.modules,
                        "solve_keyframe_pose_graph_tpu_torch.runtime_server",
                        None)


def _serve_fails(monkeypatch):
    """The run fails once the server is made, before it serves."""
    def patch(server):
        raise RuntimeError("a failure in a test")
    return patch


@pytest.mark.parametrize("fail", [_program_fails, _serve_fails],
                         ids=["program_import", "before_serving"])
def test_no_child_outlives_a_failed_run(tiny_root, monkeypatch, fail):
    started = _recording_popen(monkeypatch)
    patch = fail(monkeypatch)
    with pytest.raises((ImportError, RuntimeError)):
        stream.run(TINY_CELL, SEED, 1.0, False, t_start=time.monotonic(),
                   device="cpu", root=tiny_root, patch=patch)
    assert started, "the run started no clients"
    assert all(p.poll() is not None for p in started)


def test_no_child_without_the_program(tiny_root, monkeypatch):
    """Where the program is not there to import, the run exits with no
    result before it starts a child process."""
    started = _recording_popen(monkeypatch)
    monkeypatch.setitem(sys.modules, "solve_keyframe_pose_graph_tpu_torch",
                        None)
    with pytest.raises(SystemExit) as e:
        stream.run(TINY_CELL, SEED, 1.0, False, t_start=time.monotonic(),
                   device="cpu", root=tiny_root)
    assert "no result" in str(e.value.code)
    assert started == []


def test_the_reference_is_loaded_before_the_run(tiny_root, monkeypatch):
    """The configuration's reference module, and with it its imports, is
    in place before the run starts: the program's host rung imports the
    same modules on its first escalation, inside set-up."""
    order = []
    load = run.check.reference

    def reference(cfg, root):
        order.append("reference")
        return load(cfg, root)

    def serve(*a, **kw):
        order.append("run")
        raise RuntimeError("stop")

    monkeypatch.setattr(run.check, "reference", reference)
    monkeypatch.setattr(run.stream, "run", serve)
    with pytest.raises(RuntimeError, match="stop"):
        run.main(["--workload", TINY_CELL, "--seed", str(SEED), "--seconds",
                  "1", "--trace", "0"], device="cpu", root=tiny_root)
    assert order == ["reference", "run"]


def test_jax_names_compare_whole():
    mods = {"solve_keyframe_pose_graph_tpu_torch": None,
            "solve_keyframe_pose_graph_tpu_torch.ops.lm": None,
            "jaxtyping": None, "numpy": None}
    assert trace.loaded_jax(mods) == []
    mods.update({"solve_keyframe_pose_graph_tpu.ops": None, "jax": None,
                 "jaxlib.xla_client": None, "flax": None})
    assert trace.loaded_jax(mods) == ["flax", "jax", "jaxlib.xla_client",
                                      "solve_keyframe_pose_graph_tpu.ops"]


def test_jax_loaded_stops_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "solve_keyframe_pose_graph_tpu",
                        types.ModuleType("solve_keyframe_pose_graph_tpu"))
    with pytest.raises(SystemExit) as e:
        trace.check_no_jax("in a test")
    assert "solve_keyframe_pose_graph_tpu" in str(e.value.code)


@pytest.mark.card
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    bench = manifest.load()
    cell = bench["workloads"][0]["name"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "5",
                  "--trace", "0"])
    assert json.loads(out.getvalue().strip().splitlines()[-1])["correct"]

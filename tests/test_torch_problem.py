"""PyTorch port: Problem construction against the JAX package, and the
port's import hygiene (it must never import jax)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu.graph import synthetic
from solve_keyframe_pose_graph_tpu.solver import problem as jprob
from solve_keyframe_pose_graph_tpu_torch.solver import problem as tprob

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
    port = tprob.build_problem_np(dtype=dtype, **kw)
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
        tprob.build_problem_np(**kw)


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
    port = tprob.build_problem_np(dtype=np.float64, **kw)
    got = tprob.repack_problem(port, n_len, e_len, granularity=gran)
    for name in tprob.FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert (got is port) == ((got.n_cap, got.e_cap) == (256, 64))


def test_port_imports_no_jax():
    """Every module of the port loads with jax absent from sys.modules."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import solve_keyframe_pose_graph_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 14, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

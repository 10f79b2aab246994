"""PyTorch port: bench_torch.py, the port's counterpart of bench.py, on the
CPU.

The bench itself runs only on a CUDA card. Here: its problem builder
against the JAX package's build_problem_np; its solver configuration
against bench.py's through the JAX package, in fp64; its summary
statistics and chi^2 gate; and its refusal to run without a card.

The JAX side of the configuration parity runs loop_impl="scatter",
band_impl="aos", the formulation the port's LM parity tests hold it to
(tests/test_torch_lm.py), in place of bench.py's "tiledrows6" loop matvec
and its tile_k, which the port does not have. The graph is
circle_graph(512, 256, seed=3) with 20% outlier loop edges at n_cap 1024,
e_cap 512. It is well determined for this comparison: in fp64 the port
accepts all ten LM steps with 397 CG iterations, and scaling the initial
translations by 1 + 1e-11 (far more than the last-bit differences between
the two packages' sums) changes neither count and moves chi^2 (0.0122733)
by 3e-14 relative, so no CG stop and no accept / reject decision sits at
its threshold."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import bench_torch
import chip_smoke
from solve_keyframe_pose_graph_tpu.graph import synthetic as jsynthetic
from solve_keyframe_pose_graph_tpu.ops import lm as jlm
from solve_keyframe_pose_graph_tpu.solver import problem as jprob
from solve_keyframe_pose_graph_tpu_torch.ops import lm as tlm
from solve_keyframe_pose_graph_tpu_torch.solver.problem import FIELDS

from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, LOOPS, SEED, N_CAP, E_CAP = 512, 256, 3, 1024, 512
# bench.py:111-115, its loop matvec replaced as the module note says
BENCH_PY_KW = dict(max_iterations=10, preconditioner="band+coarse",
                   bcr_levels=2, max_cg_iterations=45,
                   loop_impl="scatter", band_impl="aos")


@pytest.fixture(scope="module")
def problems():
    g = jsynthetic.circle_graph(n_nodes=N, n_loops=LOOPS, seed=SEED)
    ref = jprob.build_problem_np(
        q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t,
        node_valid=np.ones(N, bool), loop_pairs=g.loop_pairs,
        loop_q=g.loop_q, loop_t=g.loop_t, loop_w=g.loop_w,
        loop_valid=np.ones(LOOPS, bool), switch=np.full(LOOPS, 0.99),
        prior_idx=np.array([0]), prior_q=g.vio_q[:1], prior_t=g.vio_t[:1],
        prior_w=np.array([1.1]), n_cap=N_CAP, e_cap=E_CAP, p_cap=8,
        dtype=np.float64)
    # what bench_torch.build calls, at these capacities
    port = chip_smoke.circle_problem(N, LOOPS, N_CAP, E_CAP, np.float64,
                                     "cpu", seed=SEED)
    return ref, port


def test_bench_problem_matches_reference(problems):
    ref, port = problems
    assert (port.n_cap, port.e_cap, port.p_cap) == (N_CAP, E_CAP, 8)
    for name in FIELDS:
        got, want = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_bench_config_matches_bench_py(problems):
    ref_prob, port = problems
    ref = jlm.lm_solve(ref_prob, **BENCH_PY_KW)
    got = tlm.lm_solve(port, **chip_smoke.PRODUCT)
    assert {k: v for k, v in BENCH_PY_KW.items()
            if k not in ("loop_impl", "band_impl")} == chip_smoke.PRODUCT
    for name in ("iterations", "successful_steps", "total_cg_iterations"):
        assert int(getattr(got, name)) == int(getattr(ref, name)), name
    assert int(got.iterations) == int(got.successful_steps) == 10
    np.testing.assert_allclose(float(got.final_cost), float(ref.final_cost),
                               rtol=1e-6)
    assert float(got.final_cost) < 0.05 * float(got.initial_cost)


def test_summary_and_chi2_gate():
    s = bench_torch.summary([5.0, 1.0, 4.0, 2.0, 3.0, 10.0])
    assert s == dict(median=3.5, p25=2.25, p75=4.75, min=1.0, max=10.0)
    assert bench_torch.summary([7.0]) == dict(median=7.0, p25=7.0, p75=7.0,
                                              min=7.0, max=7.0)

    bar = bench_torch.chi2_bar(0, 5000, 10000)
    assert bar == pytest.approx(1.02 * 0.4038) and round(bar, 5) == 0.41188
    assert bench_torch.chi2_passes(0.41, bar)
    assert not bench_torch.chi2_passes(0.412, bar)
    assert not bench_torch.chi2_passes(math.nan, bar)
    assert not bench_torch.chi2_passes(math.inf, bar)
    assert bench_torch.chi2_bar(0, 30000, 30000) == pytest.approx(
        1.02 * 5.9532)
    # another seed: its reference is reported, and nothing is gated on it
    assert bench_torch.chi2_ref(1, 5000, 10000) == 38.81
    assert bench_torch.chi2_bar(1, 5000, 10000) is None
    assert bench_torch.chi2_passes(60.0, None)
    assert not bench_torch.chi2_passes(math.nan, None)
    assert bench_torch.chi2_ref(8, 5000, 10000) is None
    assert bench_torch.chi2_ref(1, 30000, 30000) is None

    assert bench_torch.metric_name(5000, 10000) == "lm_solve_5k10k_ms"
    assert bench_torch.metric_name(30000, 30000) == "lm_solve_30k30k_ms"
    assert [bench_torch.next_pow2(n) for n in (5000, 10000, 30000, 8192)] \
        == [8192, 16384, 32768, 8192]


@pytest.mark.parametrize("argv,says", [
    (["--reps", "1"], "torch.cuda.is_available() is false"),
    (["--device", "cpu", "--reps", "1"], "runs on a CUDA device only"),
])
def test_bench_refuses_to_run_without_a_card(argv, says):
    """No card here: the bench exits non-zero before any solve and prints
    no result line (there is no CPU path)."""
    out = subprocess.run([sys.executable, "bench_torch.py", *argv],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert says in out.stderr, out.stderr[-2000:]
    for line in out.stdout.splitlines():
        try:
            assert "metric" not in json.loads(line), line
        except json.JSONDecodeError:
            pass
    assert "[setup]" not in out.stdout

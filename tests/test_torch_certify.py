"""PyTorch port: certify.py holds the port to BASELINE.md's fp64 exact-step
references, which are for the benchmark harness's problem. The port must
build that problem exactly as the harness does
(benchmarks/run_baseline.py:problem_from_inputs, and the coarse group of
benchmarks/exp_warm_robust.py), here on the sphere_g2o fixture."""

import os

import numpy as np

from solve_keyframe_pose_graph_tpu.graph import g2o as g2o_io
from solve_keyframe_pose_graph_tpu.ops import coarse as jcoarse
from solve_keyframe_pose_graph_tpu_torch import certify
from solve_keyframe_pose_graph_tpu_torch.solver import problem as tprob

from benchmarks.run_baseline import problem_from_inputs
from test_cli_g2o import sphere_g2o  # noqa: F401


def test_harness_problem_matches_reference(sphere_g2o):  # noqa: F811
    path, _ = sphere_g2o
    inp = g2o_io.g2o_to_problem_inputs(g2o_io.load_g2o(path))
    ref = problem_from_inputs(inp, len(inp["vio_q"]), len(inp["loop_pairs"]))
    pairs = np.asarray(inp["loop_pairs"])
    ref_group = jcoarse.auto_coarse_group(
        ref.q.shape[0], jcoarse.median_loop_offset(pairs[:, 1], pairs[:, 0]))

    port, group = certify.harness_problem(path, "cpu")
    assert group == ref_group
    assert (port.n_cap, port.e_cap, port.p_cap) == (512, 256, 8)
    for name in tprob.FIELDS:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_every_instance_has_a_graph_and_a_reference():
    assert certify.JAX_CLI.keys() == certify.HARNESS_REF.keys()
    for name, ref in certify.HARNESS_REF.items():
        assert ref > 0 and certify.JAX_CLI[name] > 0
        assert os.path.getsize(f"{certify.GRAPHS}/{name}.g2o") > 0, name

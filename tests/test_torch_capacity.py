"""PyTorch port: the capacity stream of chip_smoke.py phase 16 at test size.

chip_smoke.distress_stream feeds a circle graph node by node to an engine,
polls trigger() every `every` nodes and forces the escalation ladder on one
trigger; on the card, 30,000 nodes from the first node bucket of 1024, the
forced escalation lands in the 32768 bucket. Here 600 nodes and 60 loop
edges from a first node bucket of 64: the bucket doubles four times (to
1024), three before the first trigger and once between the forced trigger
and the settle trigger.

The solves are fp32 at the product defaults. Organic escalations are
switched off (escalate_rejects very large): whether an fp32 solve shows
the distress signature can differ between two fp32 implementations, while
the forced one (escalate_rejects=0) is certain in both. With the
escalation inline both engines run the same stream; with it in the
background the port's alone, asserting only what no thread timing
decides."""

import math

import numpy as np

import chip_smoke
from solve_keyframe_pose_graph_tpu import config as jconfig
from solve_keyframe_pose_graph_tpu.graph.store import GraphStore as JaxStore
from solve_keyframe_pose_graph_tpu.solver.engine import (
    SolverEngine as JaxEngine,
)
from solve_keyframe_pose_graph_tpu_torch import config as tconfig
from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.solver.engine import (
    SolverEngine, _bucket,
)

from test_torch_threads import one_torch_thread  # noqa: F401

N, LOOPS, EVERY, INJECT = 600, 60, 150, 400


def _config(background: bool, c=tconfig):
    """fp32 at the product defaults, escalation only where forced; the JAX
    engine set to the port's formulation (scatter loop matvec, AoS band
    build). One edge bucket, so that the node buckets alone set the
    shapes (each new shape is a compile on the JAX side)."""
    return c.Config(
        solver=c.SolverConfig(dtype="float32", adaptive_fp64=True,
                              escalate_rejects=10 ** 6, loop_impl="scatter",
                              band_impl="aos"),
        stream=c.StreamConfig(background_escalation=background),
        capacity=c.CapacityConfig(initial_nodes=64, initial_edges=64),
        io=c.IOConfig(compile_cache_dir=""))


def _settle(eng) -> bool:
    """The end of chip_smoke.py phase 16's stream: drain(), one settle
    trigger() for the edges of the nodes after the last poll, drain()."""
    eng.drain()
    fired = eng.trigger()
    eng.drain()
    return fired


def test_inline_escalation_at_bucket_growth_matches_reference():
    """The loop edges start at the second revolution (node 300): the polls
    at nodes 300 and 450 fire in the 512 bucket, the second forced up the
    ladder inline (the host fp64 rung), and the settle trigger solves all
    600 nodes in the 1024 bucket after a full build. The forced trigger's
    poses are the exact-step fp64 ones in both engines; the settle trigger is
    an fp32 solve again, whose chi^2 and poses agree to 1e-4 (two fp32 CG
    loops at the synthetic defaults land 1e-5 to 1e-4 apart, PERF.md
    section 7)."""
    port = SolverEngine(GraphStore(), _config(False), device="cpu")
    ref = JaxEngine(JaxStore(), _config(False, jconfig))
    g = synthetic.circle_graph(n_nodes=N, n_loops=LOOPS, seed=1)
    recs = [chip_smoke.distress_stream(e, e.store, g, EVERY, INJECT)
            for e in (ref, port)]
    assert recs[1] == recs[0]
    assert [p["node"] for p in recs[1]["polls"] if p["fired"]] == [300, 450]
    assert recs[1]["injected"] == port.trigger_id == 2
    # the forced trigger was the last poll: the poses are its rung's. The
    # rung starts from each package's fp32 poses of the first trigger,
    # which differ by rounding, so its results differ along directions
    # in which the cost is flat (its chi^2 agrees to 1e-9, below): 2e-7
    # of the scale here, against 1e-8 when both start from the same poses
    # (_assert_escalated_poses_match)
    n = port.prev_node_len
    t_ref = ref._opt_t[:n]
    np.testing.assert_allclose(port._opt_t[:n], t_ref, rtol=0,
                               atol=1e-6 * np.abs(t_ref).max())
    np.testing.assert_allclose(port._opt_q[:n], ref._opt_q[:n], rtol=0,
                               atol=1e-6)
    assert _settle(ref) and _settle(port)

    rows = [[r for r in e.solve_stats if "trigger_wall_ms" in r]
            for e in (ref, port)]
    sizes = [[(r["trigger"], r["node_len"], r["edge_len"],
               r["fp64_escalated"]) for r in x] for x in rows]
    assert sizes[1] == sizes[0] == [(1, 301, 2, False), (2, 451, 36,
                                                         "fp64-cpu"),
                                    (3, N, LOOPS, False)]
    forced = rows[1][1]
    np.testing.assert_allclose(forced["final_cost"], rows[0][1]["final_cost"],
                               rtol=1e-9)
    assert forced["rung_stats"]["n_cap"] == 451          # live-length repack
    assert not [r for r in port.solve_stats if r.get("background_escalation")]
    # 64 -> 512 before the first trigger, 512 -> 1024 before the settle
    # one: each a full build of the problem
    assert [_bucket(r["node_len"], 64) for r in rows[1]] \
        == [512, 512, 1024]
    assert rows[1][-1]["full_builds"] == rows[1][-2]["full_builds"] + 1
    np.testing.assert_allclose(rows[1][-1]["final_cost"],
                               rows[0][-1]["final_cost"], rtol=1e-4)
    t_ref = ref._opt_t[:N]
    np.testing.assert_allclose(port._opt_t[:N], t_ref, rtol=0,
                               atol=1e-4 * np.abs(t_ref).max())
    np.testing.assert_allclose(port._opt_q[:N], ref._opt_q[:N], rtol=0,
                               atol=1e-4)


def test_background_escalation_at_bucket_growth_lands():
    """The same stream with the escalation in the background, the port
    alone: the forced trigger serves its fp32 result ("pending"), its
    escalation lands on the host rung by drain(), applied (no world merge
    in this stream), and the settle trigger solves the whole graph."""
    eng = SolverEngine(GraphStore(), _config(True), device="cpu")
    rec = chip_smoke.distress_stream(
        eng, eng.store, synthetic.circle_graph(n_nodes=N, n_loops=LOOPS,
                                               seed=1), EVERY, INJECT)
    tid = rec["injected"]
    assert tid == 2
    row = [r for r in eng.solve_stats if r["trigger"] == tid
           and "trigger_wall_ms" in r]
    assert row[0]["fp64_escalated"] == "pending"
    assert _settle(eng)
    esc = [r for r in eng.solve_stats if r.get("background_escalation")]
    assert len(esc) == 1 and esc[0]["trigger"] == tid
    assert "escalation_error" not in esc[0], esc[0]
    assert esc[0]["escalated_rung"] == "fp64-cpu" and esc[0]["applied"]
    settle = eng.solve_stats[-1]
    assert settle["node_len"] == N and "trigger_wall_ms" in settle
    assert math.isfinite(settle["final_cost"])
    assert np.isfinite(eng._opt_q[:N]).all()
    assert np.isfinite(eng._opt_t[:N]).all()

"""PyTorch port: the mesh's solve through the composed executables
(ops/graphs.py over a parallel.ShardedProblem), on CPU shards.

A mesh whose shards share one device is solved as a Problem is: its LM
iteration's pieces captured once per key, the LM and CG loops run by the
executables. Here the pieces run through the test doubles of the capture
and of the executables (EagerGraph and HostLoops, tests/
test_torch_graphs.py: host while loops on the WHILE nodes' conditions),
on meshes of CPU shards:
  (a) no piece of ShardedOps issues an operation that breaks a capture;
  (b) two graphs of one bucket whose shards hold different numbers of
      ghosts share one key and one Program (the padded layout), each bit
      for bit its eager sharded solve;
  (c) both forms on 4 shards are bit for bit the eager sharded solve, with
      the launches, host reads and piece runs of one device's;
  (d) the 8-shard fp64 graphed solve meets dryrun_multichip's certificate
      bars against the JAX package's GSPMD lm_solve;
  (e) the padded layout: its pad slots, its round trip, and owner sums
      (before and after a refresh) equal to a dense sum;
  (f) a failed coarse factorization raises after the loop, through the
      loop state's fault flag;
  (g) a mesh engine's warmup captures the mesh's bucket ladder, its
      triggers capture nothing, and its poses are the eager mesh
      engine's.
The executables themselves run on the card: chip_smoke.py phase 14.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from solve_keyframe_pose_graph_tpu.ops import lm as jlm
from solve_keyframe_pose_graph_tpu.parallel import (
    make_mesh as jax_mesh, shard_problem as jax_shard,
)
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.ops import graphs
from solve_keyframe_pose_graph_tpu_torch.ops import lm as tlm
from solve_keyframe_pose_graph_tpu_torch.parallel import (
    gather_problem, make_mesh, shard_problem,
)
from solve_keyframe_pose_graph_tpu_torch.parallel.collectives import OwnerSum
from solve_keyframe_pose_graph_tpu_torch.parallel.sharding import (
    ghost_capacity,
)
from solve_keyframe_pose_graph_tpu_torch.solver import engine as tengine
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    FIELDS, problem_from_arrays,
)

from test_torch_graphs import (  # noqa: F401
    FORBIDDEN, PRODUCT, _graph, _Ops, graphed_cpu,
)
from test_torch_sharded_lm import (
    _config, _stream, assert_certificate, cpu_mesh,
)
from test_torch_sharding import circle_problem
from test_torch_threads import one_torch_thread  # noqa: F401

CONFIGS = {
    "product": {},
    "mixed": dict(precision="mixed"),
    "band*coarse": dict(preconditioner="band*coarse"),
    "4dof": dict(residual_mode="4dof"),
}


def n_ghosts(sp) -> list:
    """The real ghosts of each shard (its pad slots hold ids of its own
    block)."""
    nl = sp.layout.nl
    return [int((g // nl != i).sum()) for i, g in enumerate(sp.layout.ghosts)]


def _solve(prob, form: str, **kw):
    """lm_solve in the form taken without a dispatch lock ("solve") or
    with one ("step")."""
    if form == "step":
        kw["dispatch_lock"] = threading.Lock()
    return tlm.lm_solve(prob, **kw)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_sharded_pieces_are_capturable(config):
    """(a) The static copy's refresh, init, pre, two CG iterations and
    post over 4 shards issue none of FORBIDDEN."""
    sp = shard_problem(_graph(), cpu_mesh(4)).static_copy()
    setup = graphs.setup_of(sp, **dict(PRODUCT, **CONFIGS[config]))
    with _Ops() as ops:
        pieces = tlm._lm_pieces(sp, **setup)
        sp.refresh()
        state = pieces.init()
        ctx, cg = pieces.pre(state)
        for _ in range(2):
            cg = pieces.cg_iter(ctx, cg)
        state = pieces.post(state, ctx, cg)
    assert not ops.seen & set(FORBIDDEN), ops.seen & set(FORBIDDEN)
    assert int(state.k) == 1 and int(state.cg_total) == int(cg.k) <= 2


def test_one_program_serves_two_ghost_counts(graphed_cpu):  # noqa: F811
    """(b) Two graphs of one bucket whose shards hold different numbers of
    ghosts have one key and replay one Program, each bit for bit its
    eager sharded solve."""
    mesh = cpu_mesh(4)
    a = shard_problem(_graph(seed=0), mesh)
    b = shard_problem(_graph(n=280, loops=50, seed=1, drop=5), mesh)
    assert n_ghosts(a) != n_ghosts(b)
    assert graphs.serves(a) and graphs.serves(b)
    kw = dict(PRODUCT, max_iterations=4)
    setup = graphs.setup_of(a, **kw)
    assert graphs.key(a, setup) == graphs.key(b, graphs.setup_of(b, **kw))
    built = len(graphs.LOG)
    got = [tlm.lm_solve(p, **kw) for p in (a, b)]
    assert len(graphs.LOG) == built + 1 and len(graphs._programs) == 1
    assert graphs.LOG[-1]["shards"] == 4
    for res, p in zip(got, (a, b)):
        want = tlm._lm_solve_eager(p, **kw)
        assert all(torch.equal(x, y) for x, y in zip(res, want))


@pytest.mark.parametrize("form", ["solve", "step"])
def test_mesh_forms_match_the_eager_sharded_solve(graphed_cpu,  # noqa: F811
                                                  form):
    """(c) Both forms on 4 shards give the eager sharded solve's LMResult
    bit for bit (LM and CG counts included); the solve form is one launch
    and one host read, the step form an init and a step per LM iteration;
    the pieces' run counts pass the solve's LoopError check."""
    sp = shard_problem(_graph(), cpu_mesh(4))
    want = tlm._lm_solve_eager(sp, **PRODUCT)
    _solve(sp, form, **PRODUCT)                      # builds the Program
    launches, reads = dict(graphs.LAUNCHES), dict(graphs.HOST_READS)
    got = _solve(sp, form, **PRODUCT)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    it = int(got.iterations)
    assert it == 10 and 0 < int(got.total_cg_iterations) < 450
    ran = {n: graphs.LAUNCHES[n] - launches[n] for n in launches}
    read = {n: graphs.HOST_READS[n] - reads[n] for n in reads}
    if form == "solve":
        assert ran == {"init": 0, "step": 0, "solve": 1}
        assert read == {"solve": 1, "step": 0}
    else:
        assert ran == {"init": 1, "step": it, "solve": 0}
        assert read == {"solve": 0, "step": it + 2}
    (prog,) = graphs._programs.values()
    assert prog.runs.tolist() == [1, it, int(got.total_cg_iterations), it]


@pytest.mark.parametrize("form", ["solve", "step"])
def test_graphed_mesh_matches_the_jax_gspmd_solve(graphed_cpu,  # noqa: F811
                                                  form):
    """(d) The graphed 8-shard fp64 solve against the JAX package's
    lm_solve on its 8-device CPU mesh, at dryrun_multichip's bars, on
    test_torch_sharded_lm.py's inputs."""
    jp = ge._make_problem(n_nodes=128, n_loops=16, n_cap=128, e_cap=16,
                          dtype=np.float64)
    kw = dict(max_iterations=3, max_cg_iterations=10,
              preconditioner="band+coarse", coarse_group=16)
    want = jlm.lm_solve(jax_shard(jp, jax_mesh(8)), **kw)
    tp = problem_from_arrays({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                             "cpu")
    built = len(graphs.LOG)
    got = _solve(shard_problem(tp, cpu_mesh(8)), form, **kw)
    assert len(graphs.LOG) == built + 1
    assert_certificate(got, want)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_padded_layout_round_trip_and_owner_sums(P):
    """(e) Each shard's ghost block is g_cap long whatever the graph, its
    pad slots inert (identity poses, frozen, odometry masked, ids in the
    shard's own block); gather_problem returns the Problem bit for bit;
    the owner sums, with nonzero rows on the pad slots, equal a dense sum
    in rank order, and still do after another graph's ghosts are copied
    into the static copy and refreshed."""
    prob = circle_problem()
    sp = shard_problem(prob, make_mesh(P, device_type="cpu"))
    L, F = sp.layout, sp.fanout
    g_cap = ghost_capacity(prob.n_cap, prob.e_cap, F, P)
    assert g_cap == min(2 * L.el, prob.n_cap - L.nl)
    for i, (sub, n_g) in enumerate(zip(sp.subs, n_ghosts(sp))):
        assert sub.n_cap == F + L.nl + g_cap and n_g < g_cap
        pad = slice(F + L.nl + n_g, None)
        assert torch.equal(L.ghosts[i][n_g:], torch.full((g_cap - n_g,),
                                                         i * L.nl))
        assert torch.equal(sub.q[pad], torch.tensor([[0.0, 0, 0, 1]]).expand(
            g_cap - n_g, 4).to(sub.dtype))
        assert not sub.t[pad].any() and not sub.free_mask[pad].any()
        assert not sub.odo_mask[:, pad].any()
        live = sub.loop_mask > 0.5
        assert (sub.loop_b[live] < F + L.nl + n_g).all()
        assert (sub.loop_a[live] < F + L.nl + n_g).all()
    back = gather_problem(sp)
    for name in FIELDS:
        assert torch.equal(getattr(back, name), getattr(prob, name)), name

    def dense(layout, rows):
        want = torch.zeros(P * layout.nl, 3, dtype=torch.float64)
        for i, (g, r) in enumerate(zip(layout.ghosts, rows)):
            for k, u in enumerate(g.tolist()):
                if u // layout.nl != i:
                    want[u] += r[k]
        return want

    rng = np.random.default_rng(P)
    rows = [torch.tensor(rng.normal(size=(g_cap, 3))) for _ in range(P)]
    assert torch.equal(torch.cat(L.owner_sum(rows)), dense(L, rows))
    # the static copy's owner sums follow the ghosts copied into it
    other = shard_problem(circle_problem(n=230, n_loops=55), sp.mesh)
    assert n_ghosts(other) != n_ghosts(sp)
    static = sp.static_copy()
    for d, s in zip(static.leaves(), other.leaves()):
        d.copy_(s)
    static.refresh()
    assert torch.equal(torch.cat(static.layout.owner_sum(rows)),
                       dense(other.layout, rows))
    fresh = OwnerSum(other.layout.ghosts, L.nl, sp.mesh.devices)
    assert torch.equal(torch.cat(fresh(rows)), dense(other.layout, rows))
    topo = static.topology("cpu")
    for name in FIELDS:
        assert torch.equal(getattr(topo, name), getattr(gather_problem(
            other), name)), name


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_failed_coarse_factorization_raises_after_the_loop(monkeypatch,
                                                           graphed):
    """(f) On a mesh the coarse Cholesky's info travels in the loop
    state's fault flag, and the solve raises after its loop, eager or
    graphed (the Program stays cached, and free)."""
    from test_torch_graphs import graph_on_cpu
    real = torch.linalg.cholesky_ex

    def failing(H):
        L, info = real(H)
        return L, torch.ones_like(info)

    faults = []
    check = tlm.check_fault
    monkeypatch.setattr(torch.linalg, "cholesky_ex", failing)
    monkeypatch.setattr(tlm, "check_fault",
                        lambda fault: faults.append(bool(fault)) or
                        check(fault))
    if graphed:
        graph_on_cpu(monkeypatch)
    graphs.clear()
    sp = shard_problem(_graph(n=100, loops=10, n_cap=128, e_cap=32),
                       cpu_mesh(4))
    with pytest.raises(torch.linalg.LinAlgError, match="Cholesky"):
        tlm.lm_solve(sp, **dict(PRODUCT, max_iterations=2))
    assert faults == [True]
    if graphed:
        (prog,) = graphs._programs.values()
        assert not prog.busy.locked()
    graphs.clear()


def test_mesh_engine_warmup_and_replay(graphed_cpu):  # noqa: F811
    """(g) A 4-shard engine graphed: warmup captures the mesh's Programs of
    its bucket ladder, the stream's triggers capture none, and the poses
    are the eager mesh engine's bit for bit. The config pins the coarse
    group: warmup warms the size rule's group (auto_coarse_group(n_cap),
    as the JAX package's _warm_one does), and this stream's short loops
    would make the trigger's structure rule halve it to 32, a key that no
    warmup captures, on one device as on a mesh."""
    cfg = _config(4)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, coarse_group=64))
    runs = {}
    for graphed in (False, True):
        store = GraphStore()
        eng = tengine.SolverEngine(store, cfg, device="cpu")
        assert eng.mesh is not None and eng._graphed()
        if graphed:
            built = len(graphs.LOG)
            pairs = tengine._warmup_pairs(eng.config.capacity, 160, 120,
                                          proportional=False)
            assert eng.warmup(160, 120, proportional=False) == len(pairs)
            assert len(graphs.LOG) - built == len(pairs)
            assert all(r["shards"] == 4 for r in graphs.LOG[built:])
            assert all(r["captured"] for r in eng.warmup_stats)
            _stream(store, eng)
        else:
            with tlm._eager_solves():
                _stream(store, eng)
        rows = [r for r in eng.solve_stats if "trigger_wall_ms" in r]
        poses = np.array([np.concatenate(eng.get_node_pose(i))
                          for i in range(eng.n_opt_variables())])
        runs[graphed] = rows, poses
    (rows_e, poses_e), (rows, poses) = runs[False], runs[True]
    assert len(rows) == len(rows_e) >= 3
    assert [r["trigger_captures"] for r in rows] == [0] * len(rows)
    for a, b in zip(rows, rows_e):
        for key in ("node_len", "edge_len", "lm_iterations",
                    "cg_iterations", "final_cost"):
            assert a[key] == b[key], key
    assert np.array_equal(poses, poses_e)

"""PyTorch port: the solve's device-resident loops (ops/graph_loops.py,
csrc/graph_loops.cu), on the CPU.

The WHILE nodes run only on the card (chip_smoke.py phase 18 holds the
composed executables against the eager solve bit for bit). Here a
Program's pieces (init, pre, cg_iter, post) run through the test doubles
of the capture and of the executables (EagerGraph and HostLoops,
tests/test_torch_graphs.py), host while loops on the same conditions that
the WHILE nodes test:
  * in both forms (one launch of solve; init and a step per LM iteration
    under a dispatch lock) the result equals the eager lm_solve's bit for
    bit, with one host read for the solve form;
  * at fp64 the solve form matches the JAX package's whole-program
    lm_solve and the step form its lm_solve_chunked (counts equal, chi^2
    to 1e-6, as tests/test_torch_graphs.py holds them);
  * CG that ends after the iteration that set `done` equals the masked
    loop bit for bit, and takes the JAX package's pcg_nodes' count (x to
    1e-9, as tests/test_torch_band_coarse_pcg.py holds it);
  * no piece issues an operation that breaks a capture;
  * the pieces count their own runs: the launches counted per solve from
    the pieces' tallies and those runs are those that the pieces launch,
    and a piece run more often than the result's LM and CG counts say
    fails the solve, though its masks leave the result as it was.
"""

import threading

import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu.ops import band as jband
from solve_keyframe_pose_graph_tpu.ops import gn as jgn
from solve_keyframe_pose_graph_tpu.ops import lm as jlm
from solve_keyframe_pose_graph_tpu.ops import pcg as jpcg
from solve_keyframe_pose_graph_tpu.solver.problem import (
    build_problem_np as jax_build,
)
from solve_keyframe_pose_graph_tpu_torch.ops import (
    _kernels, band_matvec, graph_loops, graphs, smallinv,
)
from solve_keyframe_pose_graph_tpu_torch.ops import band as tband
from solve_keyframe_pose_graph_tpu_torch.ops import gn as tgn
from solve_keyframe_pose_graph_tpu_torch.ops import lm as tlm
from solve_keyframe_pose_graph_tpu_torch.ops import pcg as tpcg
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    FIELDS, problem_from_arrays,
)

from test_torch_band_coarse_pcg import _band_systems, reduced  # noqa: F401
from test_torch_graphs import (
    FORBIDDEN, PRODUCT, EagerGraph, HostLoops, _graph, _Ops, graph_on_cpu,
    holds,
)
from test_torch_residuals_gn import close
from test_torch_threads import one_torch_thread  # noqa: F401

CONFIGS = {
    "band+coarse": {},
    "band*coarse": dict(preconditioner="band*coarse"),
    "4dof": dict(residual_mode="4dof"),
    "mixed": dict(precision="mixed"),
}


@pytest.fixture
def graphed_cpu(monkeypatch):
    """lm_solve takes the Programs on the CPU, EagerGraph as the capture
    and HostLoops as the executables; an empty cache before and after."""
    graph_on_cpu(monkeypatch)
    graphs.clear()
    yield
    graphs.clear()


def _solve(prob, form: str, **kw):
    """lm_solve in the form taken without a dispatch lock ("solve") or
    with one ("step")."""
    if form == "step":
        kw["dispatch_lock"] = threading.Lock()
    return tlm.lm_solve(prob, **kw)


@pytest.mark.parametrize("form", ["solve", "step"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_host_loops_match_the_eager_solve(graphed_cpu, config, form):
    """Both forms of a Program's launches give the eager solve's LMResult
    bit for bit; the solve form is one launch and one host read, the step
    form an init and a step per LM iteration, each read back."""
    prob = _graph()
    kw = dict(PRODUCT, **CONFIGS[config])
    want = tlm._lm_solve_eager(prob, **kw)
    _solve(prob, form, **kw)                        # builds the Program
    launches, reads = dict(graphs.LAUNCHES), dict(graphs.HOST_READS)
    got = _solve(prob, form, **kw)
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


@pytest.mark.parametrize("form", ["solve", "step"])
def test_host_loops_match_the_reference(graphed_cpu, form):
    """At fp64 the solve form follows the JAX package's lm_solve (one
    program, its loops while_loops) and the step form its
    lm_solve_chunked(chunk_iters=1): equal counts, chi^2 to 1e-6."""
    jp = _graph(n=200, loops=40, n_cap=256, e_cap=64, dtype=np.float64,
                builder=jax_build)
    tp = problem_from_arrays({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                             "cpu")
    jkw = dict(loop_impl="scatter", band_impl="aos", **PRODUCT)
    ref = (jlm.lm_solve(jp, **jkw) if form == "solve"
           else jlm.lm_solve_chunked(jp, chunk_iters=1, **jkw))
    got = _solve(tp, form, **PRODUCT)
    for name in ("iterations", "successful_steps", "total_cg_iterations",
                 "distress_rejects", "converged"):
        assert int(getattr(got, name)) == int(getattr(ref, name)), name
    for name in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(ref, name)), rtol=1e-6)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(ref.t)).max())


def _early_exit(matvec, precond, b, *, cap, r_tolerance, q_tolerance):
    """pcg_nodes with its loop ended by the WHILE node's condition."""
    st = tpcg.pcg_start(precond, b, r_tolerance=r_tolerance)
    cap = torch.tensor(cap, dtype=torch.int32)
    while holds(graph_loops.Cond(st.done, st.k, cap)):
        st = tpcg.pcg_iteration(matvec, precond, b, st,
                                q_tolerance=q_tolerance)
    return tpcg.pcg_finish(st)


@pytest.mark.parametrize("cap", [80, 2])
@pytest.mark.parametrize("q_tol", [0.0, 0.01])
def test_early_exit_cg_matches_the_masked_loop(reduced,  # noqa: F811
                                               q_tol, cap):
    """CG ended on the loop's condition equals the masked fixed-cap loop
    bit for bit (x, count, residual and r), and takes the JAX package's
    pcg_nodes' count; at cap 2 both stop at the cap."""
    jp, tp, jr, tr = reduced
    (jA, jC, _), (tA, tC, _) = _band_systems(reduced)
    F = tp.fanout
    jf = jband.bcr_factorize(jA, jC, group=F, max_levels=2)
    tf = tband.bcr_factorize(tA, tC, group=F, max_levels=2)

    def mv(p):
        return tgn.reduced_matvec_t(tr, tp, p)

    def pc(r):
        return tband.band_precond_apply(tf, r.T).T.contiguous()

    kw = dict(r_tolerance=5e-4, q_tolerance=q_tol)
    got = _early_exit(mv, pc, tr.rhs_n, cap=cap, **kw)
    masked = tpcg.pcg_nodes(mv, pc, tr.rhs_n, max_iterations=cap, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, masked))
    ref = jpcg.pcg_nodes(
        lambda p: jgn.reduced_matvec_t(jr, jp, p),
        lambda r: jband.band_precond_apply(jf, r.T).T, jr.rhs_n,
        max_iterations=cap, **kw)
    assert int(got.iterations) == int(ref.iterations)
    assert (int(got.iterations) == cap) == (cap == 2)
    close(got.x, ref.x, rtol=1e-9)


@pytest.mark.parametrize("over", [
    {}, dict(residual_mode="4dof"), dict(precision="mixed"),
    dict(preconditioner="band*coarse"), dict(preconditioner="jacobi"),
    dict(use_switch=False, cg_q_tolerance=0.1, cg_warm_iters=2)],
    ids=["product", "4dof", "mixed", "two-grid", "jacobi", "options"])
def test_pieces_are_capturable(over):
    """init, pre, two CG iterations and post issue none of FORBIDDEN."""
    prob = _graph()
    setup = graphs.setup_of(prob, **dict(PRODUCT, **over))
    with _Ops() as ops:
        prob.loop_rows_by_node
        pieces = tlm._lm_pieces(prob, **setup)
        state = pieces.init()
        ctx, cg = pieces.pre(state)
        for _ in range(2):
            cg = pieces.cg_iter(ctx, cg)
        state = pieces.post(state, ctx, cg)
    assert not ops.seen & set(FORBIDDEN), ops.seen & set(FORBIDDEN)
    assert int(state.k) == 1 and int(state.cg_total) == int(cg.k) <= 2


def _entry(name: str, t: torch.Tensor) -> str:
    return f"kpg_{name}_{'f32' if t.dtype == torch.float32 else 'f64'}"


@pytest.fixture
def counting(monkeypatch, graphed_cpu):
    """The kernels' plain versions count their calls as launches (the
    wrappers count only on the card), and the capture double runs the
    captured function once, as a capture records its launches."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    plain_mv = band_matvec.band_matvec_plain

    def counted_mv(D, B, x):
        _kernels.count_launch(band_matvec.band_matvec,
                              _entry("band_matvec", x))
        return plain_mv(D, B, x)

    plain_inv = tband.best_inv

    def counted_inv(A, b=6):
        if 12 <= A.shape[-1] <= smallinv.MAX_D:     # K2 on the card
            _kernels.count_launch(smallinv.gj_inv, _entry("gj_inv", A))
        return plain_inv(A, b)

    def recording_capture(fn, device, pool=None):
        fn()
        return EagerGraph(fn), 0.0, 0

    monkeypatch.setattr(band_matvec, "band_matvec_plain", counted_mv)
    monkeypatch.setattr(tband, "best_inv", counted_inv)
    monkeypatch.setattr(graphs, "_capture", recording_capture)


@pytest.mark.parametrize("form", ["solve", "step"])
@pytest.mark.parametrize("config", ["band+coarse", "band*coarse", "mixed"])
def test_counted_launches_are_the_pieces_launches(counting, monkeypatch,
                                                  config, form):
    """The launches that a solve adds to the counters (the pieces'
    tallies: init once, pre and post per LM iteration, cg_iter per CG
    iteration) are those that its pieces launched as they ran."""
    prob = _graph()
    kw = dict(PRODUCT, **CONFIGS[config])
    _solve(prob, form, **kw)                        # builds the Program
    counted = []
    monkeypatch.setattr(graphs.Program, "count",
                        lambda self, runs: counted.append(
                            self.launches(runs)))
    before = dict(_kernels.ENTRY_LAUNCHES)
    res = _solve(prob, form, **kw)
    ran = {e: n - before.get(e, 0) for e, n in _kernels.ENTRY_LAUNCHES.items()
           if n - before.get(e, 0)}
    (tally,) = counted
    assert {e: n for (_, e), n in tally.items()} == ran
    k1 = ran[_entry("band_matvec", prob.q)]      # fp32 under "mixed" too
    cg, it = int(res.total_cg_iterations), int(res.iterations)
    # one K1 per CG iteration, two more in each two-grid apply
    assert k1 == (3 * cg + 2 * it if config == "band*coarse" else cg)
    assert ran[_entry("gj_inv", prob.q)] == 3 * it


class ExtraRun(HostLoops):
    """HostLoops that runs one piece once more in each LM iteration than
    the loops do, where the run changes no state: cg_iter after the CG
    loop has ended (its masks make it a no-op) or pre before the step's
    own (it computes the same start again)."""

    extra = "cg_iter"

    def _step(self) -> None:
        p = self.pieces
        if self.extra == "pre":
            p["pre"].replay()
        p["pre"].replay()
        while holds(self.cg):
            p["cg_iter"].replay()
        if self.extra == "cg_iter":
            p["cg_iter"].replay()
        p["post"].replay()


@pytest.mark.parametrize("form", ["solve", "step"])
@pytest.mark.parametrize("extra", ["cg_iter", "pre"])
def test_an_extra_run_of_a_piece_fails_the_solve(graphed_cpu, monkeypatch,
                                                 extra, form):
    """A piece run once more per LM iteration than the result's counts say
    leaves the static state bit for bit the eager result's, and only the
    pieces' own run counts see it: the solve raises LoopError and its
    Program leaves the cache."""
    prob = _graph(n=100, loops=10, n_cap=128, e_cap=32)
    kw = dict(PRODUCT, max_iterations=3)
    want = tlm._lm_solve_eager(prob, **kw)
    monkeypatch.setattr(ExtraRun, "extra", extra)
    monkeypatch.setattr(graph_loops, "compose", ExtraRun)
    built, build = [], graphs.build
    monkeypatch.setattr(graphs, "build",
                        lambda *a: built.append(build(*a)) or built[-1])
    with pytest.raises(graphs.LoopError, match="ran"):
        _solve(prob, form, **kw)
    assert not graphs._programs
    (prog,) = built
    st = prog.state
    got = tlm.result(st, *prog.ops.result(st.q, st.t, st.s))
    assert all(torch.equal(x, y) for x, y in zip(got, want))

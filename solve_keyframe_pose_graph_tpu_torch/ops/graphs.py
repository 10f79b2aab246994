"""The compiled, warmed solve program: lm_solve on a CUDA Problem through
CUDA graphs (counterpart of the JAX package's ops/lm.py _AOT_CACHE,
lm_solve_aot_prepare, lm_solve_aot, _shape_key, lm_solve_chunked and
_chunk_programs, lm.py:646-842).

The reference compiles its LM solve once per bucket shape, ahead of time,
and can run it one LM iteration per dispatch under the device lock. The port
captures the same two pieces as CUDA graphs, once per key: the setup's
keyword arguments (the solver configuration, with the coarse group
resolved), each Problem field's shape and dtype (so n_cap, e_cap, p_cap,
fanout and dtype; the reference's engine key omits p_cap, engine.py:696)
and the device:

  * the *init* graph: the loop rows' grouping, the assembly at the initial
    guesses and the loop's first state (the reference's init_fn);
  * the *step* graph: one LM iteration, lm._lm_setup's body, with its fixed
    CG iterations and kernels K1 and K2 inside (chunk_fn at chunk_iters=1).

A Program holds static buffers, allocated before either capture and so
outside the graphs' memory pools: a Problem whose leaves each solve copies
in, the grouping, and the loop state, which both graphs end by writing in
place. solve() copies the leaves in, replays init, replays step up to
max_iterations times, each replay followed by the one host read of `done`
(lm_solve's contract: at most max_iterations + 1 host syncs per solve), and
clones the result out of the static buffers: the next solve of the key
overwrites them, and the engine, mixed_resolve and the escalation ladder
keep results. A failed capture or replay raises; nothing falls back to the
eager loop, which lm._lm_solve_eager keeps for comparisons.

Capture: under the dispatch lock that the caller passes (or holds), one at a
time in the process, on a stream of this module's in "thread_local" capture
mode, so that another thread's CUDA calls neither break it nor are broken by
it. An eager warm-up of init and one step on that stream comes first
(PyTorch's rule for graphs: lazy initialisations, the kernels' one-time
set-up and the library handles happen outside the capture). Each graph
gets its own memory pool: the engine replays buckets in the order of its
stream's growth, not in capture order, so pools shared between graphs could
hand one graph's live memory to another.

Concurrency: the cache holds one Program per key, and a Program serves one
solve at a time. A second solve of the key waits for it (Program.busy), and
does so outside the dispatch lock when the lock is passed rather than held
by the caller. A caller that holds the dispatch lock around lm_solve must
not solve a key that another thread is solving with that lock passed: each
would wait for the other. The engine's solves that hold the lock (the
trigger's) and those that pass it (the escalation rungs') are of different
keys: precision "mixed", or float64 at other capacities and CG settings.

Launch counts: a captured launch runs at each replay, not at capture, so the
capture goes into a tally (_kernels.capturing) that each replay adds to the
kernels' counters. The warm-up's launches are real and are counted as they
run; WARMUP_LAUNCHES totals them (one step's worth per Program), so that a
caller can tell them from the replays'.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import threading
import time

import torch

from solve_keyframe_pose_graph_tpu_torch.ops import _kernels
from solve_keyframe_pose_graph_tpu_torch.ops import coarse as coarse_ops
from solve_keyframe_pose_graph_tpu_torch.ops import gn as gn_ops
from solve_keyframe_pose_graph_tpu_torch.ops import lm as lm_ops
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    FIELDS, LoopRows, Problem, loop_rows_by_node,
)

_cache_lock = threading.Lock()
_programs: dict = {}           # key -> Program
_capture_lock = threading.Lock()
_streams: dict = {}            # device -> the capture stream
_tls = threading.local()
LOG: list = []                 # one record per Program built (Program.record)
WARMUP_LAUNCHES: dict = {}     # C entry point -> warm-up launches
REPLAYS = {"init": 0, "step": 0}
REPLAY_S = {"init": 0.0, "step": 0.0}   # host seconds inside replay calls


def on_card(device: torch.device) -> bool:
    """Whether solves on `device` replay graphs: a CUDA device."""
    return device.type == "cuda"


def serves(problem) -> bool:
    """Whether lm_solve takes the graphs for `problem`: a Problem, not a
    mesh's, on a device on_card."""
    return isinstance(problem, Problem) and on_card(problem.device)


def resolved(problem: Problem, setup: dict) -> dict:
    """lm._lm_setup's keyword arguments with the coarse group resolved as
    _lm_setup resolves it, so that both spellings share one key."""
    if setup.get("coarse_group") is None:
        setup = dict(setup, coarse_group=coarse_ops.auto_coarse_group(
            problem.n_cap))
    return setup


def setup_of(problem: Problem, **lm_kw) -> dict:
    """The resolved _lm_setup keyword arguments of lm_solve(problem,
    **lm_kw), its defaults filled in."""
    args = inspect.signature(lm_ops.lm_solve).bind(problem, **lm_kw)
    args.apply_defaults()
    return resolved(problem, {
        k: v for k, v in args.arguments.items()
        if k not in ("problem", "max_iterations", "dispatch_lock")})


def key(problem: Problem, setup: dict) -> tuple:
    """The cache key of (problem, resolved setup)."""
    leaves = tuple((tuple(v.shape), v.dtype)
                   for v in (getattr(problem, f) for f in FIELDS))
    return tuple(sorted(setup.items())), leaves, problem.device


def captures_on_this_thread() -> int:
    """Programs this thread has built (captured) so far."""
    return getattr(_tls, "captures", 0)


def clear() -> None:
    """Drop every Program (its graphs, pools and buffers)."""
    with _cache_lock:
        _programs.clear()


def _copy_into(dst, src) -> None:
    """Copy every tensor leaf of the loop state src into dst's."""
    for name in src._fields:
        d, s = getattr(dst, name), getattr(src, name)
        if isinstance(s, gn_ops.GNBlocksT):
            for f in dataclasses.fields(s):
                getattr(d, f.name).copy_(getattr(s, f.name))
        elif d is not s:
            d.copy_(s)


def _clone_state(state):
    return type(state)(*(
        gn_ops.GNBlocksT(**{f.name: getattr(v, f.name).clone()
                            for f in dataclasses.fields(v)})
        if isinstance(v, gn_ops.GNBlocksT) else v.clone() for v in state))


class Program:
    """The static buffers and the two graphs of one key (see the module
    note). Built and captured by build(); replayed by solve()."""

    def __init__(self, problem: Problem, setup: dict):
        self.key = key(problem, setup)
        self.setup = setup
        self.device = problem.device
        self.problem = Problem(**{
            f: torch.empty(getattr(problem, f).shape,
                           dtype=getattr(problem, f).dtype,
                           device=self.device) for f in FIELDS})
        rows = loop_rows_by_node(problem.loop_b, problem.loop_a,
                                 problem.loop_mask, problem.n_cap)
        self.problem.loop_rows_by_node = LoopRows(
            torch.empty_like(rows.order), torch.empty_like(rows.lengths),
            rows.n)
        self.ops, self._init, self._body = lm_ops._lm_setup(self.problem,
                                                            **setup)
        self.load(problem)
        self.state = _clone_state(self._init_state())
        self.graphs: dict = {}
        self.tallies: dict = {}
        self.record: dict = {}
        self.busy = threading.Lock()           # held by the solve using it

    def load(self, problem: Problem) -> None:
        """Copy the leaves of `problem` into the static Problem."""
        for f in FIELDS:
            getattr(self.problem, f).copy_(getattr(problem, f))

    def _init_state(self):
        """The loop's first state from the static Problem: the grouping
        and, under precision="mixed", the fp64 copy refreshed first."""
        p = self.problem
        rows = loop_rows_by_node(p.loop_b, p.loop_a, p.loop_mask, p.n_cap)
        p.loop_rows_by_node.order.copy_(rows.order)
        p.loop_rows_by_node.lengths.copy_(rows.lengths)
        hi = self.ops.hi
        if hi is not p:
            for f in FIELDS:
                d, s = getattr(hi, f), getattr(p, f)
                if d is not s:
                    d.copy_(s)
        return self._init()

    def run_init(self) -> None:
        """init, written into the static state (what the init graph holds)."""
        _copy_into(self.state, self._init_state())

    def run_step(self) -> None:
        """One LM iteration on the static state, in place (the step graph)."""
        _copy_into(self.state, self._body(self.state))

    def replay(self, name: str) -> None:
        t0 = time.perf_counter()
        self.graphs[name].replay()
        dt = time.perf_counter() - t0
        _kernels.add_launches(self.tallies[name])
        with _cache_lock:
            REPLAYS[name] += 1
            REPLAY_S[name] += dt

    def result(self) -> lm_ops.LMResult:
        """The result of the last replays, cloned out of the static state;
        raises torch.linalg.LinAlgError if a coarse factorization failed.
        The host read of the fault comes after the clones, so that the
        static state may be overwritten once this returns or raises."""
        st = self.state
        res = lm_ops.result(st, *self.ops.result(st.q, st.t, st.s))
        out = lm_ops.LMResult(*(v.clone() for v in res))
        lm_ops.check_fault(st.fault.clone())
        return out


@contextlib.contextmanager
def _capture_stream(device: torch.device):
    """Run the context on this module's capture stream of `device`, ordered
    after the caller's current stream and before what it runs next."""
    if device.type != "cuda":
        yield
        return
    stream = _streams.get(device)
    if stream is None:
        stream = _streams[device] = torch.cuda.Stream(device)
    caller = torch.cuda.current_stream(device)
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        yield
    caller.wait_stream(stream)


def _capture(fn, device: torch.device):
    """Capture fn() on the current stream into a CUDA graph with a memory
    pool of its own, in "thread_local" capture mode, and instantiate it.
    Returns (graph, capture_s, instantiate_s, pool_bytes)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    t0 = time.perf_counter()
    graph.capture_begin(capture_error_mode="thread_local")
    try:
        fn()
    except BaseException:
        with contextlib.suppress(Exception):
            graph.capture_end()        # the capture is invalid; end it
        raise
    graph.capture_end()
    t1 = time.perf_counter()
    graph.instantiate()
    t2 = time.perf_counter()
    pool = tuple(graph.pool())
    nbytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                 if tuple(seg.get("segment_pool_id", ())) == pool)
    return graph, t1 - t0, t2 - t1, nbytes


def build(problem: Problem, setup: dict) -> Program:
    """A Program for (problem, resolved setup), warmed up and captured.
    The caller holds the dispatch lock and _capture_lock."""
    t0 = time.perf_counter()
    prog = Program(problem, setup)
    with _capture_stream(prog.device):
        prog.run_init()                            # the eager warm-up
        prog.run_step()
        if prog.device.type == "cuda":
            torch.cuda.current_stream(prog.device).synchronize()
        warm_s = time.perf_counter() - t0
        rec = dict(warmup_s=warm_s, capture_s=0.0, instantiate_s=0.0,
                   pool_bytes=0)
        for name, fn in (("init", prog.run_init), ("step", prog.run_step)):
            with _kernels.capturing() as tally:
                graph, cap_s, inst_s, nbytes = _capture(fn, prog.device)
            prog.graphs[name], prog.tallies[name] = graph, tally
            rec[f"{name}_pool_bytes"] = nbytes
            rec["capture_s"] += cap_s
            rec["instantiate_s"] += inst_s
            rec["pool_bytes"] += nbytes
    p = prog.problem
    prog.record = dict(
        n_cap=p.n_cap, e_cap=p.e_cap, p_cap=p.p_cap, fanout=p.fanout,
        dtype=str(p.dtype).split(".")[-1], precision=setup["precision"],
        preconditioner=setup["preconditioner"],
        residual_mode=setup["residual_mode"],
        coarse_group=setup["coarse_group"],
        build_s=time.perf_counter() - t0, **rec)
    with _cache_lock:
        # the warm-up ran one step eagerly: its launches, counted as they ran
        for (_, entry), n in prog.tallies["step"].items():
            WARMUP_LAUNCHES[entry] = WARMUP_LAUNCHES.get(entry, 0) + n
        LOG.append(prog.record)
    _tls.captures = captures_on_this_thread() + 1
    return prog


def _program(problem: Problem, setup: dict) -> tuple[Program, bool]:
    """The cached Program of (problem, resolved setup), built if there is
    none, and whether this call built it. The caller holds the dispatch
    lock; builds run one at a time in the process."""
    k = key(problem, setup)
    with _cache_lock:
        prog = _programs.get(k)
    if prog is not None:
        return prog, False
    with _capture_lock:
        with _cache_lock:
            prog = _programs.get(k)
        if prog is not None:                   # built while this waited
            return prog, False
        prog = build(problem, setup)
        with _cache_lock:
            _programs[k] = prog
    return prog, True


def _drop(prog: Program) -> None:
    """Take a Program whose replay failed out of the cache."""
    with _cache_lock:
        if _programs.get(prog.key) is prog:
            del _programs[prog.key]


def prepare(problem: Problem, **lm_kw) -> dict:
    """Make sure that the Program that lm_solve(problem, **lm_kw) replays
    is cached, building (capturing) it if it is not: the warmup's entry
    point. The caller holds the dispatch lock. Returns the Program's record
    (its shapes and configuration, and the warm-up, capture and
    instantiation seconds and the pool bytes of its build) with `built`:
    whether this call built it."""
    setup = setup_of(problem, **lm_kw)
    lm_ops.set_backends(problem.device)
    prog, built = _program(problem, setup)
    return dict(prog.record, built=built)


def solve(problem: Problem, setup: dict, *, max_iterations: int,
          dispatch_lock=None) -> lm_ops.LMResult:
    """lm_solve of a CUDA Problem through the Program of its key (built at
    first use): the leaves copied in and init replayed under the lock, then
    each step replay and its host read of `done` under the lock, and the
    result cloned out. A Program whose replay failed is dropped from the
    cache; a failed coarse factorization (LinAlgError) leaves it there."""
    setup = resolved(problem, setup)
    lock = dispatch_lock if dispatch_lock is not None else \
        contextlib.nullcontext()
    with lock:
        prog, _ = _program(problem, setup)
    with prog.busy:
        try:
            with lock:
                prog.load(problem)
                prog.replay("init")
                done = bool(prog.state.done)
            for _ in range(max_iterations):
                if done:
                    break
                with lock:
                    prog.replay("step")
                    done = bool(prog.state.done)   # one host sync an iteration
            return prog.result()
        except torch.linalg.LinAlgError:
            raise
        except BaseException:
            _drop(prog)
            raise

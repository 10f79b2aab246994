"""The compiled, warmed solve program: lm_solve on a CUDA Problem, or on a
mesh whose shards all sit on one card, through CUDA graphs (counterpart of
the JAX package's ops/lm.py _AOT_CACHE, lm_solve_aot_prepare,
lm_solve_aot, _shape_key, lm_solve_chunked and _chunk_programs,
lm.py:646-842, which serve a GSPMD-sharded Problem as they serve one on
one device).

The reference compiles its LM solve once per bucket shape, ahead of time:
the trigger runs it whole (lm_solve_aot, one dispatch whose LM and CG
loops are while_loops on the device), and the escalation rungs run it one
LM iteration per dispatch under the device lock (lm_solve_chunked). The
port captures the solve's pieces as CUDA graphs, once per key: the setup's
keyword arguments (the solver configuration, with the coarse group
resolved), the shape and dtype of each of the problem's leaves (so n_cap,
e_cap, p_cap, fanout and dtype, and on a mesh the split's; the
reference's engine key omits p_cap, engine.py:696) and the device of each
shard (the reference keys its executable on each leaf's sharding,
lm.py:749-756).

A problem reaches this module only through a small protocol, which
solver/problem.Problem and parallel.ShardedProblem both answer: devices
(one per shard), leaves() (the tensors a solve reads), static_copy() (a
copy with leaves and derived buffers of its own) and refresh() (the
derived buffers recomputed in place from the leaves, with no host read: a
Problem's loop-row grouping; a mesh's sub-Problems' groupings, its owner
sums' groupings and its gathered topology). A mesh's split has one shape
per capacity bucket (parallel/sharding.py pads each shard's ghosts to a
capacity of the bucket), so its loop states hold the same Shards of the
same shapes from one graph of the bucket to the next.

The pieces are lm._lm_pieces':

  * init: the problem's refresh(), the assembly at the initial guesses and
    the loop's first state (the reference's init_fn);
  * pre: an LM iteration up to the CG start (the reduction, the band
    factorization with kernel K2, the coarse inverse, pcg_start);
  * cg_iter: one PCG iteration (kernel K1 inside), in place;
  * post: the rest of the LM iteration, to the next loop state.

ops/graph_loops.py composes them (csrc/graph_loops.cu) into three
executables: init; step, pre -> WHILE(cg) { cg_iter } -> post, one LM
iteration whose CG loop ends on the device on pcg_nodes' cond; and solve,
init -> WHILE(lm) { step }, the whole solve on lm_solve's cond. solve()
takes the form by dispatch_lock, as the reference does: without one (the
trigger, which holds the lock itself; the bench; the CLI) one launch of
solve and one host read; with one (mixed_resolve, fp64_resolve) init and
then one step launch per LM iteration under the lock, each followed by its
host read of `done` (lm_solve_chunked at chunk_iters=1), so that a live
trigger waits at most one LM iteration for the device.

A Program holds static buffers, allocated before any capture and so
outside the graphs' memory pools: a static copy of the problem whose
leaves each solve copies in and whose derived buffers init refreshes,
the LM loop state, the CG loop state, the two loops' caps and the
pieces' run counts. The pieces end by writing the loop states in place;
pre's other outputs (the reduced system, the factorizations) stay alive
in its pool for cg_iter and post to read. Each solve clones the result out of the
static buffers: the next solve of the key overwrites them, and the engine,
mixed_resolve and the escalation ladder keep results. A failed capture,
composition or launch raises; nothing falls back to a host loop or the
eager loop, which lm._lm_solve_eager keeps for comparisons.

Capture: under the dispatch lock that the caller passes (or holds), one at a
time in the process, on a stream of this module's in "thread_local" capture
mode, so that another thread's CUDA calls neither break it nor are broken by
it. An eager warm-up of init, pre, one CG iteration and post on that
stream comes first (PyTorch's rule for graphs: lazy initialisations, the
kernels' one-time set-up and the library handles happen outside the
capture). init gets a memory pool of its own (the engine launches buckets
in the order of its stream's growth, not in capture order, so pools shared
between Programs could hand one's live memory to another). pre, cg_iter and
post share one pool, captured in that order, although they replay in a
cycle (pre, cg_iter k times, post) and not in capture order: the only
blocks of the pool that one piece writes and another reads are pre's
outputs, which stay allocated from pre's capture on, so no later capture
is handed them; every other block is a temporary that its piece writes
and reads before it ends; and the pieces run one at a time on one stream.
A pool per piece gave the same results bit for bit, in more memory than
the one step graph of the form before the WHILE nodes; the shared pool
takes what that graph took.

Concurrency: the cache holds one Program per key, and a Program serves one
solve at a time. A second solve of the key waits for it (Program.busy), and
does so outside the dispatch lock when the lock is passed rather than held
by the caller. A caller that holds the dispatch lock around lm_solve must
not solve a key that another thread is solving with that lock passed: each
would wait for the other. The engine's solves that hold the lock (the
trigger's) and those that pass it (the escalation rungs') are of different
keys: precision "mixed", or float64 at other capacities and CG settings.

Launch counts: a captured launch runs at each replay, not at capture, so
each piece's capture goes into a tally (_kernels.capturing). How often a
piece runs depends on the data, and the device measures it: each piece
ends by adding one to its own run count (Program.runs, init zeroing them
first), outside the loops' masks, so that a body run once too often is
counted even where its masks leave the state as it was. The result's one
host read takes the run counts with `k` and `cg_total`; the counters get
each piece's tally times its runs, and the solve raises unless init ran
once, pre and post once per LM iteration and cg_iter once per CG
iteration. The warm-up's launches are real and are counted as they run;
WARMUP_LAUNCHES totals them (one run of each piece per Program), so that
a caller can tell them apart.
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
from solve_keyframe_pose_graph_tpu_torch.ops import graph_loops
from solve_keyframe_pose_graph_tpu_torch.ops import lm as lm_ops

_cache_lock = threading.Lock()
_programs: dict = {}           # key -> Program
_capture_lock = threading.Lock()
_streams: dict = {}            # device -> the capture stream
_tls = threading.local()
LOG: list = []                 # one record per Program built (Program.record)
WARMUP_LAUNCHES: dict = {}     # C entry point -> warm-up launches
PIECES = ("init", "pre", "cg_iter", "post")
LAUNCHES = dict.fromkeys(graph_loops.NAMES, 0)    # executable -> launches
LAUNCH_S = dict.fromkeys(graph_loops.NAMES, 0.0)  # host seconds in them
HOST_READS = {"solve": 0, "step": 0}   # host reads by form of solve


class LoopError(_kernels.KernelError):
    """A solve's pieces ran other than its LM and CG counts say: a device
    error (_kernels.is_device_error), which no caller carries on past."""


def on_card(device: torch.device) -> bool:
    """Whether solves on `device` replay graphs: a CUDA device."""
    return device.type == "cuda"


def serves_devices(devices) -> bool:
    """Whether solves on shards on `devices` replay graphs: one device
    on_card, which every shard shares. A mesh over distinct cards solves
    eagerly: the composed executables are conditional WHILE nodes
    (csrc/graph_loops.cu), and CUDA requires every kernel in a conditional
    node's body to belong to one context, that is one device, so one
    executable cannot issue the shards' work on several cards."""
    return len(set(devices)) == 1 and on_card(devices[0])


def serves(problem) -> bool:
    """Whether lm_solve takes the graphs for `problem`: a Problem on a
    device on_card, or a mesh's (parallel.ShardedProblem) whose shards all
    sit on one such device (serves_devices)."""
    return serves_devices(problem.devices)


def resolved(problem, setup: dict) -> dict:
    """lm._lm_setup's keyword arguments with the coarse group resolved as
    _lm_setup resolves it, so that both spellings share one key."""
    if setup.get("coarse_group") is None:
        setup = dict(setup, coarse_group=coarse_ops.auto_coarse_group(
            problem.n_cap))
    return setup


def setup_of(problem, **lm_kw) -> dict:
    """The resolved _lm_setup keyword arguments of lm_solve(problem,
    **lm_kw), its defaults filled in."""
    args = inspect.signature(lm_ops.lm_solve).bind(problem, **lm_kw)
    args.apply_defaults()
    return resolved(problem, {
        k: v for k, v in args.arguments.items()
        if k not in ("problem", "max_iterations", "dispatch_lock")})


def key(problem, setup: dict) -> tuple:
    """The cache key of (problem, resolved setup): the setup, the shape
    and dtype of each of the problem's leaves (a mesh's: every shard's)
    and the device of each shard (so the mesh's size and its device)."""
    leaves = tuple((tuple(v.shape), v.dtype) for v in problem.leaves())
    return tuple(sorted(setup.items())), leaves, tuple(problem.devices)


def captures_on_this_thread() -> int:
    """Programs this thread has built (captured) so far."""
    return getattr(_tls, "captures", 0)


def clear() -> None:
    """Drop every Program (its graphs, pools and buffers)."""
    with _cache_lock:
        _programs.clear()


def _leaves(state) -> list:
    """The tensors of a loop state, in a fixed order: NamedTuples and
    dataclasses (gn.GNBlocksT) field by field, and a mesh's sharded
    vectors (parallel.collectives.Shards) by their `parts`."""
    if isinstance(state, torch.Tensor):
        return [state]
    if dataclasses.is_dataclass(state):
        items = [getattr(state, f.name) for f in dataclasses.fields(state)]
    else:
        items = state if isinstance(state, tuple) else state.parts
    return [x for v in items for x in _leaves(v)]


def _map(fn, state):
    """The loop state with fn applied to each of its tensors (_leaves)."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{
            f.name: _map(fn, getattr(state, f.name))
            for f in dataclasses.fields(state)})
    if isinstance(state, tuple):
        return type(state)(*(_map(fn, v) for v in state))
    return type(state)(_map(fn, v) for v in state.parts)


def _copy_into(dst, src) -> None:
    """Copy every tensor of the loop state (or problem leaves) src into
    dst's, where they are not the same tensor."""
    for d, s in zip(_leaves(dst), _leaves(src)):
        if d is not s:
            d.copy_(s)


def _clone_state(state):
    return _map(torch.Tensor.clone, state)


class Program:
    """The static buffers, the four captured pieces and the composed
    executables of one key (see the module note). Built and captured by
    build(); launched by solve()."""

    def __init__(self, problem, setup: dict):
        self.key = key(problem, setup)
        self.setup = setup
        self.device = dev = problem.device
        self.problem = problem.static_copy()
        self.pieces = lm_ops._lm_pieces(self.problem, **setup)
        self.ops = self.pieces.ops
        self.load(problem)
        self.state = _clone_state(self._init_state())
        self.ctx = self.cg = None              # set by the warm-up's pre
        int32 = dict(dtype=torch.int32, device=dev)
        self.caps = {"cg": torch.full((), self.pieces.max_cg_iterations,
                                      **int32),
                     "lm": torch.zeros((), **int32)}
        self.runs = torch.zeros(len(PIECES), **int32)   # runs per piece
        self.graphs: dict = {}
        self.tallies: dict = {}
        self.loops = None
        self.record: dict = {}
        self.busy = threading.Lock()           # held by the solve using it

    def load(self, problem) -> None:
        """Copy the leaves of `problem` into the static problem's."""
        _copy_into(self.problem.leaves(), problem.leaves())

    def _init_state(self):
        """The loop's first state from the static problem: what its leaves
        determine (its refresh(): the loop rows' grouping, and a mesh's
        owner sums and topology) and, under precision="mixed", the fp64
        copy refreshed first."""
        p = self.problem
        p.refresh()
        if self.ops.hi is not p:
            _copy_into(self.ops.hi.leaves(), p.leaves())
        return self.pieces.init()

    def _ran(self, name: str) -> None:
        """Add one to the run count of the piece `name` on the device,
        unmasked; init zeroes the counts first."""
        if name == "init":
            self.runs.zero_()
        self.runs[PIECES.index(name)].add_(1)

    # the pieces, each ending in writes to the static state and its run
    # count (what each captured graph holds)
    def run_init(self) -> None:
        _copy_into(self.state, self._init_state())
        self._ran("init")

    def run_pre(self) -> None:
        self.ctx, cg = self.pieces.pre(self.state)
        if self.cg is None:                    # the warm-up: allocate it
            self.cg = _clone_state(cg)
        else:
            _copy_into(self.cg, cg)
        self._ran("pre")

    def run_cg_iter(self) -> None:
        _copy_into(self.cg, self.pieces.cg_iter(self.ctx, self.cg))
        self._ran("cg_iter")

    def run_post(self) -> None:
        _copy_into(self.state, self.pieces.post(self.state, self.ctx,
                                                self.cg))
        self._ran("post")

    def conds(self) -> tuple:
        """(cg, lm): the CG and LM loops' conditions on the static state."""
        return (graph_loops.Cond(self.cg.done, self.cg.k, self.caps["cg"]),
                graph_loops.Cond(self.state.done, self.state.k,
                                 self.caps["lm"]))

    def launch(self, name: str) -> None:
        t0 = time.perf_counter()
        self.loops.launch(name)
        dt = time.perf_counter() - t0
        with _cache_lock:
            LAUNCHES[name] += 1
            LAUNCH_S[name] += dt

    def read(self, form: str, *values) -> list:
        """One host read of the 0-d integer or bool tensors `values`."""
        out = torch.stack([v.to(torch.int64) for v in values]).tolist()
        with _cache_lock:
            HOST_READS[form] += 1
        return out

    def launches(self, runs: dict) -> dict:
        """The kernels' launches {(wrapper, entry): n} of `runs` {piece:
        runs}: each piece's tally times its runs."""
        tally: dict = {}
        for name, n in runs.items():
            for k, v in self.tallies[name].items():
                tally[k] = tally.get(k, 0) + n * v
        return tally

    def count(self, runs: dict) -> None:
        """Add launches(runs) to the counters."""
        _kernels.add_launches(self.launches(runs))

    def result(self, form: str) -> lm_ops.LMResult:
        """The result of the last launches, cloned out of the static state,
        the launches that the pieces' run counts imply counted. Raises
        LoopError unless init ran once, pre and post once per LM iteration
        and cg_iter once per CG iteration, and torch.linalg.LinAlgError if
        a coarse factorization failed. The host read comes after the
        clones, so that the static state may be overwritten once this
        returns or raises."""
        st = self.state
        res = lm_ops.result(st, *self.ops.result(st.q, st.t, st.s))
        out = lm_ops.LMResult(*(v.clone() for v in res))
        k, cg_total, fault, *runs = self.read(form, st.k, st.cg_total,
                                              st.fault, *self.runs)
        runs = dict(zip(PIECES, runs))
        self.count(runs)
        want = {"init": 1, "pre": k, "cg_iter": cg_total, "post": k}
        if runs != want:
            raise LoopError(f"the pieces ran {runs} times in a solve of {k} "
                            f"LM and {cg_total} CG iterations ({want})")
        lm_ops.check_fault(fault)
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


def _capture(fn, device: torch.device, pool=None):
    """Capture fn() on the current stream into a CUDA graph, in the memory
    pool `pool` (None: a pool of its own), in "thread_local" capture mode,
    kept (not instantiated: graph_loops composes it). Returns (graph,
    capture_s, the bytes of its pool after the capture)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    t0 = time.perf_counter()
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        fn()
    except BaseException:
        with contextlib.suppress(Exception):
            graph.capture_end()        # the capture is invalid; end it
        raise
    graph.capture_end()
    t1 = time.perf_counter()
    handle = tuple(graph.pool())
    nbytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                 if tuple(seg.get("segment_pool_id", ())) == handle)
    return graph, t1 - t0, nbytes


def build(problem, setup: dict) -> Program:
    """A Program for (problem, resolved setup), warmed up, captured and
    composed. The caller holds the dispatch lock and _capture_lock."""
    t0 = time.perf_counter()
    prog = Program(problem, setup)
    runs = {"init": prog.run_init, "pre": prog.run_pre,
            "cg_iter": prog.run_cg_iter, "post": prog.run_post}
    with _capture_stream(prog.device):
        for name in PIECES:                        # the eager warm-up
            runs[name]()
        if prog.device.type == "cuda":
            torch.cuda.current_stream(prog.device).synchronize()
        warm_s = time.perf_counter() - t0
        rec = dict(warmup_s=warm_s, capture_s=0.0)
        pool = None                        # init's own, then the step's
        for name in PIECES:
            with _kernels.capturing() as tally:
                graph, cap_s, nbytes = _capture(runs[name], prog.device,
                                                pool)
            prog.graphs[name], prog.tallies[name] = graph, tally
            pool = graph.pool() if name == "pre" else pool
            rec["init_pool_bytes" if name == "init" else
                "step_pool_bytes"] = nbytes
            rec["capture_s"] += cap_s
        rec["pool_bytes"] = rec["init_pool_bytes"] + rec["step_pool_bytes"]
        t1 = time.perf_counter()
        prog.loops = graph_loops.compose(prog.graphs, *prog.conds(),
                                         prog.device)
        rec["instantiate_s"] = time.perf_counter() - t1
    p = prog.problem
    prog.record = dict(
        n_cap=p.n_cap, e_cap=p.e_cap, p_cap=p.p_cap, fanout=p.fanout,
        shards=p.n_shards,
        dtype=str(p.dtype).split(".")[-1], precision=setup["precision"],
        preconditioner=setup["preconditioner"],
        residual_mode=setup["residual_mode"],
        coarse_group=setup["coarse_group"],
        build_s=time.perf_counter() - t0, **rec)
    with _cache_lock:
        # the warm-up ran each piece once eagerly: its launches, counted as
        # they ran
        for tally in prog.tallies.values():
            for (_, entry), n in tally.items():
                WARMUP_LAUNCHES[entry] = WARMUP_LAUNCHES.get(entry, 0) + n
        LOG.append(prog.record)
    _tls.captures = captures_on_this_thread() + 1
    return prog


def _program(problem, setup: dict) -> tuple[Program, bool]:
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


def prepare(problem, **lm_kw) -> dict:
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


def solve(problem, setup: dict, *, max_iterations: int,
          dispatch_lock=None) -> lm_ops.LMResult:
    """lm_solve of a problem that serves() through the Program of its key
    (built at first use). Without dispatch_lock: the leaves copied in, one
    launch of the solve executable and the result cloned out with one host
    read. With it: under the lock the leaves copied in, init launched and
    `k` and `done` read; then each step launch and its read under the lock
    until the LM loop's cond fails; then the result. A Program whose
    launch failed is dropped from the cache; a failed coarse factorization
    (LinAlgError) leaves it there."""
    setup = resolved(problem, setup)
    lock = dispatch_lock if dispatch_lock is not None else \
        contextlib.nullcontext()
    with lock:
        prog, _ = _program(problem, setup)
    with prog.busy:
        try:
            if dispatch_lock is None:
                prog.load(problem)
                prog.caps["lm"].fill_(max_iterations)
                prog.launch("solve")
                return prog.result("solve")
            st = prog.state
            with lock:
                prog.load(problem)
                prog.launch("init")
                k, done = prog.read("step", st.k, st.done)
            while not done and k < max_iterations:
                with lock:
                    prog.launch("step")
                    k, done = prog.read("step", st.k, st.done)
            return prog.result("step")
        except torch.linalg.LinAlgError:
            raise
        except BaseException:
            _drop(prog)
            raise

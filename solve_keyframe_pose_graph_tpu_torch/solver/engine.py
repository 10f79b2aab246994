"""Streaming solver engine (counterpart of
solve_keyframe_pose_graph_tpu/solver/engine.py).

Per trigger (wakes only when new loop edges arrived, the robot is not
kidnapped and no escalated re-solve is in flight), exactly as the reference
engine:
  0. allocate opt variables for new nodes and switch variables for new edges;
  1/2. per new loop edge: on the first contact between two worlds, compute
     wb_T_wa from the VIO estimates and union-merge them in the registry;
  4. initial guesses for all nodes by the 4-case (in_change_set,
     before_solvedUntil) table;
  5. soft anchors on the start node of every world that is its own set root;
  6. one LM solve (ops/lm.py) on the engine's device, then write-back.

Most of this is host numpy, carried over as it is. The solve and its one
device->host copy run under the engine's device lock, on the trigger's
thread: a trigger that fires has written back and appended its solve_stats
row when it returns. A solve with the fp32 distress signature is re-solved
on the fp64 ladder (ops/lm.py escalate_resolve): in a background thread
(stream.background_escalation, the default), whose result is dropped if a
world merge landed meanwhile, or inline in the trigger. The background rung
takes the device lock around each of its device steps, so trigger solves
wait at most one of them. A trigger that made a first contact between
worlds is not escalated: its start places a world by one loop edge's
observation, metres off where that edge is an outlier, and the rejections
of a solve from such a start are the LM's radius search, which the fp64
rung repeats at the same cost (on the card, a 4.5k-node merge re-solved on
the host rung ended 4e-6 from the fp32 cost, itself unconverged after 10
iterations), while the triggers it holds back wait for it for seconds.

Threads and CUDA streams: a background thread (escalation, warmup) runs
its device work on the stream that was current on the thread that started
it, so a problem built on the trigger's thread is consumed in order on it;
every result crosses to the host by a copy that waits for its kernels.

The trigger's Problem comes from solver/incremental.py (stream.
incremental_build, the default): the observation leaves stay on the device
and only the new nodes' and edges' rows are built, bitwise equal to the full
build_problem_np, which is taken otherwise. Each solve_stats row of a trigger
records the build's wall time and the builds taken so far of each kind.

With config.mesh.n_devices = P > 1 the engine solves over a mesh of P
shards (parallel/): the `mesh` passed in, or the first P cards for a cuda
device and P CPU shards for the CPU; too few cards raise at construction.
As in the reference, the mesh path takes the full problem build, shards it
(parallel.shard_problem) and writes back from the gathered result.

On a CUDA device, without a mesh or on a mesh whose shards all sit on
one card, each trigger's solve is one launch of the composed graphs of its
capacity bucket, its LM and CG loops ending on the card (ops/graphs.py), as
the reference's trigger runs the compiled program of its bucket; the
escalation rungs, which get the device lock passed, launch one LM
iteration at a time. warmup() captures them ahead of the
stream for the reference's bucket ladder (_warmup_pairs), and, on a thread
of its own, loads the host fp64 rung (the native LDL^T library, built on demand,
and scipy) when the config can escalate to it. A trigger whose bucket is
not warmed captures its own, unless the bucket cover gives it a box: each
trigger's solve_stats row counts the captures its solve took
(trigger_captures). The escalation ladder's device rungs are captured at
first use, not warmed. On a mesh the warmup shards each bucket's dummy
graph over it, so it captures the mesh's Programs, which its triggers
replay (the reference's _warm_one builds an unsharded problem, whose
executable a mesh trigger never dispatches).

The bucket cover, the reference's rule (its engine.py:188-196, 691-700):
_warmed_buckets holds the (n_cap, e_cap, dtype) buckets that this engine
has warmed (_warm_one, once the bucket is captured and primed) or
dispatched a trigger in. A trigger whose exact bucket is not there solves
in the smallest bucket of the set, by (n_cap, e_cap), of its dtype that
holds it (n_cap and e_cap both at least its own): the padding is masked,
so it is the same problem in a larger box, and a graphed engine replays
that box's Program instead of capturing one on the trigger path. The
problem is built at the box (a box that changes, grown or shrunk, is a
full build of the incremental builder, which keys on the caps) and the
sticky coarse group is the box's n_cap's. p_cap stays the trigger's own,
and the set's key omits it, as the reference's does: a trigger with more
than 16 anchored worlds captures its own Program at the box, where the
reference compiles. The set is read and written under state_lock, so a
background warmup can add to it while a trigger picks its box (the
reference sorts it unlocked); with background=True a bucket enters it
only once captured, so a trigger covers only with captured buckets. The
escalation ladder repacks as the reference's does: the host rung to the
live lengths, so its result does not depend on the box; the device fp64
rung to the 1024-multiples that hold them, capped at the box, so it
depends on the box only where the box is below those; the mixed rung runs
at the box. _to_host slices every result to the live lengths. Eager engines (the CPU, a mesh over distinct cards) capture nothing:
their warmup records the reference's whole ladder in the set, so that both
packages pick the same box for a trigger, and primes one solve at the
ladder's first bucket. Such an engine gains nothing from a cover and pays
for the larger box (an eager CPU solve runs every CG iteration of its cap
at the box's size), as the reference does on its CPU. Left out: sticky
tile_k and the host rung's per-bucket traces (the port's host rung
compiles nothing).

Tracing (utils/timing.py): a trigger that fires opens a Record at its
start, when it reads the store's edge count. Its phases are spans in it,
on the monotonic clock: world_mapping, first_contact, initial_guesses,
priors, device_solve (device_lock_wait, prepare with problem_build, and
on the card the solve's launch and result_wait, to_host), write_back;
state_lock_wait and device_lock_wait at each acquisition of those locks.
Its solve_stats row gets t_start, t_end, spans_ms, the summed lock_wait_ms,
launch_ms and result_wait_ms (None where no such span ran), poll_sleep_s
(run()'s waits so far, in seconds), poll_wakes (those of them that ended
before the poll's period) and its new edges' waits in the store
(_edge_waits); its trigger_wall_ms runs from that start, so it holds the
kidnap and world checks and _edge_waits too. Its world counters: worlds
and sets (the registry's, after the trigger's first contacts), priors,
first_contacts, rebased_nodes (case 1), mapped_nodes (case 4) and
dead_nodes (the trigger's nodes in a kidnap dead zone); kidnap_polls
counts the triggers refused, with new edges, while kidnapped. The timer's
totals of every phase are the status query's trace.phases
(runtime_server.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from solve_keyframe_pose_graph_tpu_torch.config import Config
from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
from solve_keyframe_pose_graph_tpu_torch.utils import nse3, timing
from solve_keyframe_pose_graph_tpu_torch.ops import _kernels
from solve_keyframe_pose_graph_tpu_torch.ops import coarse as coarse_ops
from solve_keyframe_pose_graph_tpu_torch.ops import graphs
from solve_keyframe_pose_graph_tpu_torch.ops import lm as lm_ops
from solve_keyframe_pose_graph_tpu_torch.parallel.sharding import (
    Mesh, engine_mesh, shard_problem, split_sizes,
)
from solve_keyframe_pose_graph_tpu_torch.solver.incremental import (
    IncrementalBuilder,
)
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    Problem, build_problem_np, solve_device,
)

log = logging.getLogger(__name__)


def _bucket(n: int, initial: int) -> int:
    cap = initial
    while cap < n:
        cap *= 2
    return cap


def _warmup_pairs(cap, max_nodes: int, max_edges: int,
                  proportional: bool = True) -> list:
    """The (n_cap, e_cap) buckets warmup() captures (a copy of the
    reference's engine.py:55-95).

    proportional=True prunes the full product down to the buckets a stream
    growing to (max_nodes, max_edges) with edges in proportion to nodes
    visits: a monotone staircase on which n_cap and e_cap do not double at
    the same node. The stream enters n-bucket n_cap at ~n_cap/2 nodes
    carrying about half that bucket's proportional edge load; every
    e-bucket from that entry load up to twice the exit load is kept (one
    doubling of burst headroom). A stream that strays off the kept set
    captures its own bucket."""
    pairs = []
    n_cap = cap.initial_nodes
    while True:
        e_cap = cap.initial_edges
        while e_cap <= max(_bucket(max_edges, cap.initial_edges),
                           cap.initial_edges):
            pairs.append((n_cap, e_cap))
            e_cap *= 2
        if n_cap >= _bucket(max_nodes, cap.initial_nodes):
            break
        n_cap *= 2
    if proportional and max_edges > cap.initial_edges:
        n_final = _bucket(max_nodes, cap.initial_nodes)
        kept = []
        for n_cap_, e_cap_ in pairs:
            e_entry = max(int(max_edges * (n_cap_ // 2) / n_final), 1)
            e_exit = max(
                int(max_edges * min(n_cap_, max_nodes) / n_final), 1)
            lo = _bucket(e_entry, cap.initial_edges)
            hi = 2 * _bucket(e_exit, cap.initial_edges)
            if lo <= e_cap_ <= hi:
                kept.append((n_cap_, e_cap_))
        pairs = kept
    return pairs


def _to_host(res: lm_ops.LMResult, node_len: int, edge_len: int
             ) -> lm_ops.LMResult:
    """The write-back part of a result as CPU fp64 tensors, fetched from the
    device in one copy (which waits for the solve's kernels)."""
    scalars = (res.initial_cost, res.final_cost, res.iterations,
               res.successful_steps, res.distress_rejects,
               res.total_cg_iterations, res.converged, res.cg_truncation)
    flat = torch.cat([res.q[:node_len].reshape(-1).double(),
                      res.t[:node_len].reshape(-1).double(),
                      res.switch[:edge_len].double(),
                      torch.stack([v.double() for v in scalars])]).cpu()
    q, t, sw, sc = torch.split(flat, [4 * node_len, 3 * node_len, edge_len,
                                      len(scalars)])
    return lm_ops.LMResult(
        q=q.reshape(node_len, 4), t=t.reshape(node_len, 3), switch=sw,
        initial_cost=sc[0], final_cost=sc[1],
        iterations=sc[2].to(torch.int32),
        successful_steps=sc[3].to(torch.int32),
        distress_rejects=sc[4].to(torch.int32),
        total_cg_iterations=sc[5].to(torch.int32),
        converged=sc[6] > 0.5, cg_truncation=sc[7])


def _on_stream(device: torch.device):
    """A context that runs a worker thread's device work on the stream
    that is current on the calling thread (see the module note)."""
    if device.type != "cuda":
        return lambda: contextlib.nullcontext()
    stream = torch.cuda.current_stream(device)
    return lambda: torch.cuda.stream(stream)


class SolverEngine:
    def __init__(self, store: GraphStore, config: Optional[Config] = None,
                 device="cuda", mesh: Optional[Mesh] = None):
        self.store = store
        self.config = config or Config()
        cfg = self.config
        if mesh is None and cfg.mesh.n_devices <= 1:
            self.mesh = None
            self.device = solve_device(device)
        else:
            self.mesh = engine_mesh(cfg.mesh.n_devices, torch.device(device),
                                    mesh)
            # every capacity bucket is the first one doubled
            split_sizes(cfg.capacity.initial_nodes, cfg.capacity.initial_edges,
                        cfg.residual.odometry_fanout, len(self.mesh))
            self.device = self.mesh.devices[0]
        res_cfg = self.config.residual
        self._builder = IncrementalBuilder(
            fanout=res_cfg.odometry_fanout, odo_decay=res_cfg.odometry_decay,
            odo_yaw_sigma2=res_cfg.odometry_yaw_sigma2)
        self._scratch_builds = 0       # full builds outside the builder

        cap = self.config.capacity.initial_nodes
        self._opt_q = np.zeros((cap, 4)); self._opt_q[:, 3] = 1.0
        self._opt_t = np.zeros((cap, 3))
        self._opt_frozen = np.zeros(cap, bool)
        self._n_opt = 0

        ecap = self.config.capacity.initial_edges
        self._switch = np.full(ecap, self.config.residual.switch_init)
        self._n_switch = 0

        self.solved_until = 0
        self.status = -1
        self.prev_edge_len = 0
        self.prev_node_len = 0
        self.trigger_id = 0
        # triggers with new loop edges refused while kidnapped
        self.kidnap_polls = 0
        self.n_solve_convergences = 0
        self.last_result: Optional[lm_ops.LMResult] = None
        self.solve_stats: list = []
        # per warmed bucket: n_cap, e_cap, capture_s, instantiate_s,
        # first_replay_s, pool_mb (the capture fields None on an eager
        # engine)
        self.warmup_stats: list = []
        self.timer = timing.PhaseTimer()
        # worldID -> (old setID, new setID), valid for one trigger
        self._changes_to_setid: Dict[int, Tuple[int, int]] = {}
        # guards the opt variables against concurrent readers (a composer
        # thread); the solve itself runs on a snapshot outside it
        self.state_lock = threading.RLock()
        # sticky structure-aware coarse_group per capacity bucket:
        # n_cap -> (group, edge_len at decision). See _prepare_solve.
        self._coarse_group_by_cap: Dict[int, Tuple[int, int]] = {}
        # (n_cap, e_cap, dtype) buckets warmed or dispatched in, for the
        # bucket cover (see the module note); under state_lock
        self._warmed_buckets: set = set()
        # serializes device work between trigger solves, the warmup and a
        # background escalation's device steps
        self._device_lock = threading.Lock()
        # in-flight background escalated re-solve; joined by drain()
        self._bg_thread: Optional[threading.Thread] = None
        self._warmup_thread: Optional[threading.Thread] = None
        self._host_rung_thread: Optional[threading.Thread] = None
        # a kernel or device failure on a background thread, raised on the
        # next trigger / drain / warmup_join
        self._bg_error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    # opt-variable access
    # ------------------------------------------------------------------

    def n_opt_variables(self) -> int:
        return self._n_opt

    def node_pose_exists(self, i: int) -> bool:
        return 0 <= i < self._n_opt

    def get_node_pose(self, i: int):
        if not self.node_pose_exists(i):
            raise IndexError(f"no optimized pose for node {i}")
        return self._opt_q[i].copy(), self._opt_t[i].copy()

    def get_switch(self, e: int) -> float:
        return float(self._switch[e])

    def _grow_nodes(self, n: int):
        cap = len(self._opt_q)
        if n <= cap:
            return
        new_cap = _bucket(n, cap)
        q = np.zeros((new_cap, 4)); q[:, 3] = 1.0
        q[: self._n_opt] = self._opt_q[: self._n_opt]
        t = np.zeros((new_cap, 3)); t[: self._n_opt] = self._opt_t[: self._n_opt]
        fr = np.zeros(new_cap, bool)
        fr[: self._n_opt] = self._opt_frozen[: self._n_opt]
        self._opt_q, self._opt_t, self._opt_frozen = q, t, fr

    def _grow_switch(self, n: int):
        cap = len(self._switch)
        if n <= cap:
            return
        new_cap = _bucket(n, cap)
        s = np.full(new_cap, self.config.residual.switch_init)
        s[: self._n_switch] = self._switch[: self._n_switch]
        self._switch = s

    # ------------------------------------------------------------------
    # trigger
    # ------------------------------------------------------------------

    def trigger(self) -> bool:
        """One poll of the solver loop. Returns True if a solve ran; its
        write-back and solve_stats row have then landed."""
        store = self.store
        self._raise_bg_error()
        # edges first: nodes are appended before the edges that reference
        # them, so every edge < edge_len has endpoints < node_len
        edge_len = store.edge_len
        node_len = store.node_len
        # the trigger's start: every edge it takes in was stamped before
        t_start = time.monotonic()
        if edge_len == self.prev_edge_len or node_len == 0:
            self.status = 0
            return False
        if store.current_kidnap_status:
            # the reference's solver sleeps while kidnapped
            self.kidnap_polls += 1
            self.status = 0
            return False
        if self._bg_thread is not None and self._bg_thread.is_alive():
            # an escalated re-solve of this graph is in flight: new edges
            # accumulate until it lands, as in the reference engine (kept
            # for parity; a behaviour change needs its own A/B)
            self.status = 0
            return False

        taken = dict(poll_sleep_s=self.poll_sleep_s,
                     poll_wakes=self.poll_wakes,
                     **self._edge_waits(t_start, edge_len))
        with timing.recording(timing.Record(t_start)) as rec:
            return self._fire(rec, node_len, edge_len, taken)

    def _fire(self, rec: timing.Record, node_len: int, edge_len: int,
              taken: dict) -> bool:
        """The trigger's solve, once it has new edges to take, its spans
        going into `rec`; `taken` holds its edge and poll entries of the
        solve_stats row."""
        store = self.store
        self.status = 1
        self.trigger_id += 1
        worlds = store.worlds
        timer = self.timer

        # ---- 0: allocate new opt variables (identity init; the real guess
        # is set below)
        self._grow_nodes(node_len)
        self._grow_switch(edge_len)
        self._opt_q[self._n_opt:node_len] = [0, 0, 0, 1]
        self._opt_t[self._n_opt:node_len] = 0
        self._n_opt = max(self._n_opt, node_len)
        self._n_switch = max(self._n_switch, edge_len)

        with timer.phase("world_mapping"):
            node_worlds = store.node_worlds()[:node_len]

        # ---- 1/2: new loop edges; inter-world first contact
        first_contacts = 0
        with timer.phase("first_contact"):
            for e in range(self.prev_edge_len, edge_len):
                a, b = store.edge_idx_info(e)
                w_a = int(node_worlds[a])
                w_b = int(node_worlds[b])
                if (w_a < 0 or w_b < 0 or w_a == w_b
                        or worlds.is_exist(w_b, w_a)):
                    continue
                # first contact: wb_T_wa = wb_T_b * b_T_a_obs * (wa_T_a)^-1
                qa, ta = store.node_pose(a)
                qb, tb = store.node_pose(b)
                qe, te = store.edge_pose(e)
                q_wb_a, t_wb_a = nse3.pose_mul(qb, tb, qe, te)
                q_inv, t_inv = nse3.pose_inv(qa, ta)
                q_rel, t_rel = nse3.pose_mul(q_wb_a, t_wb_a, q_inv, t_inv)
                before = worlds.get_world_to_setid_map()
                worlds.set_pose_between_worlds(
                    w_b, w_a, q_rel, t_rel,
                    f"this pose computed from edge {a} <--> {b}")
                after = worlds.get_world_to_setid_map()
                first_contacts += 1
                self._changes_to_setid.clear()
                for wid, sid_before in before.items():
                    if after[wid] != sid_before:
                        self._changes_to_setid[wid] = (sid_before,
                                                       after[wid])

        # ---- 4: initial guesses, 4-case table
        with timer.phase("initial_guesses"):
            guessed = self._set_initial_guesses(node_len, node_worlds)
        # ---- 5: soft anchors on set-root world starts. A live store may
        # have grown since node_len was read (the server ingests beside the
        # solver): a world whose first node is not in this solve's nodes
        # gets no anchor, and a world's end is clamped to them. The
        # reference reads the live store here and can index past its
        # arrays (engine.py:343-356).
        prior_idx, prior_q, prior_t, prior_w = [], [], [], []
        with timer.phase("priors"):
            for ww in range(store.n_worlds()):
                ww_setid = worlds.find_setID_of_world_i(ww)
                ww_start = store.nodeidx_of_world_i_started(ww)
                ww_end = min(store.nodeidx_of_world_i_ended(ww), node_len - 1)
                if not 0 <= ww_start < node_len:
                    continue
                if ww_setid >= 0 and ww_setid == ww:
                    prior_idx.append(ww_start)
                    prior_q.append(self._opt_q[ww_start].copy())
                    prior_t.append(self._opt_t[ww_start].copy())
                    prior_w.append(max(
                        1.1, math.log(1 + max(ww_end - ww_start, 0)) / 2.0))
        self._changes_to_setid.clear()
        taken = dict(taken, worlds=store.n_worlds(), sets=worlds.n_sets(),
                     priors=len(prior_idx), first_contacts=first_contacts,
                     dead_nodes=int(np.count_nonzero(node_worlds < 0)),
                     **guessed)

        # ---- 6: solve on the device
        self.status = 2
        tid = self.trigger_id
        with timer.phase("device_solve"):
            with self._locked(self._device_lock, "device_lock_wait"), \
                    timer.phase("prepare"):
                problem, kw, build = self._prepare_solve(
                    node_len, edge_len, node_worlds, prior_idx, prior_q,
                    prior_t, prior_w)
            res, captures = self._solve_to_host(problem, kw, node_len,
                                                edge_len)
        self._finish_solve(res, problem, kw, node_len, edge_len, node_worlds,
                           tid, rec, dict(build, **taken,
                                          trigger_captures=captures))
        return True

    def _edge_waits(self, t_start: float, edge_len: int) -> dict:
        """The solve_stats entries of the new loop edges' waits in the
        store: edge_from (prev_edge_len), and over the new edges that carry
        an arrival stamp, edges_taken, edge_wait_sum_ms and edge_wait_max_ms
        (t_start less the stamp). A store may count an edge before its
        stamp lands (graph/native.py), and an edge loaded from disk has
        none: both are left out."""
        lo = self.prev_edge_len
        stamps = self.store.edge_arrivals
        at = np.asarray(stamps[lo:min(edge_len, len(stamps))], np.float64)
        waits = 1000.0 * (t_start - at[~np.isnan(at)])
        return dict(edge_from=lo, edges_taken=len(waits),
                    edge_wait_sum_ms=float(waits.sum()),
                    edge_wait_max_ms=float(waits.max()) if len(waits)
                    else None)

    @contextlib.contextmanager
    def _locked(self, lock, name: str):
        """Hold `lock`, its acquisition timed as the phase `name`."""
        with self.timer.phase(name):
            lock.acquire()
        try:
            yield
        finally:
            lock.release()

    @property
    def poll_sleeps(self) -> int:
        """The waits of run()'s poll so far."""
        return self.timer.counts.get("poll_sleep", 0)

    @property
    def poll_sleep_s(self) -> float:
        """The seconds run()'s poll has waited so far."""
        return self.timer.totals.get("poll_sleep", 0.0)

    @property
    def poll_wakes(self) -> int:
        """The waits of run()'s poll that ended before its period: woken
        by a loop edge or a kidnap's end, or cut short by an escalated
        re-solve's end."""
        return self.timer.counts.get("poll_wake", 0)

    def _solve_to_host(self, problem: Problem, kw: dict, node_len: int,
                       edge_len: int) -> tuple[lm_ops.LMResult, int]:
        """The solve's host result, and the graph captures it took (a
        bucket that warmup() had not captured)."""
        with self._locked(self._device_lock, "device_lock_wait"):
            before = graphs.captures_on_this_thread()
            res = lm_ops.lm_solve(problem, **kw)
            with self.timer.phase("to_host"):
                res = _to_host(res, node_len, edge_len)
            captures = graphs.captures_on_this_thread() - before
        with self._locked(self.state_lock, "state_lock_wait"):
            self._warmed_buckets.add((problem.n_cap, problem.e_cap,
                                      self.config.solver.dtype))
        return res, captures

    def drain(self) -> None:
        """Checkpoint / shutdown / batch barrier: join a background
        escalation, so that its write-back has landed when this returns,
        and raise a background thread's stored failure."""
        t = self._bg_thread
        if t is not None:
            t.join()
            self._bg_thread = None
        self._raise_bg_error()

    def _raise_bg_error(self) -> None:
        """Raise, once, a kernel or device failure that a background thread
        (escalation, warmup) stored."""
        with self.state_lock:
            err, self._bg_error = self._bg_error, None
        if err is not None:
            raise err

    def _finish_solve(self, res: lm_ops.LMResult, problem: Problem, kw: dict,
                      node_len, edge_len, node_worlds, tid,
                      rec: timing.Record, build: dict) -> None:
        """Escalate a distressed result if the config says so, then write
        back. `res` is a host result (_to_host); `rec` the trigger's spans;
        `build` the problem build's, edge, poll and world entries of the
        trigger's solve_stats row, to which an inline escalation adds its
        rung_stats. A trigger with first contacts is not escalated (see
        the module note)."""
        escalated = False
        solver = self.config.solver
        if (solver.adaptive_fp64 and solver.dtype != "float64"
                and not build["first_contacts"]
                and lm_ops.needs_escalation(res, solver.escalate_rejects)):
            k = solver.escalate_rejects
            if self.config.stream.background_escalation:
                # serve the fp32 result now, re-solve in the background
                if self._start_escalation(problem, kw, k, node_len, edge_len,
                                          node_worlds, tid):
                    escalated = "pending"
            else:
                with self.timer.phase("fp64_escalation"):
                    res, escalated, rung_stats = lm_ops.escalate_resolve(
                        problem, kw, k, dispatch_lock=self._device_lock,
                        fp64_backend=solver.fp64_backend)
                    res = _to_host(res, node_len, edge_len)
                # the row's counts are the rung's; these are the ladder's
                build = dict(build, rung_stats=rung_stats)
        # the stats append and the poses change together under state_lock:
        # the stats length is part of the Composer's version stamp
        self.last_result = res
        with self._locked(self.state_lock, "state_lock_wait"):
            with self.timer.phase("write_back"):
                self._write_back(res, node_len, edge_len, node_worlds)
                self.solved_until = node_len - 1
            t_end = time.monotonic()
            self.solve_stats.append({
                "trigger": tid,
                "node_len": node_len,
                "edge_len": edge_len,
                "initial_cost": float(res.initial_cost),
                "final_cost": float(res.final_cost),
                "lm_iterations": int(res.iterations),
                "successful_steps": int(res.successful_steps),
                "cg_iterations": int(res.total_cg_iterations),
                "distress_rejects": int(res.distress_rejects),
                "fp64_escalated": escalated,
                "trigger_wall_ms": 1000.0 * (t_end - rec.t_start),
                **build,
                "t_start": rec.t_start, "t_end": t_end,
                "spans_ms": rec.spans_ms(),
                "lock_wait_ms": rec.total_ms("state_lock_wait",
                                             "device_lock_wait"),
                "launch_ms": rec.total_ms("launch"),
                "result_wait_ms": rec.total_ms("result_wait"),
            })
        if bool(res.converged):
            self.n_solve_convergences += 1
        self.prev_edge_len = edge_len
        self.prev_node_len = node_len
        self.timer.add("trigger_total", time.monotonic() - rec.t_start)
        self.status = 0

    def _write_back(self, res: lm_ops.LMResult, node_len, edge_len,
                    node_worlds) -> None:
        """Install solved poses and switches (caller holds state_lock);
        frozen and dead-zone nodes keep theirs."""
        q_new = res.q[:node_len].numpy()
        t_new = res.t[:node_len].numpy()
        active = (node_worlds[:node_len] >= 0) & ~self._opt_frozen[:node_len]
        self._opt_q[:node_len][active] = q_new[active]
        self._opt_t[:node_len][active] = t_new[active]
        self._switch[:edge_len] = res.switch[:edge_len].numpy()

    # ------------------------------------------------------------------
    # background escalated re-solve (stream.background_escalation)
    # ------------------------------------------------------------------

    def _start_escalation(self, problem, kw, k, node_len, edge_len,
                          node_worlds, tid) -> bool:
        """Start the escalated re-solve on a daemon thread, one at a time:
        while one is in flight, further distressed results are kept."""
        t = self._bg_thread
        if t is not None and t.is_alive():
            return False
        # if a set union lands while the re-solve runs, its poses are in a
        # pre-merge frame and writing them back would undo the re-basing
        setid_snapshot = dict(self.store.worlds.get_world_to_setid_map())
        t = threading.Thread(
            target=self._run_escalation,
            args=(problem, kw, k, node_len, edge_len, node_worlds, tid,
                  setid_snapshot, _on_stream(self.device)),
            name=f"kpg-escalate-{tid}", daemon=True)
        self._bg_thread = t
        t.start()
        return True

    def _run_escalation(self, problem, kw, k, node_len, edge_len,
                        node_worlds, tid, setid_snapshot, stream_ctx) -> None:
        t0 = time.perf_counter()
        try:
            with stream_ctx():
                res, rung, rung_stats = lm_ops.escalate_resolve(
                    problem, kw, k, dispatch_lock=self._device_lock,
                    fp64_backend=self.config.solver.fp64_backend)
                res = _to_host(res, node_len, edge_len)
        except Exception as e:
            # a failed kernel or device is raised on the solver loop; a
            # host rung's failure is logged and the fp32 result kept, as in
            # the reference engine
            log.exception("trigger %d: background escalation failed", tid)
            with self.state_lock:
                self.solve_stats.append({
                    "trigger": tid, "background_escalation": True,
                    "escalation_error": repr(e)})
                if _kernels.is_device_error(e):
                    self._bg_error = e
            return
        wall_ms = 1000.0 * (time.perf_counter() - t0)
        with self.state_lock:
            stale = (dict(self.store.worlds.get_world_to_setid_map())
                     != setid_snapshot)
            if not stale:
                self._write_back(res, node_len, edge_len, node_worlds)
                self.last_result = res
            self.solve_stats.append({
                "trigger": tid, "node_len": node_len, "edge_len": edge_len,
                "background_escalation": True, "escalated_rung": rung,
                "applied": not stale,
                "initial_cost": float(res.initial_cost),
                "final_cost": float(res.final_cost),
                "lm_iterations": int(res.iterations),
                "successful_steps": int(res.successful_steps),
                "cg_iterations": int(res.total_cg_iterations),
                "escalation_wall_ms": wall_ms,
                "rung_stats": rung_stats,
            })
        self.timer.add("fp64_escalation", wall_ms / 1000.0)

    def _set_initial_guesses(self, node_len: int, node_worlds: np.ndarray
                             ) -> dict:
        """Step 4 of the trigger: the 4-case initial-guess / re-basing table
        on (in_change_set, before_solvedUntil), vectorized. Returns the
        solve_stats entries rebased_nodes (case 1) and mapped_nodes (case
        4)."""
        store = self.store
        worlds = store.worlds
        su = self.solved_until
        su_world = int(node_worlds[su]) if node_len else 0
        if su_world < 0:
            su_world = -su_world - 1

        n_w = store.n_worlds()
        set_of = np.array(
            [worlds.find_setID_of_world_i(ww) for ww in range(n_w)],
            np.int64)
        q_sw_all = np.zeros((n_w, 4)); q_sw_all[:, 3] = 1.0
        t_sw_all = np.zeros((n_w, 3))
        q_ch_all = np.zeros((n_w, 4)); q_ch_all[:, 3] = 1.0
        t_ch_all = np.zeros((n_w, 3))
        changed = np.zeros(n_w, bool)
        for ww in range(n_w):
            sw_ = int(set_of[ww])
            if sw_ >= 0 and sw_ != ww:
                q_sw_all[ww], t_sw_all[ww] = \
                    worlds.get_pose_between_worlds(sw_, ww)
            if ww in self._changes_to_setid:
                changed[ww] = True
                old_sid, new_sid = self._changes_to_setid[ww]
                q_ch_all[ww], t_ch_all[ww] = \
                    worlds.get_pose_between_worlds(new_sid, old_sid)

        w = node_worlds[:node_len]
        wc = np.clip(w, 0, n_w - 1)
        valid = (w >= 0) & (set_of[wc] >= 0)
        before = np.arange(node_len) <= su
        in_change = changed[wc] & (w >= 0)

        _, vio_q_all, vio_t_all = store.node_arrays()
        vio_q_all, vio_t_all = vio_q_all[:node_len], vio_t_all[:node_len]
        opt_q = self._opt_q[:node_len]
        opt_t = self._opt_t[:node_len]

        with self._locked(self.state_lock, "state_lock_wait"):
            # case 1: solved nodes of a world whose setID changed -> re-base
            c1 = valid & before & in_change
            if c1.any():
                qn, tn = nse3.pose_mul(q_ch_all[wc[c1]], t_ch_all[wc[c1]],
                                       opt_q[c1], opt_t[c1])
                opt_q[c1] = nse3.quat_normalize(qn)
                opt_t[c1] = tn
            # case 2: solved, unchanged -> keep (except su == 0 bootstrap)
            if su == 0:
                c2 = valid & before & ~in_change
                opt_q[c2] = vio_q_all[c2]
                opt_t[c2] = vio_t_all[c2]
            # case 3: unsolved, same world as the watermark -> odometry
            # extrapolation w_T_last * (last_M_u)
            c3 = valid & ~before & (w == su_world)
            if c3.any():
                n3 = int(c3.sum())
                q_l, t_l = store.node_pose(su)
                q_li, t_li = nse3.pose_inv(q_l, t_l)
                q_d, t_d = nse3.pose_mul(
                    np.broadcast_to(q_li, (n3, 4)),
                    np.broadcast_to(t_li, (n3, 3)),
                    vio_q_all[c3], vio_t_all[c3])
                if self.node_pose_exists(su):
                    q_s, t_s = self._opt_q[su], self._opt_t[su]
                else:
                    q_s, t_s = q_l, t_l
                qn, tn = nse3.pose_mul(
                    np.broadcast_to(q_s, q_d.shape),
                    np.broadcast_to(t_s, t_d.shape), q_d, t_d)
                opt_q[c3] = nse3.quat_normalize(qn)
                opt_t[c3] = tn
            # case 4: unsolved, different world -> map into the set frame
            c4 = valid & ~before & (w != su_world)
            if c4.any():
                qn, tn = nse3.pose_mul(q_sw_all[wc[c4]], t_sw_all[wc[c4]],
                                       vio_q_all[c4], vio_t_all[c4])
                opt_q[c4] = nse3.quat_normalize(qn)
                opt_t[c4] = tn
        return dict(rebased_nodes=int(np.count_nonzero(c1)),
                    mapped_nodes=int(np.count_nonzero(c4)))

    def _prepare_solve(self, node_len, edge_len, node_worlds,
                       prior_idx, prior_q, prior_t, prior_w
                       ) -> Tuple[Problem, dict, dict]:
        """The trigger's Problem on the device, its lm_solve kwargs and the
        build's solve_stats entries: its wall time and the builds taken so
        far, full and delta."""
        cfg = self.config
        cap = cfg.capacity
        ea, eb, eq, et, ew, emask = (a[:edge_len]
                                     for a in self.store.edge_arrays())
        _, vio_q, vio_t = self.store.node_arrays()

        # dead-zone masking for edges
        loop_valid = emask.copy()
        if edge_len:
            loop_valid &= (node_worlds[ea] >= 0) & (node_worlds[eb] >= 0)

        if node_len > cap.max_nodes:
            raise RuntimeError(
                f"node capacity ceiling exceeded: {node_len} > "
                f"{cap.max_nodes} (CapacityConfig.max_nodes)")
        if edge_len > cap.max_edges:
            raise RuntimeError(
                f"edge capacity ceiling exceeded: {edge_len} > "
                f"{cap.max_edges} (CapacityConfig.max_edges)")
        n_cap, e_cap = self._cover(_bucket(node_len, cap.initial_nodes),
                                   _bucket(max(edge_len, 1),
                                           cap.initial_edges))
        p_cap = _bucket(max(len(prior_idx), 1), 16)

        tb = time.perf_counter()
        with self.timer.phase("problem_build"):
            problem = self._build(
                node_len, edge_len, node_worlds, prior_idx, prior_q, prior_t,
                prior_w, n_cap, e_cap, p_cap, ea, eb, eq, et, ew, loop_valid,
                vio_q[:node_len], vio_t[:node_len])
        build = {
            "problem_build_ms": 1000.0 * (time.perf_counter() - tb),
            "full_builds": self._builder.full_builds + self._scratch_builds,
            "delta_builds": self._builder.delta_builds,
        }

        if self.mesh is not None:
            problem = shard_problem(problem, self.mesh)
        kw = lm_ops.cfg_lm_kwargs(
            cfg.solver, residual_mode=cfg.residual.mode,
            use_switch=cfg.residual.use_switch_constraints)
        if kw["coarse_group"] is None:
            # structure-aware aggregate size from the host edge arrays,
            # sticky per capacity bucket (it changes results, so the choice
            # must not flip with every new edge); re-decided once when the
            # edge sample first becomes meaningful (>= 32 edges)
            cached = self._coarse_group_by_cap.get(n_cap)
            if cached is None or cached[1] < 32 <= edge_len:
                med = (coarse_ops.median_loop_offset(eb, ea, loop_valid)
                       if edge_len >= 32 else None)
                self._coarse_group_by_cap[n_cap] = (
                    coarse_ops.auto_coarse_group(n_cap, med), edge_len)
            kw["coarse_group"] = self._coarse_group_by_cap[n_cap][0]
        return problem, kw, build

    def _cover(self, n_cap: int, e_cap: int) -> Tuple[int, int]:
        """The box of a trigger of bucket (n_cap, e_cap): the bucket when
        it is in _warmed_buckets, else the smallest one there of the
        config's dtype that holds it, by (n_cap, e_cap), else the bucket
        (see the module note)."""
        dtype = self.config.solver.dtype
        with self._locked(self.state_lock, "state_lock_wait"):
            if (n_cap, e_cap, dtype) in self._warmed_buckets:
                return n_cap, e_cap
            return min(((kn, ke) for kn, ke, kd in self._warmed_buckets
                        if kd == dtype and kn >= n_cap and ke >= e_cap),
                       default=(n_cap, e_cap))

    def _build(self, node_len, edge_len, node_worlds, prior_idx, prior_q,
               prior_t, prior_w, n_cap, e_cap, p_cap, ea, eb, eq, et, ew,
               loop_valid, vio_q, vio_t):
        """The trigger's Problem on the engine's device: from the
        incremental builder under stream.incremental_build, else (and on a
        mesh, which re-shards every trigger's Problem) from scratch: the
        same Problem either way."""
        cfg = self.config
        kwargs = dict(
            q=self._opt_q[:node_len], t=self._opt_t[:node_len],
            vio_q=vio_q, vio_t=vio_t, node_valid=node_worlds >= 0,
            loop_pairs=(np.stack([ea, eb], -1) if edge_len
                        else np.zeros((0, 2), np.int64)),
            loop_q=eq, loop_t=et, loop_w=ew, loop_valid=loop_valid,
            switch=self._switch[:edge_len],
            prior_idx=np.asarray(prior_idx, np.int64),
            prior_q=np.asarray(prior_q).reshape(-1, 4),
            prior_t=np.asarray(prior_t).reshape(-1, 3),
            prior_w=np.asarray(prior_w),
            node_free=~self._opt_frozen[:node_len],
            n_cap=n_cap, e_cap=e_cap, p_cap=p_cap,
            dtype=np.float64 if cfg.solver.dtype == "float64" else np.float32,
            device=self.device)
        if cfg.stream.incremental_build and self.mesh is None:
            return self._builder.build(**kwargs)
        self._scratch_builds += 1
        return build_problem_np(
            fanout=cfg.residual.odometry_fanout,
            odo_decay=cfg.residual.odometry_decay,
            odo_yaw_sigma2=cfg.residual.odometry_yaw_sigma2, **kwargs)

    # ------------------------------------------------------------------
    # checkpoint-restore support
    # ------------------------------------------------------------------

    def load_state(self, opt_q: np.ndarray, opt_t: np.ndarray) -> None:
        """Install restored set-frame poses for the first len(opt_q) nodes
        and freeze them (the reference marks them constant, so the live
        session localizes against the frozen map)."""
        n = len(opt_q)
        self._grow_nodes(n)
        self._opt_q[:n] = opt_q
        self._opt_t[:n] = opt_t
        self._opt_frozen[:n] = True
        self._n_opt = max(self._n_opt, n)
        self.solved_until = n - 1
        self.prev_node_len = n

    # ------------------------------------------------------------------
    # start-up and the blocking loop
    # ------------------------------------------------------------------

    def warmup(self, max_nodes: int, max_edges: int,
               background: bool = False, proportional: bool = True) -> int:
        """Capture the solve's graphs for every capacity bucket of the
        reference's ladder up to the given sizes (_warmup_pairs;
        proportional=False takes every pair of the product), each bucket
        primed by one solve of a dummy graph through its replays, so that
        a stream's triggers capture nothing; warmup_stats gets a row per
        bucket. background=True captures the first bucket, the one a fresh
        stream solves in, before it returns, and the rest on a daemon
        thread in increasing bucket order, each under the device lock, so
        that a live trigger waits for at most one bucket's capture;
        warmup_join waits for them. Correctness never depends on warmup: a
        trigger whose bucket is not warmed solves in the smallest warmed
        bucket that holds it (the bucket cover, see the module note), or
        captures its own. On a mesh whose shards share one card the
        buckets are the mesh's (each dummy graph sharded over it). An
        eager engine (the CPU, a mesh over distinct cards) compiles
        nothing per bucket: it records the whole ladder for the cover and
        primes one solve at the ladder's first bucket (on the thread, with
        background).
        When the config can escalate to the host fp64 rung (adaptive_fp64
        on, fp64_backend not "tpu"), that rung is loaded on a thread of its
        own meanwhile (the reference's engine.py:911-937), so that the
        first escalation does not pay for it; warmup_join waits for it too.
        Returns the number of buckets warmed (scheduled, with background)."""
        cap = self.config.capacity
        if max_nodes > cap.max_nodes or max_edges > cap.max_edges:
            raise ValueError(
                f"warmup({max_nodes}, {max_edges}) exceeds the capacity "
                f"ceilings ({cap.max_nodes}, {cap.max_edges})")
        self._start_host_rung_warm()
        pairs = _warmup_pairs(cap, max_nodes, max_edges, proportional)
        if self._graphed():
            now = pairs[:1]
        else:
            # nothing to capture: the ladder goes into the set as the
            # reference's compiled ladder does, and one solve primes
            with self.state_lock:
                self._warmed_buckets.update(
                    (n, e, self.config.solver.dtype) for n, e in pairs)
            pairs, now = pairs[:1], []
        if not background:
            now = pairs
        for pair in now:
            self._warm_one(*pair)
        rest = pairs[len(now):]
        if rest:
            t = threading.Thread(target=self._warm_in_background,
                                 args=(rest, _on_stream(self.device)),
                                 name="kpg-warmup", daemon=True)
            self._warmup_thread = t
            t.start()
        return len(pairs)

    def warmup_join(self, timeout: Optional[float] = None) -> bool:
        """Wait for a background warmup and the host rung's load; True once
        both have finished. Raises what the device warmup raised."""
        end = None if timeout is None else time.monotonic() + timeout
        alive = False
        for t in (self._warmup_thread, self._host_rung_thread):
            if t is not None:
                t.join(None if end is None
                       else max(0.0, end - time.monotonic()))
                alive = alive or t.is_alive()
        if not alive:
            self._raise_bg_error()
        return not alive

    def _start_host_rung_warm(self) -> None:
        solver, res_cfg = self.config.solver, self.config.residual
        if not solver.adaptive_fp64 or solver.fp64_backend == "tpu":
            return
        gate = {"residual_mode": res_cfg.mode,
                "use_switch": res_cfg.use_switch_constraints}
        t = threading.Thread(target=self._warm_host_rung, args=(gate,),
                             name="kpg-host-rung-warmup", daemon=True)
        self._host_rung_thread = t
        t.start()

    @staticmethod
    def _warm_host_rung(gate: dict) -> None:
        """Best effort: a rung that cannot load is reported by the first
        escalation that needs it."""
        from solve_keyframe_pose_graph_tpu_torch.solver import cpu_rung
        try:
            cpu_rung.available(gate)
        except Exception:
            log.warning("loading the host fp64 rung failed", exc_info=True)

    def _warm_in_background(self, pairs, stream_ctx) -> None:
        try:
            for pair in pairs:
                self._warm_one(*pair, stream_ctx)
        except BaseException as e:
            log.exception("background warmup failed")
            with self.state_lock:
                self._bg_error = e

    def _graphed(self) -> bool:
        """Whether this engine's solves replay captured graphs: on a card,
        without a mesh or on a mesh whose shards all sit on it."""
        return graphs.serves_devices(
            self.mesh.devices if self.mesh is not None else (self.device,))

    def _warm_one(self, n_cap: int, e_cap: int,
                  stream_ctx=contextlib.nullcontext) -> None:
        """Capture (on a graphed engine) and prime one bucket with a dummy
        graph at the config's solver settings and the size rule's coarse
        group; its warmup_stats row."""
        from solve_keyframe_pose_graph_tpu_torch.ops import (
            band_matvec, smallinv,
        )

        cfg = self.config
        if self.device.type == "cuda":
            for name, entries in (("band_matvec", band_matvec._ENTRIES),
                                  ("gj_inv", smallinv._ENTRIES)):
                _kernels.load(name, entries)
        g = synthetic.circle_graph(n_nodes=min(64, n_cap),
                                   n_loops=min(8, e_cap), seed=0)
        # priming only: the outcome is irrelevant and must not escalate
        warm_solver = dataclasses.replace(cfg.solver, adaptive_fp64=False)
        kw = lm_ops.cfg_lm_kwargs(
            warm_solver, residual_mode=cfg.residual.mode,
            use_switch=cfg.residual.use_switch_constraints)
        if kw["coarse_group"] is None:
            kw["coarse_group"] = coarse_ops.auto_coarse_group(n_cap)
        row = dict(n_cap=n_cap, e_cap=e_cap, capture_s=None,
                   instantiate_s=None, pool_mb=None)
        with stream_ctx():
            with self._device_lock:
                problem = build_problem_np(
                    q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t,
                    node_valid=np.ones(g.n_nodes, bool),
                    loop_pairs=g.loop_pairs, loop_q=g.loop_q,
                    loop_t=g.loop_t, loop_w=g.loop_w,
                    loop_valid=np.ones(g.n_loops, bool),
                    switch=np.full(g.n_loops, cfg.residual.switch_init),
                    prior_idx=np.array([0]), prior_q=g.vio_q[:1],
                    prior_t=g.vio_t[:1], prior_w=np.array([1.1]),
                    n_cap=n_cap, e_cap=e_cap, p_cap=16,
                    fanout=cfg.residual.odometry_fanout,
                    dtype=(np.float64 if cfg.solver.dtype == "float64"
                           else np.float32),
                    device=self.device)
                if self.mesh is not None:
                    problem = shard_problem(problem, self.mesh)
                if graphs.serves(problem):
                    rec = graphs.prepare(problem, **kw)
                    row.update(
                        capture_s=rec["warmup_s"] + rec["capture_s"],
                        instantiate_s=rec["instantiate_s"],
                        pool_mb=rec["pool_bytes"] / 2 ** 20,
                        captured=rec["built"])
            t0 = time.perf_counter()
            with self._device_lock:
                float(lm_ops.lm_solve(problem, **kw).final_cost)
            row["first_replay_s"] = time.perf_counter() - t0
        with self.state_lock:
            self.warmup_stats.append(row)
            self._warmed_buckets.add((n_cap, e_cap, cfg.solver.dtype))

    def run(self, poll_hz: Optional[float] = None, stop_when=None) -> None:
        """Blocking trigger loop (the reference thread's ros::Rate loop,
        whose fixed sleep becomes a wait for work). After a trigger that
        fires nothing the loop waits at most 1 / poll_hz (_wait_for_work):
        the phase poll_sleep (poll_sleeps, poll_sleep_s); a wait that ends
        before the period is counted as poll_wake too (poll_wakes, its
        seconds under the same name). The store's wake is cleared before
        each trigger, so an edge that lands while the trigger runs ends
        the wait after it at once. Every trigger runs here, on the loop's
        thread."""
        period = 1.0 / (poll_hz or self.config.stream.trigger_poll_hz)
        wake = self.store.wake
        while True:
            if stop_when is not None and stop_when():
                return
            wake.clear()
            if self.trigger():
                continue
            t0 = time.monotonic()
            with self.timer.phase("poll_sleep"):
                woke = self._wait_for_work(period)
            if woke:
                self.timer.add("poll_wake", time.monotonic() - t0)

    def _wait_for_work(self, timeout: float) -> bool:
        """run()'s wait after a trigger that fired nothing, at most
        `timeout` seconds; True where it ended before. While a gate of the
        trigger is shut (an escalated re-solve in flight, the robot
        kidnapped) new edges would be refused, so their wakes do not end
        the wait: it lasts until that gate opens (the re-solve's thread
        ends, the kidnap ends), and kidnap_polls keeps the poll's rate.
        Otherwise it lasts until the store's wake is set."""
        store = self.store
        end = time.monotonic() + timeout
        gated = False
        while True:
            left = end - time.monotonic()
            if left <= 0:
                return False
            bg = self._bg_thread
            if bg is not None and bg.is_alive():
                gated = True
                bg.join(left)
            elif store.current_kidnap_status:
                gated = True
                store.wake.clear()
                # the kidnap's end sets the wake: read the status after
                # the clear, so that an end between them is not lost
                if store.current_kidnap_status:
                    store.wake.wait(left)
            else:
                # a gate that opened in this wait: the edges it held back
                # may have set the wake before the trigger's clear
                return gated or store.wake.wait(left)

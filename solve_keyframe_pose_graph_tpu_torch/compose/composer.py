"""Composer: corrected-trajectory assembly and checkpoint (counterpart of
solve_keyframe_pose_graph_tpu/compose/composer.py, carried over unchanged
apart from the engine type; it is host numpy).

assemble() fuses solver output and raw odometry into the publishable
corrected trajectory, as the reference's pose_assember_thread:

  * i <= solvedUntil: solver pose if it exists, else raw odometry; nodes in
    kidnap dead zones (world id < 0) are chained from the last pose of the
    previous world by the raw odometry delta;
  * i >  solvedUntil: warm extrapolation w_T_last * (last_M_i) from the
    solved watermark, with set-frame re-basing ws_T_w * w_T_c for
    odometry-sourced poses whose world was merged.

imu_propagate() is the 200 Hz low-latency serving path: compose the newest
IMU odometry onto the latest corrected camera pose through the imu<->cam
extrinsic.

save_state_to_disk()/load_state_from_disk() write/read the reference's
solved_posegraph.json checkpoint schema: {SolvedPoseGraph (per-node ws_T_c
in the 4x4-CSV {rows, cols, data} codec, worldID, setID_of_worldID,
stampNSec, seq), KidnapTimestamps, WorldsData}.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.graph.worlds import WorldRegistry
from solve_keyframe_pose_graph_tpu_torch.solver.engine import SolverEngine
from solve_keyframe_pose_graph_tpu_torch.utils import nse3


@dataclasses.dataclass
class ComposedTrajectory:
    """The deep-copied snapshot the reference keeps in global_jmb/global_lmb
    (Composer.cpp:216-254)."""

    q: np.ndarray                     # (N,4) corrected poses, flat
    t: np.ndarray                     # (N,3)
    world_of: np.ndarray              # (N,) world id per node
    per_world: Dict[int, List[int]]   # world id -> node indices (jmb)
    latest_pose_worldid: int
    solved_until: int
    # incremental-protocol stamp: changes whenever a solve lands or worlds
    # merge. Stamped INSIDE assemble() under engine.state_lock so the served
    # version is always consistent with the pose snapshot (a version
    # computed at query time from live engine state could be newer than the
    # snapshot, making clients keep a stale prefix).
    version: str = ""

    def world_polyline(self, world_id: int) -> np.ndarray:
        idx = self.per_world.get(world_id, [])
        return self.t[idx]


class Composer:
    def __init__(self, store: GraphStore, engine: SolverEngine):
        self.store = store
        self.engine = engine
        self.latest: Optional[ComposedTrajectory] = None

    # ------------------------------------------------------------------
    # pose assembly (Composer.cpp:10-263)
    # ------------------------------------------------------------------

    def assemble(self) -> Optional[ComposedTrajectory]:
        # engine.state_lock: consistent snapshot of opt poses + watermark
        # while the solver thread writes back (see SolverEngine.state_lock)
        with self.engine.state_lock:
            return self._assemble_vectorized()

    def assemble_reference(self) -> Optional[ComposedTrajectory]:
        """Literal per-node transcription of pose_assember_thread
        (Composer.cpp:10-263). O(N) Python — kept as the differential-test
        oracle for the vectorized assembly (tests/test_composer.py)."""
        with self.engine.state_lock:
            return self._assemble_loop()

    def _assemble_vectorized(self) -> Optional[ComposedTrajectory]:
        """Batched assembly: same 4 regimes as the reference loop, expressed
        as masked batched SE(3) ops (nse3 is fp64 numpy, matching the
        scalar path bit-for-bit). Dead zones are handled per zone — each
        zone's nodes share one anchor (the last composed pose of the
        previous world), so the chain is one batched composition."""
        store, eng = self.store, self.engine
        n = store.node_len
        if n == 0:
            return None
        worlds = store.worlds
        su = eng.solved_until
        w = store.node_worlds()[:n]
        su_world = int(w[su])

        ts_, q_vio_full, t_vio_full = store.node_arrays()
        q_vio = q_vio_full[:n]
        t_vio = t_vio_full[:n]
        q_out = q_vio.copy()
        t_out = t_vio.copy()

        # per-world LUTs: setID and ws_T_w (set frame <- world frame)
        n_w = store.n_worlds()
        set_of = np.asarray(
            [worlds.find_setID_of_world_i(ww) for ww in range(n_w)],
            np.int64)
        q_sw = np.zeros((n_w, 4)); q_sw[:, 3] = 1.0
        t_sw = np.zeros((n_w, 3))
        rebasable = np.zeros(n_w, bool)
        for ww in range(n_w):
            sid = int(set_of[ww])
            if sid >= 0 and sid != ww and worlds.is_exist(sid, ww):
                rebasable[ww] = True
                q_sw[ww], t_sw[ww] = worlds.get_pose_between_worlds(sid, ww)

        idx = np.arange(n)
        before = idx <= su
        alive = w >= 0
        wc = np.clip(w, 0, max(n_w - 1, 0))

        # regime 1: solved prefix, live worlds -> solver pose if it exists
        # (index gathers: the engine's opt arrays may be shorter than n
        # before its first trigger grows them)
        r1 = np.nonzero(before & alive & (idx < eng._n_opt))[0]
        q_out[r1] = eng._opt_q[r1]
        t_out[r1] = eng._opt_t[r1]
        # (solved prefix without a solver pose keeps the vio init)

        from_mgr = np.zeros(n, bool)
        if su == 0:
            from_mgr = ~before
        else:
            # regime 2: unsolved suffix, watermark world -> extrapolate
            r2 = ~before & alive & (w == su_world)
            if r2.any():
                if eng.node_pose_exists(su):
                    q_anchor, t_anchor = eng.get_node_pose(su)
                else:
                    q_anchor, t_anchor = store.node_pose(su)
                ql, tl = store.node_pose(su)
                qinv, tinv = nse3.pose_inv(ql, tl)
                qd, td = nse3.pose_mul(
                    np.broadcast_to(qinv, (int(r2.sum()), 4)),
                    np.broadcast_to(tinv, (int(r2.sum()), 3)),
                    q_vio[r2], t_vio[r2])
                qn, tn = nse3.pose_mul(
                    np.broadcast_to(q_anchor, qd.shape),
                    np.broadcast_to(t_anchor, td.shape), qd, td)
                q_out[r2], t_out[r2] = qn, tn
            # regime 3: unsolved suffix, other live world -> vio pose
            from_mgr = ~before & alive & (w != su_world)

        # set-frame re-basing for odometry-sourced suffix poses whose world
        # was merged (Composer.cpp:168-188)
        r4 = from_mgr & alive & rebasable[wc]
        if r4.any():
            qn, tn = nse3.pose_mul(q_sw[wc[r4]], t_sw[wc[r4]],
                                   q_out[r4], t_out[r4])
            q_out[r4], t_out[r4] = qn, tn

        # dead zones: chain from the last composed pose of the previous
        # world by raw-odometry delta (Composer.cpp:84-95). Zones are
        # processed per world id; each anchor pose was composed above
        # (previous worlds never fall in a later zone). Bootstrap quirk:
        # when su == 0 the scalar path's `su == 0` branch catches SUFFIX
        # dead-zone nodes first, leaving them at raw VIO — only prefix
        # nodes chain in that case.
        chainable = before | (su > 0)
        for dz in sorted(set(w[w < 0].tolist())):
            zone = (w == dz) & chainable
            if not zone.any():
                continue
            prev_w = -dz - 1
            members = np.nonzero(np.asarray(w) == prev_w)[0]
            assert len(members), f"no composed poses yet for world {prev_w}"
            j = int(members[-1])
            last_idx = store.nodeidx_of_world_i_ended(prev_w)
            ql, tl = store.node_pose(last_idx)
            qinv, tinv = nse3.pose_inv(ql, tl)
            m = int(zone.sum())
            qd, td = nse3.pose_mul(
                np.broadcast_to(qinv, (m, 4)), np.broadcast_to(tinv, (m, 3)),
                q_vio[zone], t_vio[zone])
            qn, tn = nse3.pose_mul(
                np.broadcast_to(q_out[j], (m, 4)),
                np.broadcast_to(t_out[j], (m, 3)), qd, td)
            q_out[zone], t_out[zone] = qn, tn

        per_world: Dict[int, List[int]] = {
            int(ww): np.nonzero(w == ww)[0].tolist()
            for ww in np.unique(w)
        }
        comp = ComposedTrajectory(
            q=q_out, t=t_out, world_of=w, per_world=per_world,
            latest_pose_worldid=int(w[-1]), solved_until=su,
            version=self._version(),
        )
        self.latest = comp
        return comp

    def _version(self) -> str:
        """Snapshot stamp; callers hold engine.state_lock, under which
        write_back + solve_stats append are atomic (engine._finish_solve)."""
        return f"{len(self.engine.solve_stats)}:{self.store.n_worlds()}"

    def _assemble_loop(self) -> Optional[ComposedTrajectory]:
        store, eng = self.store, self.engine
        n = store.node_len
        if n == 0:
            return None
        worlds = store.worlds
        su = eng.solved_until
        node_worlds = store.node_worlds()
        su_world = int(node_worlds[su])

        q_out = np.zeros((n, 4)); q_out[:, 3] = 1.0
        t_out = np.zeros((n, 3))
        per_world: Dict[int, List[int]] = {}
        latest_world = -1

        def last_pose_of_world(w: int) -> Tuple[np.ndarray, np.ndarray]:
            idxs = per_world.get(w, [])
            assert idxs, f"no composed poses yet for world {w}"
            j = idxs[-1]
            return q_out[j], t_out[j]

        for i in range(n):
            w_i = int(node_worlds[i])
            set_i = worlds.find_setID_of_world_i(w_i)

            if i <= su:
                if w_i >= 0:
                    if eng.node_pose_exists(i):
                        qc, tc = eng.get_node_pose(i)
                    else:
                        qc, tc = store.node_pose(i)
                else:
                    # kidnap dead zone: chain from the last pose of the
                    # previous world by odometry delta (Composer.cpp:84-95)
                    prev_w = -w_i - 1
                    last_idx = store.nodeidx_of_world_i_ended(prev_w)
                    q_last, t_last = last_pose_of_world(prev_w)
                    ql, tl = store.node_pose(last_idx)
                    qi_, ti_ = store.node_pose(i)
                    qinv, tinv = nse3.pose_inv(ql, tl)
                    qd, td = nse3.pose_mul(qinv, tinv, qi_, ti_)
                    qc, tc = nse3.pose_mul(q_last, t_last, qd, td)
            else:
                from_mgr = False
                if su == 0:
                    qc, tc = store.node_pose(i)
                    from_mgr = True
                elif w_i >= 0 and w_i == su_world:
                    # watermark extrapolation
                    if eng.node_pose_exists(su):
                        q_last, t_last = eng.get_node_pose(su)
                    else:
                        q_last, t_last = store.node_pose(su)
                    ql, tl = store.node_pose(su)
                    qi_, ti_ = store.node_pose(i)
                    qinv, tinv = nse3.pose_inv(ql, tl)
                    qd, td = nse3.pose_mul(qinv, tinv, qi_, ti_)
                    qc, tc = nse3.pose_mul(q_last, t_last, qd, td)
                elif w_i >= 0:
                    qc, tc = store.node_pose(i)
                    from_mgr = True
                else:
                    prev_w = -w_i - 1
                    last_idx = store.nodeidx_of_world_i_ended(prev_w)
                    q_last, t_last = last_pose_of_world(prev_w)
                    ql, tl = store.node_pose(last_idx)
                    qi_, ti_ = store.node_pose(i)
                    qinv, tinv = nse3.pose_inv(ql, tl)
                    qd, td = nse3.pose_mul(qinv, tinv, qi_, ti_)
                    qc, tc = nse3.pose_mul(q_last, t_last, qd, td)

                # set-frame re-basing for odometry-sourced poses of merged
                # worlds (Composer.cpp:168-188)
                if from_mgr and w_i != set_i and w_i >= 0:
                    if worlds.is_exist(set_i, w_i):
                        q_sw, t_sw = worlds.get_pose_between_worlds(set_i, w_i)
                        qc, tc = nse3.pose_mul(q_sw, t_sw, qc, tc)

            q_out[i] = qc
            t_out[i] = tc
            per_world.setdefault(w_i, []).append(i)
            latest_world = w_i

        comp = ComposedTrajectory(
            q=q_out, t=t_out, world_of=node_worlds, per_world=per_world,
            latest_pose_worldid=latest_world, solved_until=su,
            version=self._version(),
        )
        self.latest = comp
        return comp

    # ------------------------------------------------------------------
    # low-latency serving (Composer.cpp:266-278, 848-943)
    # ------------------------------------------------------------------

    def last_known_camerapose(self):
        """(node idx, q, t, stamp_ns) of the newest composed pose."""
        comp = self.latest
        if comp is None or len(comp.t) == 0:
            return -1, None, None, None
        i = len(comp.t) - 1
        return i, comp.q[i], comp.t[i], self.store.node_timestamp(i)

    def imu_propagate(self, q_w_imucurr, t_w_imucurr):
        """200 Hz path: wf_T_imucurr =
        (wf_T_camlast * cam_T_imu) * (w_T_imulast^-1 * w_T_imucurr)."""
        store = self.store
        idx, q_cam, t_cam, _ = self.last_known_camerapose()
        if idx < 0 or store.imu_T_cam_q is None:
            return None
        q_ic, t_ic = store.imu_T_cam_q, store.imu_T_cam_t
        q_ci, t_ci = nse3.pose_inv(q_ic, t_ic)
        # w_T_imulast = w_T_camlast(odometry) * cam_T_imu
        q_n, t_n = store.node_pose(idx)
        q_wil, t_wil = nse3.pose_mul(q_n, t_n, q_ci, t_ci)
        qi, ti = nse3.pose_inv(q_wil, t_wil)
        q_rel, t_rel = nse3.pose_mul(qi, ti, q_w_imucurr, t_w_imucurr)
        q_base, t_base = nse3.pose_mul(q_cam, t_cam, q_ci, t_ci)
        return nse3.pose_mul(q_base, t_base, q_rel, t_rel)

    # ------------------------------------------------------------------
    # corrected loop-edge endpoints (loopedge_publish_thread, :649-730)
    # ------------------------------------------------------------------

    def corrected_loop_edges(self):
        """(E,3) x2 endpoint positions + switch values for viz/diagnostics."""
        comp = self.latest
        if comp is None:
            return None
        store, eng = self.store, self.engine
        e = store.edge_len
        p0 = np.zeros((e, 3)); p1 = np.zeros((e, 3))
        sw = np.zeros(e)
        for k in range(e):
            a, b = store.edge_idx_info(k)
            if a < len(comp.t) and b < len(comp.t):
                p0[k] = comp.t[a]
                p1[k] = comp.t[b]
            sw[k] = eng.get_switch(k) if k < eng._n_switch else 0.99
        return p0, p1, sw

    # ------------------------------------------------------------------
    # checkpoint (Composer.cpp:952-1177)
    # ------------------------------------------------------------------

    def save_state_to_disk(self, save_dir: str) -> str:
        store, eng = self.store, self.engine
        if hasattr(eng, "drain"):
            eng.drain()          # barrier for an in-flight async solve
        os.makedirs(save_dir, exist_ok=True)
        # force end-of-world so a future session starts a fresh world
        # (Composer.cpp:969-975)
        if not store.current_kidnap_status:
            store.mark_as_kidnapped_and_signal_end_of_world()

        comp = self.assemble()
        worlds = store.worlds
        pose_graph = []
        for i in range(store.node_len):
            w_i = int(comp.world_of[i])
            T = nse3.pose_to_matrix(comp.q[i], comp.t[i])
            pose_graph.append({
                "w_T_c": _matrix_json(T),
                "worldID": w_i,
                "setID_of_worldID": worlds.find_setID_of_world_i(w_i),
                "stampNSec": store.node_timestamp(i),
                "seq": i,
            })
        obj = {
            "SolvedPoseGraph": pose_graph,
            "KidnapTimestamps": store.kidnap_data_to_json(),
            "WorldsData": worlds.to_json(),
        }
        path = os.path.join(save_dir, "solved_posegraph.json")
        with open(path, "w") as f:
            json.dump(obj, f, indent=4)
        return path

    def load_state_from_disk(self, load_dir: str) -> bool:
        """Restore order mirrors Composer::loadStateFromDisk (:1109-1177):
        Worlds -> kidnap data -> solved poses -> engine.load_state. Restored
        node poses are re-based into their own world frame for the store
        (w_T_c = w_T_ws * ws_T_c, NodeDataManager.cpp:1040-1053) and the
        set-frame poses are installed frozen in the engine."""
        store, eng = self.store, self.engine
        path = os.path.join(load_dir, "solved_posegraph.json")
        if not os.path.exists(path):
            return False
        with open(path) as f:
            obj = json.load(f)

        store.worlds = WorldRegistry.from_json(obj["WorldsData"])
        store.load_kidnap_data_from_json(obj["KidnapTimestamps"])

        nodes = obj["SolvedPoseGraph"]
        ws_q = np.zeros((len(nodes), 4)); ws_q[:, 3] = 1.0
        ws_t = np.zeros((len(nodes), 3))
        for i, nd in enumerate(nodes):
            T = _matrix_from_json(nd["w_T_c"])
            q_ws, t_ws = nse3.matrix_to_pose(T)   # actually ws_T_c
            ws_q[i], ws_t[i] = q_ws, t_ws
            w_id = int(nd["worldID"])
            set_id = int(nd["setID_of_worldID"])
            q_own, t_own = q_ws, t_ws
            if w_id >= 0 and w_id != set_id and store.worlds.is_exist(w_id, set_id):
                q_sw, t_sw = store.worlds.get_pose_between_worlds(w_id, set_id)
                q_own, t_own = nse3.pose_mul(q_sw, t_sw, q_ws, t_ws)
            store.add_node(int(nd["stampNSec"]), q_own, t_own)

        eng.load_state(ws_q, ws_t)
        eng.prev_edge_len = store.edge_len
        return True


def _matrix_json(T: np.ndarray) -> dict:
    """RawFileIO::eigen_matrix_to_json codec: {rows, cols, data} with
    ', '-separated cols and newline-separated rows (RawFileIO.h:91-103)."""
    return {
        "rows": T.shape[0],
        "cols": T.shape[1],
        "data": "\n".join(", ".join(repr(float(v)) for v in row) for row in T),
    }


def _matrix_from_json(obj: dict) -> np.ndarray:
    rows, cols = int(obj["rows"]), int(obj["cols"])
    out = np.zeros((rows, cols))
    lines = [ln for ln in obj["data"].split("\n") if ln.strip()]
    assert len(lines) == rows
    for r, ln in enumerate(lines):
        vals = [v for v in ln.split(",") if v.strip()]
        out[r] = [float(v) for v in vals]
    return out

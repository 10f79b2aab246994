"""GraphStore — the framework's ground-truth input state (counterpart of
solve_keyframe_pose_graph_tpu/graph/store.py, the same code)
(NodeDataManager equivalent, /root/reference/src/NodeDataManager.{h,cpp}).

Owns, append-only and host-side (SoA numpy with capacity doubling):
  * per-keyframe VIO pose (q xyzw, t), timestamp (int ns), 6x6 covariance
  * loop-closure edges: (idx_a, idx_b), observed b_T_a, weight, description
  * kidnap intervals + current kidnap status, driving the WorldRegistry
  * imu <-> camera extrinsic

Differences from the reference, by design:
  * no mutexes — the streaming engine consumes immutable snapshots
    (functional arrays make the reference's deliberate read-during-solve
    race, PoseGraphSLAM.cpp:1893-1902, unnecessary)
  * timestamp -> index matching is O(log N) binary search instead of the
    reference's O(N) linear scan hot spot (NodeDataManager.cpp:274-299),
    same 1 ms tolerance and same first-match semantics
  * JSON save/load keeps the reference's log_posegraph.json schema
    (NodeDataManager.cpp:503-628) so recorded fixtures interoperate.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from solve_keyframe_pose_graph_tpu_torch.graph.worlds import (
    WorldRegistry, _csv_to_matrix,
)
from solve_keyframe_pose_graph_tpu_torch.utils import nse3

MATCH_TOL_NS = 1_000_000  # 1 ms (NodeDataManager.cpp:288)


class GraphStore:
    def __init__(self, initial_capacity: int = 1024):
        cap = int(initial_capacity)
        self._n = 0
        self._ts = np.zeros(cap, np.int64)
        self._q = np.zeros((cap, 4)); self._q[:, 3] = 1.0
        self._t = np.zeros((cap, 3))
        self._cov = np.zeros((cap, 6, 6))

        self._e = 0
        ecap = max(cap // 4, 16)
        self._e_a = np.zeros(ecap, np.int64)       # current (paur.first)
        self._e_b = np.zeros(ecap, np.int64)       # previous (paur.second)
        self._e_q = np.zeros((ecap, 4)); self._e_q[:, 3] = 1.0
        self._e_t = np.zeros((ecap, 3))
        self._e_w = np.zeros(ecap)
        self._e_desc: List[str] = []
        self.edge_mask: List[bool] = []            # ablation support
                                                   # (NodeDataManager.h:118)

        self.kidnap_starts: List[int] = []         # ns
        self.kidnap_ends: List[int] = []
        self.current_kidnap_status = False

        self.worlds = WorldRegistry()

        self.imu_T_cam_q: Optional[np.ndarray] = None
        self.imu_T_cam_t: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    # capacity
    # ------------------------------------------------------------------

    def _grow_nodes(self):
        cap = len(self._ts) * 2
        self._ts = np.resize(self._ts, cap)
        q = np.zeros((cap, 4)); q[:, 3] = 1.0
        q[: self._n] = self._q[: self._n]
        self._q = q
        t = np.zeros((cap, 3)); t[: self._n] = self._t[: self._n]
        self._t = t
        c = np.zeros((cap, 6, 6)); c[: self._n] = self._cov[: self._n]
        self._cov = c

    def _grow_edges(self):
        cap = len(self._e_a) * 2
        for name in ("_e_a", "_e_b", "_e_w"):
            arr = getattr(self, name)
            new = np.zeros(cap, arr.dtype)
            new[: self._e] = arr[: self._e]
            setattr(self, name, new)
        q = np.zeros((cap, 4)); q[:, 3] = 1.0
        q[: self._e] = self._e_q[: self._e]
        self._e_q = q
        t = np.zeros((cap, 3)); t[: self._e] = self._e_t[: self._e]
        self._e_t = t

    # ------------------------------------------------------------------
    # ingest callbacks (NodeDataManager.cpp:23-215, 763-792)
    # ------------------------------------------------------------------

    def add_node(self, t_ns: int, q, t, cov=None) -> int:
        """camera_pose_callback: append a keyframe VIO pose. The first pose
        starts world 0; the first pose after load/unkidnap starts a new
        world (NodeDataManager.cpp:63-95)."""
        t_ns = int(t_ns)
        if self._n > 0:
            assert t_ns >= int(self._ts[self._n - 1]), (
                "non-monotonic node timestamp"
            )
        if self._n == len(self._ts):
            self._grow_nodes()
        i = self._n
        self._ts[i] = t_ns
        self._q[i] = nse3.quat_normalize(np.asarray(q, np.float64))
        self._t[i] = np.asarray(t, np.float64)
        if cov is not None:
            self._cov[i] = np.asarray(cov, np.float64)
        self._n += 1

        if len(self.worlds.world_start_stamps) == 0:
            # very first pose: world-0 begins
            self.worlds.world_starts(t_ns)
            self.current_kidnap_status = False
        return i

    def find_indexof_node(self, t_ns: int) -> int:
        """Timestamp -> node index with 1 ms tolerance, first match
        (binary search; semantics of NodeDataManager.cpp:274-299)."""
        t_ns = int(t_ns)
        ts = self._ts[: self._n]
        lo = int(np.searchsorted(ts, t_ns - MATCH_TOL_NS, side="left"))
        if lo < self._n and abs(int(ts[lo]) - t_ns) < MATCH_TOL_NS:
            return lo
        return -1

    def add_loop_edge(self, t_ns_a: int, t_ns_b: int, q_b_T_a, t_b_T_a,
                      weight: float, description: str = "") -> Optional[int]:
        """loopclosure_pose_callback: match both timestamps to node indices
        (non-fatal skip on failure, NodeDataManager.cpp:181-185), append
        edge arrays. Edge convention: pose of a as observed from b
        (msg/LoopEdge.msg pose_1T0)."""
        ia = self.find_indexof_node(t_ns_a)
        ib = self.find_indexof_node(t_ns_b)
        if ia < 0 or ib < 0:
            return None
        return self.add_loop_edge_by_index(ia, ib, q_b_T_a, t_b_T_a, weight,
                                           description)

    def add_loop_edge_by_index(self, ia: int, ib: int, q_b_T_a, t_b_T_a,
                               weight: float, description: str = ""
                               ) -> Optional[int]:
        # bounds check both endpoints: a corrupt checkpoint / g2o file must
        # not plant an index that blows up later inside the jitted solve
        if not (0 <= ia < self._n and 0 <= ib < self._n):
            return None
        if self._e == len(self._e_a):
            self._grow_edges()
        e = self._e
        self._e_a[e] = ia
        self._e_b[e] = ib
        self._e_q[e] = nse3.quat_normalize(np.asarray(q_b_T_a, np.float64))
        self._e_t[e] = np.asarray(t_b_T_a, np.float64)
        self._e_w[e] = float(weight)
        self._e_desc.append(description)
        self.edge_mask.append(True)
        self._e += 1
        return e

    def set_extrinsic(self, q, t) -> None:
        """extrinsic_cam_imu_callback (NodeDataManager.cpp:192-215)."""
        self.imu_T_cam_q = nse3.quat_normalize(np.asarray(q, np.float64))
        self.imu_T_cam_t = np.asarray(t, np.float64)

    # ------------------------------------------------------------------
    # kidnap state machine (NodeDataManager.cpp:763-852)
    # ------------------------------------------------------------------

    def mark_as_kidnapped(self, t_ns: int) -> None:
        assert not self.current_kidnap_status, (
            "can mark as kidnapped only when not kidnapped"
        )
        self.current_kidnap_status = True
        self.kidnap_starts.append(int(t_ns))
        self.worlds.world_ends(int(t_ns))

    def mark_as_unkidnapped(self, t_ns: int) -> None:
        assert self.current_kidnap_status, (
            "can mark as unkidnapped only when kidnapped"
        )
        self.current_kidnap_status = False
        self.kidnap_ends.append(int(t_ns))
        self.worlds.world_starts(int(t_ns))

    def kidnap_indicator(self, t_ns: int, frame_id: str) -> None:
        """rcvd_kidnap_indicator_callback wire format: frame_id is
        'kidnapped' or 'unkidnapped' (NodeDataManager.cpp:762-791). This is
        also the fault-injection API (SURVEY.md section 4)."""
        if frame_id == "kidnapped":
            self.mark_as_kidnapped(t_ns)
        elif frame_id == "unkidnapped":
            self.mark_as_unkidnapped(t_ns)
        else:
            raise ValueError(f"kidnap indicator frame_id must be "
                             f"'kidnapped'/'unkidnapped', got {frame_id!r}")

    def mark_as_kidnapped_and_signal_end_of_world(self) -> None:
        """Forced end-of-world before checkpoint save
        (NodeDataManager.cpp:838-844)."""
        assert self._n > 0
        self.mark_as_kidnapped(int(self._ts[self._n - 1]))

    def mark_as_unkidnapped_and_signal_start_of_world(self, t_ns: int) -> None:
        self.mark_as_unkidnapped(t_ns)

    # ------------------------------------------------------------------
    # world / timeline queries (NodeDataManager.cpp:1127-1304)
    # ------------------------------------------------------------------

    def which_world_is_this(self, t_ns: int) -> int:
        """World id for a timestamp; negative = kidnap dead zone. Exact
        branch structure of NodeDataManager.cpp:1127-1198 including its
        boundary conventions."""
        t = int(t_ns)
        ks, ke = self.kidnap_starts, self.kidnap_ends
        if len(ks) == 0:
            return 0
        if len(ks) == 1:
            if t < ks[0]:
                return 0
            if len(ke) == 0:
                return -1 if t >= ks[0] else 0
            return -1 if (ks[0] <= t <= ke[0]) else 1

        if len(ks) == len(ke):
            prev = 0
            for i in range(len(ks)):
                if prev < t <= ks[i]:
                    return i
                if ks[i] < t <= ke[i]:
                    return -(i + 1)
                prev = ke[i]
            return len(ke)
        else:
            prev = 0
            for i in range(len(ks) - 1):
                if prev < t <= ks[i]:
                    return i
                if ks[i] < t <= ke[i]:
                    return -(i + 1)
                prev = ke[i]
            i = len(ks) - 1
            if ke[i - 1] < t <= ks[i]:
                return i
            if t > ks[i]:
                return -(i + 1)
            return -(i + 1)  # t before ke[i-1] handled by earlier branches

    def world_of_node(self, i: int) -> int:
        return self.which_world_is_this(int(self._ts[i]))

    def nodeidx_of_world_i_started(self, i: int) -> int:
        if i < 0:
            return -3
        if i == 0:
            return 0
        if i - 1 < len(self.kidnap_ends):
            hits = np.nonzero(self.node_worlds() == i)[0]
            if len(hits):
                return int(hits[0])
        return -4

    def nodeidx_of_world_i_ended(self, i: int) -> int:
        if i < 0:
            return -1
        if i > len(self.kidnap_ends):
            return -1
        if i < len(self.kidnap_starts):
            return self.find_indexof_node(self.kidnap_starts[i])
        return self._n - 1

    def n_worlds(self) -> int:
        return len(self.kidnap_ends) + 1

    def n_kidnaps(self) -> int:
        return len(self.kidnap_starts)

    # ------------------------------------------------------------------
    # getters
    # ------------------------------------------------------------------

    @property
    def node_len(self) -> int:
        return self._n

    @property
    def edge_len(self) -> int:
        return self._e

    def node_timestamp(self, i: int) -> int:
        return int(self._ts[i])

    def node_pose(self, i: int):
        return self._q[i].copy(), self._t[i].copy()

    def node_cov(self, i: int):
        return self._cov[i].copy()

    def edge_idx_info(self, e: int):
        return int(self._e_a[e]), int(self._e_b[e])

    def edge_pose(self, e: int):
        return self._e_q[e].copy(), self._e_t[e].copy()

    def edge_weight(self, e: int) -> float:
        return float(self._e_w[e])

    def edge_description(self, e: int) -> str:
        return self._e_desc[e]

    # array views (for problem building — no copies)
    def node_arrays(self):
        n = self._n
        return self._ts[:n], self._q[:n], self._t[:n]

    def edge_arrays(self):
        e = self._e
        return (self._e_a[:e], self._e_b[:e], self._e_q[:e], self._e_t[:e],
                self._e_w[:e], np.asarray(self.edge_mask[:e], bool))

    def node_worlds(self) -> np.ndarray:
        """World id for every node — the per-trigger O(N) hot path,
        vectorized as two searchsorted passes over the kidnap-interval
        boundaries (equivalent to which_world_is_this per node; the
        per-node scalar loop dominated trigger host time at large N).

        Derivation: with a = #starts strictly before t and b = #ends
        strictly before t, node t is in dead zone -(a) when a > b and in
        world a when a == b — this reproduces every branch of
        NodeDataManager.cpp:1127-1198 except the single-kidnap quirk
        (t == ks[0] classifies as dead zone there), special-cased below.
        Verified element-wise against which_world_is_this in
        tests/test_store_worlds.py."""
        n = self._n
        ts = self._ts[:n]
        ks = np.asarray(self.kidnap_starts, np.int64)
        ke = np.asarray(self.kidnap_ends, np.int64)
        if len(ks) == 0:
            return np.zeros(n, np.int64)
        if len(ks) == 1:
            # exact branch structure of the nks == 1 case, including its
            # ks[0]-inclusive dead-zone boundary
            if len(ke) == 0:
                return np.where(ts >= ks[0], -1, 0).astype(np.int64)
            return np.where(
                (ts >= ks[0]) & (ts <= ke[0]), -1,
                np.where(ts < ks[0], 0, 1),
            ).astype(np.int64)
        a = np.searchsorted(ks, ts, side="left")   # starts strictly < t
        b = np.searchsorted(ke, ts, side="left")   # ends strictly < t
        return np.where(a > b, -a, a).astype(np.int64)

    # ------------------------------------------------------------------
    # persistence: log_posegraph.json schema (NodeDataManager.cpp:503-754)
    # ------------------------------------------------------------------

    def save_as_json(self, path: str) -> None:
        obj = {"meta_data": {"getNodeLen": self._n, "getEdgeLen": self._e}}
        nodes = []
        for i in range(self._n):
            T = nse3.pose_to_matrix(self._q[i], self._t[i])
            nodes.append({
                "timestamp": int(self._ts[i]) / 1e9,
                "timestamp_ns": int(self._ts[i]),
                "idx": i,
                "world_id": self.world_of_node(i),
                "wTc": _matrix_to_semicolon_csv(T),
                "cov": _matrix_to_semicolon_csv(self._cov[i]),
            })
        obj["nodes"] = nodes
        edges = []
        for e in range(self._e):
            a, b = int(self._e_a[e]), int(self._e_b[e])
            w0 = self.world_of_node(a)
            w1 = self.world_of_node(b)
            code = -1 if (w0 < 0 or w1 < 0) else (1 if w0 == w1 else 2)
            T = nse3.pose_to_matrix(self._e_q[e], self._e_t[e])
            edges.append({
                "idx0": a, "idx1": b,
                "timestamp0": int(self._ts[a]) / 1e9,
                "timestamp1": int(self._ts[b]) / 1e9,
                "timestamp0_ns": int(self._ts[a]),
                "timestamp1_ns": int(self._ts[b]),
                "world0_id": w0, "world1_id": w1, "code": code,
                "b_T_a": _matrix_to_semicolon_csv(T),
                "weight": float(self._e_w[e]),
                "description": self._e_desc[e],
                "edge_mask": bool(self.edge_mask[e]),
            })
        obj["loopedges"] = edges
        obj["world_info"] = [
            {"id": i,
             "nodeidx_of_world_i_started": self.nodeidx_of_world_i_started(i),
             "nodeidx_of_world_i_ended": self.nodeidx_of_world_i_ended(i)}
            for i in range(self.n_worlds())
        ]
        obj["kidnap_info"] = [
            {"idx": i,
             "stamp_of_kidnap_i_started": self.kidnap_starts[i] / 1e9,
             "stamp_of_kidnap_i_started_ns": self.kidnap_starts[i],
             "stamp_of_kidnap_i_ended": (self.kidnap_ends[i] / 1e9
                                         if i < len(self.kidnap_ends) else None),
             "stamp_of_kidnap_i_ended_ns": (self.kidnap_ends[i]
                                            if i < len(self.kidnap_ends) else None)}
            for i in range(self.n_kidnaps())
        ]
        obj["disjoint_set_status"] = self.worlds.disjoint_set_status()
        with open(path, "w") as f:
            json.dump(obj, f, indent=4)

    @staticmethod
    def load_from_json(path: str, edge_mask: Optional[List[bool]] = None
                       ) -> "GraphStore":
        """Rebuild a GraphStore from a log_posegraph.json dump. edge_mask
        optionally drops edges (the debug_kf_slam ablation capability,
        src/debug_kf_slam_node.cpp)."""
        with open(path) as f:
            obj = json.load(f)
        g = GraphStore(initial_capacity=max(len(obj.get("nodes", [])), 16))
        # kidnap intervals first so world bookkeeping replays correctly
        starts, ends = [], []
        for k in obj.get("kidnap_info", []):
            if "stamp_of_kidnap_i_started_ns" in k:
                starts.append(int(k["stamp_of_kidnap_i_started_ns"]))
                if k.get("stamp_of_kidnap_i_ended_ns") is not None:
                    ends.append(int(k["stamp_of_kidnap_i_ended_ns"]))
            else:
                starts.append(int(round(k["stamp_of_kidnap_i_started"] * 1e9)))
                if k.get("stamp_of_kidnap_i_ended") is not None:
                    ends.append(int(round(k["stamp_of_kidnap_i_ended"] * 1e9)))

        events = sorted(
            [(s, "k") for s in starts] + [(e, "u") for e in ends]
        )
        ev = 0
        for node in obj.get("nodes", []):
            ts = (int(node["timestamp_ns"]) if "timestamp_ns" in node
                  else int(round(node["timestamp"] * 1e9)))
            while ev < len(events) and events[ev][0] < ts:
                t_ev, kind = events[ev]
                if kind == "k":
                    g.mark_as_kidnapped(t_ev)
                else:
                    g.mark_as_unkidnapped(t_ev)
                ev += 1
            T = _csv_to_matrix(node["wTc"], 4, 4)
            q, t = nse3.matrix_to_pose(T)
            cov = (_csv_to_matrix(node["cov"], 6, 6)
                   if "cov" in node else None)
            g.add_node(ts, q, t, cov)
        while ev < len(events):
            t_ev, kind = events[ev]
            if kind == "k":
                g.mark_as_kidnapped(t_ev)
            else:
                g.mark_as_unkidnapped(t_ev)
            ev += 1

        for i, e in enumerate(obj.get("loopedges", [])):
            T = _csv_to_matrix(e["b_T_a"], 4, 4)
            q, t = nse3.matrix_to_pose(T)
            idx = g.add_loop_edge_by_index(
                int(e["idx0"]), int(e["idx1"]), q, t,
                float(e.get("weight", 1.0)), e.get("description", ""),
            )
            if idx is None:
                raise ValueError(
                    f"loop edge ({e['idx0']},{e['idx1']}) out of range for "
                    f"{g.node_len} nodes"
                )
            keep = e.get("edge_mask", True)
            if edge_mask is not None:
                keep = keep and bool(edge_mask[i])
            g.edge_mask[idx] = bool(keep)

        # timestamp <-> index consistency check on BOTH endpoints
        # (NodeDataManager.cpp:736-747)
        for e in obj.get("loopedges", []):
            for tkey, ikey in (("timestamp0", "idx0"), ("timestamp1", "idx1")):
                ts = (int(e[tkey + "_ns"]) if tkey + "_ns" in e
                      else int(round(e[tkey] * 1e9)))
                ia = g.find_indexof_node(ts)
                assert ia == int(e[ikey]), (
                    f"edge timestamp/index mismatch: {ia} != {e[ikey]}"
                )
        return g

    def kidnap_data_to_json(self) -> dict:
        """Checkpoint payload (NodeDataManager.cpp:854-888)."""
        return {
            "kidnap_starts_ns": list(self.kidnap_starts),
            "kidnap_ends_ns": list(self.kidnap_ends),
            "current_kidnap_status": self.current_kidnap_status,
        }

    def load_kidnap_data_from_json(self, obj: dict) -> None:
        self.kidnap_starts = [int(x) for x in obj["kidnap_starts_ns"]]
        self.kidnap_ends = [int(x) for x in obj["kidnap_ends_ns"]]
        self.current_kidnap_status = bool(obj["current_kidnap_status"])


def _matrix_to_semicolon_csv(T: np.ndarray) -> str:
    """Eigen CSVFormat(FullPrecision, DontAlignCols, ",", ";") — used by
    saveAsJSON for wTc/b_T_a strings (NodeDataManager.cpp:507)."""
    return ";".join(",".join(repr(float(v)) for v in row) for row in T)

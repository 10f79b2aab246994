"""Counterpart of solve_keyframe_pose_graph_tpu/graph/worlds.py, the same code.

Multi-world coordinate-frame registry ("kidnap" recovery bookkeeping).

Reimplements the semantics of the reference's Worlds + millipede
DisjointSetForest (/root/reference/src/Worlds.{h,cpp},
src/utils/DisjointSet.h) on the host side (tiny state, never on device):

  * every kidnap-end starts a new world (coordinate frame); world ids are
    dense ints 0,1,2,...
  * the first loop edge between two worlds fixes their relative pose and
    union-merges their sets; union_sets(max(m,n), min(m,n)) with
    union-by-rank + path compression — the exact rank rules matter because
    find_setID_of_world_i values leak into re-basing decisions and the
    checkpoint format (Worlds.cpp:155-171, DisjointSet.h:240-256)
  * relative poses between worlds in the same set that were never directly
    observed are inferred by BFS over the known-pair graph, chaining
    transforms along the path, then memoized (Worlds.cpp:6-149)
  * persistence replays an op-log string like
    "add_element:0;union_sets:1,0;" to rebuild the identical forest
    (Worlds.cpp:449-516)

Poses are (q, t) pairs in our xyzw convention; matrix forms are only used
at the JSON boundary.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

import numpy as np

from solve_keyframe_pose_graph_tpu_torch.utils import nse3


class DisjointSet:
    """Union-by-rank + path compression, bit-compatible with the vendored
    millipede DisjointSetForest (DisjointSet.h:110-256)."""

    def __init__(self):
        self._parent: Dict[int, int] = {}
        self._rank: Dict[int, int] = {}
        self._set_count = 0

    def add_element(self, x: int) -> None:
        self._parent[x] = x
        self._rank[x] = 0
        self._set_count += 1

    def exists(self, x: int) -> bool:
        return x in self._parent

    def element_count(self) -> int:
        return len(self._parent)

    def set_count(self) -> int:
        return self._set_count

    def find_set(self, x: int) -> int:
        parent = self._parent[x]
        if parent != x:
            parent = self.find_set(parent)
            self._parent[x] = parent
        return parent

    def union_sets(self, x: int, y: int) -> None:
        sx, sy = self.find_set(x), self.find_set(y)
        if sx == sy:
            return
        # millipede link(): rank rule decides the surviving root
        if self._rank[sx] > self._rank[sy]:
            self._parent[sy] = sx
        else:
            self._parent[sx] = sy
            if self._rank[sx] == self._rank[sy]:
                self._rank[sy] += 1
        self._set_count -= 1


class WorldRegistry:
    """Host-side world bookkeeping (the reference's Worlds class)."""

    def __init__(self):
        self._ds = DisjointSet()
        self._rel_pose: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
        self._rel_info: Dict[Tuple[int, int], str] = {}
        self.world_start_stamps: List[int] = []   # ns timestamps
        self.world_end_stamps: List[int] = []
        self._op_log: List[str] = []

    # ------------------------------------------------------------------
    # lifecycle (Worlds.cpp:230-247)
    # ------------------------------------------------------------------

    def world_starts(self, t_ns: int) -> None:
        self.world_start_stamps.append(int(t_ns))
        wid = len(self.world_start_stamps) - 1
        self._ds.add_element(wid)
        self._op_log.append(f"add_element:{wid};")

    def world_ends(self, t_ns: int) -> None:
        self.world_end_stamps.append(int(t_ns))

    def n_worlds(self) -> int:
        return self._ds.element_count()

    def n_sets(self) -> int:
        return self._ds.set_count()

    # ------------------------------------------------------------------
    # relative poses (Worlds.cpp:6-171)
    # ------------------------------------------------------------------

    def set_pose_between_worlds(self, m: int, n: int, q, t,
                                info: str = "") -> None:
        """Store m_T_n and union-merge. The max/min ordering keeps the
        earliest world id as the usual set root (Worlds.cpp:163-166)."""
        self._rel_pose[(m, n)] = (np.asarray(q, np.float64).copy(),
                                  np.asarray(t, np.float64).copy())
        self._rel_info[(m, n)] = self._rel_info.get((m, n), "") + ";" + info
        assert self._ds.exists(m) and self._ds.exists(n)
        a, b = max(m, n), min(m, n)
        self._ds.union_sets(a, b)
        self._op_log.append(f"union_sets:{a},{b};")

    def is_exist(self, m: int, n: int) -> bool:
        if m < 0 or n < 0:
            return False
        if m == n:
            return True
        if m >= self.n_worlds() or n >= self.n_worlds():
            return False
        return self._ds.find_set(m) == self._ds.find_set(n)

    def get_pose_between_worlds(self, m: int, n: int):
        """m_T_n as (q, t). Identity if m == n; direct or inverse map hit;
        else BFS inference over the known-pair graph, memoized."""
        if m == n:
            return nse3.quat_identity(), np.zeros(3)
        if not self.is_exist(m, n):
            raise KeyError(
                f"no relative pose between worlds {m} and {n}: different or "
                f"non-existent sets (call is_exist first)"
            )
        if (m, n) in self._rel_pose:
            q, t = self._rel_pose[(m, n)]
            return q.copy(), t.copy()
        if (n, m) in self._rel_pose:
            q, t = self._rel_pose[(n, m)]
            return nse3.pose_inv(q, t)

        # BFS inference (Worlds.cpp:55-140): undirected graph over stored
        # pairs within this set, path n -> m, chain the poses.
        set_id = self._ds.find_set(m)
        adj: Dict[int, list] = {}
        for (a, b) in self._rel_pose:
            if self._ds.find_set(a) == set_id and self._ds.find_set(b) == set_id:
                adj.setdefault(a, []).append(b)
                adj.setdefault(b, []).append(a)
        # BFS from n, then read the path m -> n (reference roots at n and
        # extracts path starting at m, Worlds.cpp:106-112)
        parent = {n: None}
        dq = deque([n])
        while dq:
            u = dq.popleft()
            for v in adj.get(u, []):
                if v not in parent:
                    parent[v] = u
                    dq.append(v)
        if m not in parent:
            raise KeyError(f"worlds {m},{n} in same set but no pose path")
        path = [m]
        while parent[path[-1]] is not None:
            path.append(parent[path[-1]])
        # chain: ans = prod path[h]_T_path[h+1]
        q_ans, t_ans = nse3.quat_identity(), np.zeros(3)
        for h in range(len(path) - 1):
            a, b = path[h], path[h + 1]
            if (a, b) in self._rel_pose:
                qh, th = self._rel_pose[(a, b)]
            else:
                qh, th = nse3.pose_inv(*self._rel_pose[(b, a)])
            q_ans, t_ans = nse3.pose_mul(q_ans, t_ans, qh, th)
        # memoize (reference re-stores and re-unions, Worlds.cpp:143)
        self.set_pose_between_worlds(
            path[0], path[-1], q_ans, t_ans, "pose set by inference with BFS"
        )
        return q_ans, t_ans

    def find_setID_of_world_i(self, i: int) -> int:
        """Negative ids pass through (dead-zone query convention:
        Worlds.cpp:249-255 returns find_set for existing ids, -1 sentinel
        style otherwise)."""
        if i < 0 or not self._ds.exists(i):
            return i if i < 0 else -1
        return self._ds.find_set(i)

    def get_world_to_setid_map(self) -> Dict[int, int]:
        return {w: self._ds.find_set(w) for w in range(self.n_worlds())}

    # ------------------------------------------------------------------
    # status / persistence (Worlds.cpp:278-363, 449-667)
    # ------------------------------------------------------------------

    def disjoint_set_status(self) -> str:
        parts = []
        for w in range(self.n_worlds()):
            parts.append(f"{w}--> {self._ds.find_set(w)};")
        return "".join(parts)

    def status_json(self) -> dict:
        worlds = []
        for w in range(self.n_worlds()):
            worlds.append({
                "world_id": w,
                "set_id": self._ds.find_set(w),
                "start_stamp_ns": (self.world_start_stamps[w]
                                   if w < len(self.world_start_stamps) else None),
                "end_stamp_ns": (self.world_end_stamps[w]
                                 if w < len(self.world_end_stamps) else None),
            })
        return {
            "n_worlds": self.n_worlds(),
            "n_sets": self.n_sets(),
            "worlds": worlds,
            "disjoint_set_status": self.disjoint_set_status(),
        }

    def to_json(self) -> dict:
        """Checkpoint payload: rel-pose map + world stamps + replayable
        op-log (the reference's WorldsData, Worlds.cpp:449-516)."""
        rel = []
        for (m, n), (q, t) in self._rel_pose.items():
            T = nse3.pose_to_matrix(q, t)
            rel.append({
                "m": m, "n": n,
                "m_T_n": _matrix_to_csv(T),
                "info": self._rel_info.get((m, n), ""),
            })
        return {
            "rel_pose_between_worlds": rel,
            "world_start_stamps": list(self.world_start_stamps),
            "world_end_stamps": list(self.world_end_stamps),
            "disjoint_set_log": "".join(self._op_log),
        }

    @staticmethod
    def from_json(obj: dict) -> "WorldRegistry":
        w = WorldRegistry()
        w.world_start_stamps = [int(x) for x in obj["world_start_stamps"]]
        w.world_end_stamps = [int(x) for x in obj["world_end_stamps"]]
        # replay op-log to rebuild the identical forest (Worlds.cpp:519-667)
        log = obj.get("disjoint_set_log", "")
        for op in log.split(";"):
            op = op.strip()
            if not op:
                continue
            name, _, arg = op.partition(":")
            if name == "add_element":
                w._ds.add_element(int(arg))
            elif name == "union_sets":
                a, b = arg.split(",")
                w._ds.union_sets(int(a), int(b))
            else:
                raise ValueError(f"unknown op in disjoint_set_log: {op!r}")
            w._op_log.append(op + ";")
        for e in obj.get("rel_pose_between_worlds", []):
            T = _csv_to_matrix(e["m_T_n"], 4, 4)
            q, t = nse3.matrix_to_pose(T)
            w._rel_pose[(int(e["m"]), int(e["n"]))] = (q, t)
            w._rel_info[(int(e["m"]), int(e["n"]))] = e.get("info", "")
        return w


def _matrix_to_csv(T: np.ndarray) -> str:
    """Eigen CSVFormat(FullPrecision, DontAlignCols, ", ", "\\n") — the
    format used by RawFileIO::eigen_matrix_to_json (RawFileIO.h:91-103)."""
    return "\n".join(", ".join(repr(float(v)) for v in row) for row in T)


def _csv_to_matrix(s: str, rows: int, cols: int) -> np.ndarray:
    out = np.zeros((rows, cols))
    lines = [ln for ln in s.replace(";", "\n").split("\n") if ln.strip()]
    assert len(lines) == rows, (len(lines), rows, s)
    for r, ln in enumerate(lines):
        vals = [v for v in ln.split(",") if v.strip()]
        assert len(vals) == cols
        out[r] = [float(v) for v in vals]
    return out

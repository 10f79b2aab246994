"""Traffic: the arrival schedule of a mix and the stream's wire messages.

A mix file (port_bench/traffic/<mix>.json) holds

  "keyframes": {"per_s": rate}        fixed spacing, 1/rate apart
  "pose_queries": {"per_s": rate}
  "lead_s": seconds of traffic before the window

Keyframe i of the graph is stamped T0 + i / rate: keyframes are stamped at
the rate at which they arrive, in set-up and in the window alike. Keyframe
k of the window is due at k / rate; its loop edges (those whose later
endpoint it is) are due with it and sent right after it, with the graph's
events placed before or after it around them. The pose client asks an
imu_propagate query at each multiple of 1 / rate, at the stamp and VIO
pose of the newest keyframe due by then: the robot's current pose. Both
are open loops: every message is due at its time whatever the server
does.
"""

from __future__ import annotations

import json

import numpy as np

from port_bench.harness.generators import Event, Graph

T0_NS = 1_000_000_000


def stamp_ns(mix: dict) -> int:
    """The spacing of keyframe stamps: the keyframes' arrival spacing."""
    return int(round(1e9 / float(mix["keyframes"]["per_s"])))


def keyframe_due(mix: dict, seconds: float) -> np.ndarray:
    """Due offsets (s), from the start of a span of `seconds`, of its
    keyframes."""
    rate = float(mix["keyframes"]["per_s"])
    return np.arange(int(np.ceil(seconds * rate - 1e-9))) / rate


def pose_due(mix: dict, seconds: float) -> np.ndarray:
    rate = float(mix["pose_queries"]["per_s"])
    return np.arange(int(np.ceil(seconds * rate - 1e-9))) / rate


def node_line(g: Graph, i: int, dt_ns: int) -> str:
    return json.dumps({"kind": "node_pose", "t_ns": T0_NS + i * dt_ns,
                       "q": g.vio_q[i].tolist(), "t": g.vio_t[i].tolist()})


def edge_line(g: Graph, k: int, dt_ns: int) -> str:
    a, b = (int(v) for v in g.loop_pairs[k])
    return json.dumps({"kind": "loop_edge",
                       "timestamp0_ns": T0_NS + a * dt_ns,
                       "timestamp1_ns": T0_NS + b * dt_ns,
                       "q_1T0": g.loop_q[k].tolist(),
                       "t_1T0": g.loop_t[k].tolist(),
                       "weight": float(g.loop_w[k])})


def edges_by_later(g: Graph) -> dict:
    """Loop edge indices of `g` by their later endpoint, in the
    generator's order within a node: the order in which they stream."""
    later = np.maximum(g.loop_pairs[:, 0], g.loop_pairs[:, 1])
    out: dict = {}
    for k in np.argsort(later, kind="stable"):
        out.setdefault(int(later[k]), []).append(int(k))
    return out


def event_message(ev: Event, dt_ns: int) -> dict:
    """An event's wire message with its stamp: 1 ns after or before its
    node's."""
    return {**ev.message,
            "t_ns": T0_NS + ev.node * dt_ns + (1 if ev.after else -1)}


def keyframe_lines(g: Graph, i: int, by_later: dict, dt_ns: int) -> list:
    """The events placed before node i, node i's message, each of its loop
    edges', then the events placed after it."""
    return ([json.dumps(event_message(e, dt_ns))
             for e in g.events_at(i, after=False)]
            + [node_line(g, i, dt_ns)]
            + [edge_line(g, k, dt_ns) for k in by_later.get(i, ())]
            + [json.dumps(event_message(e, dt_ns))
               for e in g.events_at(i, after=True)])


def pose_line(g: Graph, i: int, dt_ns: int) -> str:
    """An imu_propagate query at the stamp and VIO pose of node i."""
    return json.dumps({"kind": "imu_propagate", "t_ns": T0_NS + i * dt_ns,
                       "q": g.vio_q[i].tolist(), "t": g.vio_t[i].tolist()})


def pose_nodes(kf_due: np.ndarray, kf_nodes: np.ndarray,
               q_due: np.ndarray) -> np.ndarray:
    """For each pose query, the newest keyframe due at or before it (to a
    nanosecond: offsets are float sums)."""
    k = np.searchsorted(kf_due, q_due + 1e-9, side="right") - 1
    return kf_nodes[np.clip(k, 0, len(kf_nodes) - 1)]

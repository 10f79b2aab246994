"""Wire-format message schemas (the ROS msg layer analog, SURVEY.md L5;
counterpart of solve_keyframe_pose_graph_tpu/graph/messages.py).

The reference's wire surface:
  * nav_msgs/Odometry           -> NodePoseMsg (camera_pose_callback input)
  * msg/LoopEdge.msg            -> LoopEdgeMsg ({timestamp0, timestamp1,
                                   pose_1T0, weight, description},
                                   /root/reference/msg/LoopEdge.msg:1-5)
  * std_msgs/Header (kidnap)    -> KidnapIndicatorMsg (frame_id
                                   "kidnapped"/"unkidnapped",
                                   NodeDataManager.cpp:763-792)
  * extrinsic nav_msgs/Odometry -> ExtrinsicMsg

JSON serde for file/socket replay tapes; `apply()` feeds a GraphStore the
same way the reference's subscriber callbacks do.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Union

import numpy as np


@dataclasses.dataclass
class NodePoseMsg:
    t_ns: int
    q: np.ndarray                       # (4,) xyzw
    t: np.ndarray                       # (3,)
    cov: Optional[np.ndarray] = None    # (6,6)

    kind = "node_pose"

    def apply(self, store):
        store.add_node(self.t_ns, self.q, self.t, self.cov)

    def to_json(self) -> dict:
        d = {"kind": self.kind, "t_ns": int(self.t_ns),
             "q": list(map(float, self.q)), "t": list(map(float, self.t))}
        if self.cov is not None:
            d["cov"] = np.asarray(self.cov).ravel().tolist()
        return d


@dataclasses.dataclass
class LoopEdgeMsg:
    """msg/LoopEdge.msg parity: pose_1T0 = pose of 0 as observed from 1."""

    timestamp0_ns: int
    timestamp1_ns: int
    q_1T0: np.ndarray                   # (4,) xyzw
    t_1T0: np.ndarray                   # (3,)
    weight: float = 1.0
    description: str = ""

    kind = "loop_edge"

    def apply(self, store):
        store.add_loop_edge(self.timestamp0_ns, self.timestamp1_ns,
                            self.q_1T0, self.t_1T0, self.weight,
                            self.description)

    def to_json(self) -> dict:
        return {"kind": self.kind,
                "timestamp0_ns": int(self.timestamp0_ns),
                "timestamp1_ns": int(self.timestamp1_ns),
                "q_1T0": list(map(float, self.q_1T0)),
                "t_1T0": list(map(float, self.t_1T0)),
                "weight": float(self.weight),
                "description": self.description}


@dataclasses.dataclass
class KidnapIndicatorMsg:
    t_ns: int
    frame_id: str                       # "kidnapped" | "unkidnapped"

    kind = "kidnap_indicator"

    def apply(self, store):
        store.kidnap_indicator(self.t_ns, self.frame_id)

    def to_json(self) -> dict:
        return {"kind": self.kind, "t_ns": int(self.t_ns),
                "frame_id": self.frame_id}


@dataclasses.dataclass
class ExtrinsicMsg:
    t_ns: int
    q: np.ndarray                       # imu_T_cam rotation, xyzw
    t: np.ndarray

    kind = "extrinsic"

    def apply(self, store):
        store.set_extrinsic(self.q, self.t)

    def to_json(self) -> dict:
        return {"kind": self.kind, "t_ns": int(self.t_ns),
                "q": list(map(float, self.q)), "t": list(map(float, self.t))}


@dataclasses.dataclass
class ImuPropagateMsg:
    """The ~200 Hz low-latency input (/vins_estimator/imu_propagate,
    keyframe_pose_graph_slam_node.cpp:458-461): the newest IMU odometry pose
    w_T_imu. NOT graph state — the server answers each one immediately with
    the corrected world-frame pose composed through the latest solved map
    (Composer.cpp:848-943); applying it to a store is a no-op."""

    t_ns: int
    q: np.ndarray                       # (4,) xyzw, w_T_imu rotation
    t: np.ndarray                       # (3,)

    kind = "imu_propagate"

    def apply(self, store):
        return None                     # serving-path only

    def to_json(self) -> dict:
        return {"kind": self.kind, "t_ns": int(self.t_ns),
                "q": list(map(float, self.q)), "t": list(map(float, self.t))}


Message = Union[NodePoseMsg, LoopEdgeMsg, KidnapIndicatorMsg, ExtrinsicMsg,
                ImuPropagateMsg]


def message_from_json(d: dict) -> Message:
    kind = d["kind"]
    if kind == "node_pose":
        cov = (np.asarray(d["cov"], np.float64).reshape(6, 6)
               if "cov" in d else None)
        return NodePoseMsg(int(d["t_ns"]), np.asarray(d["q"], np.float64),
                           np.asarray(d["t"], np.float64), cov)
    if kind == "loop_edge":
        return LoopEdgeMsg(int(d["timestamp0_ns"]), int(d["timestamp1_ns"]),
                           np.asarray(d["q_1T0"], np.float64),
                           np.asarray(d["t_1T0"], np.float64),
                           float(d.get("weight", 1.0)),
                           d.get("description", ""))
    if kind == "kidnap_indicator":
        return KidnapIndicatorMsg(int(d["t_ns"]), d["frame_id"])
    if kind == "extrinsic":
        return ExtrinsicMsg(int(d["t_ns"]), np.asarray(d["q"], np.float64),
                            np.asarray(d["t"], np.float64))
    if kind == "imu_propagate":
        return ImuPropagateMsg(int(d["t_ns"]), np.asarray(d["q"], np.float64),
                               np.asarray(d["t"], np.float64))
    raise ValueError(f"unknown message kind {kind!r}")


def save_tape(path: str, messages: Sequence[Message]) -> None:
    """Event tape as JSON lines (one message per line, replayable)."""
    with open(path, "w") as f:
        for m in messages:
            f.write(json.dumps(m.to_json()) + "\n")


def load_tape(path: str) -> List[Message]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(message_from_json(json.loads(line)))
    return out


def replay_tape(messages: Sequence[Message], store) -> None:
    """Feed messages to a GraphStore in order (the subscriber-callback
    path, minus ROS)."""
    for m in messages:
        m.apply(store)

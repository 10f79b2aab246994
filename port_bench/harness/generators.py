"""The graph of a run, and its generators by the name that a
configuration file gives.

A configuration's "graph": {"generator": name, "args": {...}} names the
file port_bench/generators/<name>.py, which exposes one function,
generate(seed, **args) -> Graph: the same graph for the same seed. Beside
its keyframes and loop edges a Graph may carry events: wire messages of
the program's schema other than nodes and loop edges (its
graph/messages.py: a kidnap_indicator, say), each placed before or after a
node (Event).

The harness, not the generator, works out from the kidnap indicators
among them which loop edges the formulation counts (Graph.loop_counted):
an edge with an endpoint in a kidnap's dead zone, after a "kidnapped" and
before the next "unkidnapped", is sent and stored but left out of the
solve by design (the program masks an edge with an endpoint at a negative
world), so it is not due and no trajectory is waited for it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from port_bench.harness import manifest, nse3


@dataclasses.dataclass(frozen=True)
class Event:
    """A wire message placed in the stream at node `node`: after it and
    its loop edges, or before it. Its stamp, t_ns, is 1 ns after or before
    the node's: a kidnap placed after node i leaves node i in the old
    world, an unkidnap placed before node j puts node j in the new one.
    `message` is the message's JSON without its stamp."""
    node: int
    after: bool
    message: dict


@dataclasses.dataclass
class Graph:
    gt_q: np.ndarray            # (N, 4) ground truth
    gt_t: np.ndarray            # (N, 3)
    vio_q: np.ndarray           # (N, 4) drifted odometry, as streamed
    vio_t: np.ndarray           # (N, 3)
    loop_pairs: np.ndarray      # (E, 2) (a, b): pose of a seen from b
    loop_q: np.ndarray          # (E, 4)
    loop_t: np.ndarray          # (E, 3)
    loop_w: np.ndarray          # (E,)
    loop_is_outlier: np.ndarray  # (E,) bool
    events: list = dataclasses.field(default_factory=list)   # [Event]

    @property
    def n_nodes(self) -> int:
        return len(self.gt_t)

    @property
    def n_loops(self) -> int:
        return len(self.loop_pairs)

    def events_at(self, i: int, after: bool) -> list:
        """The events placed after (or before) node i, in the graph's
        order."""
        return [e for e in self.events if e.node == i and e.after == after]

    def kidnapped(self) -> np.ndarray:
        """(N, 2) bool: whether the stream is kidnapped as node i is added,
        after the events placed before it ([:, 0]: node i lies in a dead
        zone), and once the events placed after it are in ([:, 1])."""
        s = np.zeros(2 * self.n_nodes, bool)
        for e in sorted(self.events, key=lambda e: (e.node, e.after)):
            if e.message.get("kind") != "kidnap_indicator":
                continue
            pos, now = 2 * e.node + int(e.after), e.message["frame_id"]
            if (now == "kidnapped") == bool(s[pos]):
                raise ValueError(f"a {now!r} indicator at node {e.node} "
                                 f"repeats the stream's state")
            s[pos:] = now == "kidnapped"
        return s.reshape(-1, 2)

    @property
    def loop_counted(self) -> np.ndarray:
        """(E,) bool: the loop edges with neither endpoint in a dead
        zone."""
        dead = self.kidnapped()[:, 0]
        return ~(dead[self.loop_pairs[:, 0]] | dead[self.loop_pairs[:, 1]])


def generate(spec: dict, seed: int, base: str = manifest.BENCH_DIR) -> Graph:
    """The graph of a configuration's "graph" entry drawn from `seed`, by
    the generator file that it names under `base`."""
    path = os.path.join(base, "generators", spec["generator"] + ".py")
    return manifest.module(path).generate(seed, **spec["args"])


def session(spec: dict, session_seed: int, seed: int, first: int,
            base: str = manifest.BENCH_DIR) -> Graph:
    """The graph of one run: the session a robot already has, the same in
    every run, followed by the run's own traffic. Nodes before `first`
    and the loop edges whose later endpoint is one of them come from the
    graph drawn from `session_seed`; later nodes and their loop edges from
    the graph drawn from `seed`, its VIO chained on from the session's
    node first - 1 by the seed's own odometry. Both graphs share the
    ground truth, so every loop edge observes the same trajectory. Events
    at nodes before `first` come from the session's graph, the others from
    the seed's."""
    a = generate(spec, session_seed, base)
    b = generate(spec, seed, base)
    q, t = a.vio_q.copy(), a.vio_t.copy()
    rq, rt = nse3.pose_relative(b.vio_q[first - 1], b.vio_t[first - 1],
                                b.vio_q[first:], b.vio_t[first:])
    q[first:], t[first:] = nse3.pose_mul(
        np.broadcast_to(a.vio_q[first - 1], rq.shape),
        np.broadcast_to(a.vio_t[first - 1], rt.shape), rq, rt)
    q[first:] /= np.linalg.norm(q[first:], axis=-1, keepdims=True)
    keep_a = np.max(a.loop_pairs, axis=1) < first
    keep_b = np.max(b.loop_pairs, axis=1) >= first

    def loops(field):
        return np.concatenate([getattr(a, field)[keep_a],
                               getattr(b, field)[keep_b]])

    return Graph(gt_q=a.gt_q, gt_t=a.gt_t, vio_q=q, vio_t=t,
                 loop_pairs=loops("loop_pairs"), loop_q=loops("loop_q"),
                 loop_t=loops("loop_t"), loop_w=loops("loop_w"),
                 loop_is_outlier=loops("loop_is_outlier"),
                 events=[e for e in a.events if e.node < first]
                 + [e for e in b.events if e.node >= first])


def stream_order(g: Graph) -> np.ndarray:
    """The edges in the order they are streamed: grouped by their later
    endpoint, in node order, and in the generator's order within a node."""
    later = np.maximum(g.loop_pairs[:, 0], g.loop_pairs[:, 1])
    return np.argsort(later, kind="stable")

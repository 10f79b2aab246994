"""kidnap_circle: the circle graph of a session in which VIO tracking is
lost several times, each recovery starting a new world.

The keyframes, loop edges and outliers are circle_graph's, drawn from the
same seed with the same arguments. For each node K in `kidnaps` the VIO is
lost after K: a "kidnapped" indicator follows node K and its loop edges,
the next `blackout` keyframes lie in the dead zone, and an "unkidnapped"
indicator precedes node K + blackout + 1, the first node of a new world.
VINS re-initialises at its origin, so each new world's VIO is re-framed
to put its first node at the identity; the dead zone's keyframes stay in
the frame of the world that was lost. The loop edges observe the ground
truth, so an edge between two worlds ties their frames together, and its
first such edge merges their sets in the program (a share of those first
edges are gross outliers, as the reference node allows).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from port_bench.harness import generators, nse3


def _event(node: int, after: bool, frame_id: str) -> generators.Event:
    return generators.Event(node, after, {"kind": "kidnap_indicator",
                                          "frame_id": frame_id})


def generate(seed: int, n_nodes: int, n_loops: int, kidnaps: list,
             blackout: int) -> generators.Graph:
    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    g = generators.generate({"generator": "circle_graph",
                             "args": {"n_nodes": n_nodes,
                                      "n_loops": n_loops}}, seed, base)
    starts = [int(k) + int(blackout) + 1 for k in kidnaps]
    if (sorted(kidnaps) != list(kidnaps) or blackout < 1
            or any(b <= a for a, b in zip(starts, kidnaps[1:]))
            or starts and starts[-1] >= n_nodes):
        raise ValueError(f"kidnaps {kidnaps} with a blackout of {blackout} "
                         f"do not fit in order in {n_nodes} nodes")
    q, t = g.vio_q.copy(), g.vio_t.copy()
    for j, end in zip(starts, starts[1:] + [n_nodes]):
        qi, ti = nse3.pose_inv(g.vio_q[j], g.vio_t[j])
        q[j:end], t[j:end] = nse3.pose_mul(
            np.broadcast_to(qi, q[j:end].shape),
            np.broadcast_to(ti, t[j:end].shape), g.vio_q[j:end],
            g.vio_t[j:end])
        q[j:end] /= np.linalg.norm(q[j:end], axis=-1, keepdims=True)
    events = []
    for k, j in zip(kidnaps, starts):
        events += [_event(int(k), True, "kidnapped"),
                   _event(j, False, "unkidnapped")]
    return dataclasses.replace(g, vio_q=q, vio_t=t, events=events)

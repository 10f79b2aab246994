"""The program's SolverEngine driven on the CPU through a small session of
the kidnap deployment, each trigger judged against the plain reference
(port_bench/reference/worlds.py).

The graph is kidnap_circle's at 400 nodes: world 0 is nodes 0-59, world 1
90-129, world 2 160-309, world 3 340-399, each loss followed by a 30-node
dead zone; loop edges join node a of the second lap to a - 200. The
stream is ingested up to each of CUTS and the engine's trigger called:

  230  the first solve: world 2 meets world 0 (a first contact; world 2's
       nodes mapped into the set's frame, case 4); world 1 stays a set of
       its own, so two priors;
  305  world 2 meets world 1: world 1's solved nodes are re-based (case 1);
       the edges into the first dead zone are stored and not counted;
  325  kidnapped after node 309: the trigger is refused;
  380  world 3's first trigger meets world 2 (case 4);
  400  a warm solve (case 3).

Each solve is judged by judge(): the engine's guesses before the solve
against worlds.trigger_start (to 1e-9), its Problem's priors and masks
against the reference's, and its answer's cost against the reference's
solve by the configuration's limits (harness/check.py).
"""

from __future__ import annotations

import json
import os

import numpy as np

from port_bench.harness import check, manifest, traffic
from port_bench.reference import worlds

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KIDNAPS, BLACKOUT = [59, 129, 309], 30
N_NODES, N_LOOPS, SEED = 400, 600, 7
CUTS = (230, 305, 325, 380, 400)
TOL = 1e-9


def config() -> dict:
    with open(os.path.join(ROOT, "port_bench", "configs",
                           "kidnap5k_10kloops.json")) as f:
        return json.load(f)


def graph():
    gen = manifest.module(os.path.join(ROOT, "port_bench", "generators",
                                       "kidnap_circle.py"))
    return gen.generate(SEED, N_NODES, N_LOOPS, KIDNAPS, BLACKOUT)


def engine():
    from solve_keyframe_pose_graph_tpu_torch.config import (
        CapacityConfig, Config)
    from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
    from solve_keyframe_pose_graph_tpu_torch.solver.engine import (
        SolverEngine)
    store = GraphStore()
    cfg = Config(capacity=CapacityConfig(initial_nodes=512,
                                         initial_edges=256))
    return store, SolverEngine(store, cfg, device="cpu")


class Spy:
    """Keeps, for each solve, the engine's state as the solve takes it:
    the guesses and switches, and the Problem built from them."""

    def __init__(self, eng):
        self.seen = []
        inner = eng._prepare_solve

        def prepare(node_len, edge_len, *args):
            problem, kw, build = inner(node_len, edge_len, *args)
            self.seen.append(dict(
                q=eng._opt_q[:node_len].copy(),
                t=eng._opt_t[:node_len].copy(),
                s=eng._switch[:edge_len].copy(), problem=problem))
            return problem, kw, build

        eng._prepare_solve = prepare


def ingest(store, g, lo: int, hi: int) -> None:
    """Nodes lo..hi - 1, their loop edges and events, as set-up ingests
    them (harness/stream.py)."""
    from solve_keyframe_pose_graph_tpu_torch.graph.messages import (
        message_from_json)
    dt = 100_000_000
    by_later = traffic.edges_by_later(g)
    for i in range(lo, hi):
        for e in g.events_at(i, False):
            message_from_json(traffic.event_message(e, dt)).apply(store)
        store.add_node(traffic.T0_NS + i * dt, g.vio_q[i], g.vio_t[i])
        for k in by_later.get(i, ()):
            a, b = (int(v) for v in g.loop_pairs[k])
            store.add_loop_edge(traffic.T0_NS + a * dt, traffic.T0_NS + b * dt,
                                g.loop_q[k], g.loop_t[k], float(g.loop_w[k]))
        for e in g.events_at(i, True):
            message_from_json(traffic.event_message(e, dt)).apply(store)


def judge(cfg: dict, g, seen: dict, answer: dict) -> list:
    """What this solve got wrong against the reference: [] for none."""
    n, e = answer["node_len"], answer["edge_len"]
    faults = []
    q, t, s = worlds.trigger_start(cfg, g, answer)
    tr = worlds.trigger(g, n, e)
    valid = tr.w >= 0
    ref = worlds.trigger_problem(cfg, g, n, e, (q, t, s))
    if not (np.allclose(q[valid], seen["q"][valid], rtol=0, atol=TOL)
            and np.allclose(t[valid], seen["t"][valid], rtol=0, atol=TOL)
            and np.allclose(s[ref.keep], seen["s"][ref.keep], rtol=0,
                            atol=TOL)):
        faults.append("start")
    p = seen["problem"]
    live = p.prior_mask.numpy() > 0.5
    pi = p.prior_idx.numpy()[live]
    anchors = worlds.priors(g, tr, n)
    if not (len(pi) == len(anchors)
            and (pi == [i for _, i, _ in anchors]).all()
            and np.allclose(p.prior_w.double().numpy()[live],
                            [x for _, _, x in anchors], rtol=1e-6)
            and np.allclose(p.prior_t.double().numpy()[live], t[pi],
                            rtol=0, atol=1e-5)):
        faults.append("priors")
    # the store holds the loop edges in stream order
    if not (((p.loop_mask.numpy()[:e] > 0.5) == ref.keep).all()
            and ((p.node_mask.numpy()[:n] > 0.5) == valid).all()):
        faults.append("masks")
    nums = check.step(cfg, worlds, g, answer)
    gap, lim = (("start_gap", "first_gap") if answer["first"]
                else ("chi2_gap", "chi2_gap"))
    if not nums[gap] <= cfg["limits"][lim]:
        faults.append(gap)
    return faults


def drive(cuts=CUTS, fault=None) -> list:
    """The session to each cut in turn, each solve judged; `fault(eng)`,
    where given, breaks the engine first. Returns one row a cut: the
    trigger's solve_stats row (None where it was refused), the engine's
    kidnap_polls, and the judge's faults."""
    cfg, g = config(), graph()
    store, eng = engine()
    if fault is not None:
        fault(eng)
    spy = Spy(eng)
    rows, prev = [], None
    for cut in cuts:
        ingest(store, g, store.node_len, cut)
        fired = eng.trigger()
        row = dict(cut=cut, stats=None, kidnap_polls=eng.kidnap_polls,
                   faults=None, store=store)
        if fired:
            res = eng.last_result
            answer = dict(node_len=eng.solve_stats[-1]["node_len"],
                          edge_len=eng.solve_stats[-1]["edge_len"],
                          first=prev is None, prev=prev,
                          res=tuple(a.double().numpy().copy() for a in
                                    (res.q, res.t, res.switch)))
            row.update(stats=eng.solve_stats[-1],
                       faults=judge(cfg, g, spy.seen[-1], answer))
            prev = answer["res"]
        rows.append(row)
    return rows

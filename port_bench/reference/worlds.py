"""Plain NumPy reference of the multi-world pose graph: the kidnap
recovery of the reference node. It imports nothing of the program and
nothing of JAX.

It answers what harness/check.py asks of a configuration's reference for
a graph with kidnap events, written from the reference node's rules
(mpkuse/solve_keyframe_pose_graph, PoseGraphSLAM.cpp, Worlds.cpp,
NodeDataManager.cpp):

  * worlds (NodeDataManager.cpp:1127-1198): a node's world is the number
    of kidnaps that ended before it; a node after a kidnap started and
    before it ended lies in the dead zone (-(kidnaps started)), and takes
    no part in the solve: no odometry touches it, no loop edge with an
    endpoint in it counts, and it is not moved;
  * odometry (PoseGraphSLAM.cpp:1567-1640): posegraph.py's, between two
    nodes that both lie outside every dead zone;
  * first contact (:1452-1529): the loop edges in stream order; the first
    one between two worlds not yet in one set gives
    wb_T_wa = wb_T_b * b_T_a_obs * (wa_T_a)^-1 from the two nodes' VIO
    poses, and unites the worlds' sets by rank (union(max, min),
    Worlds.cpp:155-171; union by rank, millipede's DisjointSet.h), the
    worlds whose set changed, with their old and new set, noted;
  * poses between worlds of one set (Worlds.cpp:6-149): the stored ones,
    or their chain along a breadth-first path through the stored pairs;
  * initial guesses (:1645-1795), by (the node's world's set changed in
    this trigger, the node solved before): a solved node of a world
    whose set changed is re-based, new_T_old * pose (case 1); another
    solved node keeps its pose (case 2; at the session's first solve it
    takes its VIO pose); an unsolved node of the world of the newest
    solved node `su` is chained by odometry from it, w_T_su * (vio_su^-1
    * vio_u) (case 3); an unsolved node of another world is mapped into
    its set's frame, set_T_w * vio_u (case 4);
  * soft anchors (:1801-1879): a prior on the first node of every world
    that is its set's root, at that node's start pose, weight
    max(1.1, log(1 + span) / 2), span from that node to the world's last
    node among the trigger's;
  * the solve: posegraph.py's Levenberg-Marquardt with exact steps, with
    every prior in the normal equations.

Departures from the node, each the program's rule too:
  * the worlds whose set changed are those of the trigger's last first
    contact: the node clears the record at each contact, so a trigger
    with two first contacts that both move solved worlds re-bases only
    the last one's;
  * the world of a newest solved node that lies in a dead zone is the
    world that was lost there, and its pose is the identity (a dead
    node is never written back);
  * the relative poses between worlds are not memoized: a chain is
    recomputed each time, equal to the memoized one to rounding.

What it takes from the program is posegraph.py's: the previous solve's
written-back result (answer["prev"]), whose length also tells it the
previous solve's nodes and loop edges.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from port_bench.harness import generators, manifest, nse3

# posegraph.py's residuals, Jacobians and LM pieces, loaded from its file
# beside this one as the harness loads a reference
pg = manifest.module(__file__.rsplit("/", 1)[0] + "/posegraph.py")


# ---------------------------------------------------------------------------
# worlds and their sets
# ---------------------------------------------------------------------------


def node_worlds(g, n: int) -> np.ndarray:
    """(n,) the world of each of the first n nodes, -(kidnaps started) for
    a node in a dead zone, from the graph's kidnap indicators (an event
    after node i comes after it; one before node i, before it)."""
    starts, ends = np.zeros(2 * n + 1, np.int64), np.zeros(2 * n + 1,
                                                           np.int64)
    for e in g.events:
        if e.message.get("kind") != "kidnap_indicator":
            continue
        pos = min(2 * e.node + int(e.after), 2 * n)
        if e.message["frame_id"] == "kidnapped":
            starts[pos] += 1
        else:
            ends[pos] += 1
    # node i sees the events up to position 2 i
    a = np.cumsum(starts)[0:2 * n:2]
    b = np.cumsum(ends)[0:2 * n:2]
    return np.where(a > b, -a, b)


def kidnap_nodes(g) -> list:
    """The node after which each kidnap started, in order: world i ends
    there."""
    return sorted(e.node for e in g.events
                  if e.message.get("kind") == "kidnap_indicator"
                  and e.message["frame_id"] == "kidnapped")


class Worlds:
    """The worlds' disjoint sets and the poses observed between them."""

    def __init__(self, n_worlds: int):
        self.parent = list(range(n_worlds))
        self.rank = [0] * n_worlds
        self.rel = {}                   # (m, n) -> m_T_n, one a contact

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            x = self.parent[x]
        return x

    def setmap(self) -> list:
        return [self.find(w) for w in range(len(self.parent))]

    def unite(self, m: int, n: int, q, t) -> None:
        """Store m_T_n and unite the two sets, union(max, min) by rank."""
        self.rel[(m, n)] = (q, t)
        sx, sy = self.find(max(m, n)), self.find(min(m, n))
        if sx == sy:
            return
        if self.rank[sx] > self.rank[sy]:
            self.parent[sy] = sx
        else:
            self.parent[sx] = sy
            if self.rank[sx] == self.rank[sy]:
                self.rank[sy] += 1

    def pose(self, m: int, n: int):
        """m_T_n for two worlds of one set: stored, its inverse stored, or
        chained along a breadth-first path from n to m."""
        if m == n:
            return np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3)
        if (m, n) in self.rel:
            return self.rel[(m, n)]
        if (n, m) in self.rel:
            return nse3.pose_inv(*self.rel[(n, m)])
        adj = {}
        for a, b in self.rel:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, []).append(a)
        parent, todo = {n: None}, [n]
        for u in todo:                  # breadth first: todo grows behind
            for v in adj.get(u, ()):
                if v not in parent:
                    parent[v] = u
                    todo.append(v)
        path = [m]
        while parent[path[-1]] is not None:
            path.append(parent[path[-1]])
        q, t = np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3)
        for a, b in zip(path, path[1:]):
            qh, th = self.pose(a, b)
            q, t = nse3.pose_mul(q, t, qh, th)
        return q, t


def contacts(g, w: np.ndarray, order: np.ndarray, reg: Worlds, lo: int,
             hi: int) -> dict:
    """The first contacts of the loop edges order[lo:hi], in stream order,
    entered in `reg`; returns the worlds whose set the last of them
    changed, {world: (old set, new set)}."""
    changes = {}
    for k in order[lo:hi]:
        a, b = (int(v) for v in g.loop_pairs[k])
        wa, wb = int(w[a]), int(w[b])
        if wa < 0 or wb < 0 or wa == wb or reg.find(wa) == reg.find(wb):
            continue
        qa, ta = nse3.quat_normalize(g.vio_q[a]), g.vio_t[a]
        qb, tb = nse3.quat_normalize(g.vio_q[b]), g.vio_t[b]
        q, t = nse3.pose_mul(*nse3.pose_mul(qb, tb, nse3.quat_normalize(
            g.loop_q[k]), g.loop_t[k]), *nse3.pose_inv(qa, ta))
        before = reg.setmap()
        reg.unite(wb, wa, q, t)
        changes = {ww: (s0, s1) for ww, (s0, s1)
                   in enumerate(zip(before, reg.setmap())) if s0 != s1}
    return changes


@dataclasses.dataclass
class Trigger:
    """What a trigger over the first n nodes and e loop edges sees: its
    nodes' worlds, the registry after its edges' first contacts, the
    worlds whose set its last contact changed, and its stream order."""
    w: np.ndarray
    reg: Worlds
    changes: dict
    order: np.ndarray


def trigger(g, n: int, e: int, e0: int = 0) -> Trigger:
    """The trigger's worlds, its edges [e0, e) taken after [0, e0)."""
    w = node_worlds(g, n)
    order = generators.stream_order(g)
    reg = Worlds(int(max(w.max(initial=0), 0)) + 1)
    contacts(g, w, order, reg, 0, e0)
    changes = contacts(g, w, order, reg, e0, e)
    return Trigger(w, reg, changes, order)


# ---------------------------------------------------------------------------
# the trigger's start
# ---------------------------------------------------------------------------


def start(g, n: int, e: int, prev=None, switch_init: float = 0.99):
    """The state the trigger over the first n nodes and e loop edges
    starts from, by the 4-case table; `prev` is (q, t, s) that the solve
    before it wrote back, None for the session's first."""
    vq = nse3.quat_normalize(np.asarray(g.vio_q[:n], np.float64))
    vt = np.asarray(g.vio_t[:n], np.float64)
    m, e0 = (0, 0) if prev is None else (len(prev[0]), len(prev[2]))
    tr = trigger(g, n, e, e0)
    w, reg = tr.w, tr.reg
    valid = w >= 0
    q = np.zeros((n, 4))
    q[:, 3] = 1.0
    t = np.zeros((n, 3))
    s = np.full(e, float(switch_init))
    if prev is not None:
        live = valid[:m]
        q[:m][live] = np.asarray(prev[0], np.float64)[live]
        t[:m][live] = np.asarray(prev[1], np.float64)[live]
        s[:e0] = prev[2]
    su = m - 1 if prev is not None else 0
    su_world = int(w[su]) if n else 0
    if su_world < 0:
        su_world = -su_world - 1
    before = np.arange(n) <= su
    for ww in range(len(reg.parent)):
        mine = valid & (w == ww)
        if not mine.any():
            continue
        if ww in tr.changes:                                 # case 1
            c1 = mine & before
            if c1.any():
                qc, tc = reg.pose(tr.changes[ww][1], tr.changes[ww][0])
                qn, tn = nse3.pose_mul(np.broadcast_to(qc, q[c1].shape),
                                       np.broadcast_to(tc, t[c1].shape),
                                       q[c1], t[c1])
                q[c1], t[c1] = nse3.quat_normalize(qn), tn
        elif su == 0:                                        # case 2
            c2 = mine & before
            q[c2], t[c2] = vq[c2], vt[c2]
    q_l, t_l = nse3.pose_inv(vq[su], vt[su])
    q_s, t_s = q[su].copy(), t[su].copy()
    for ww in range(len(reg.parent)):
        fresh = valid & ~before & (w == ww)
        if not fresh.any():
            continue
        k = int(fresh.sum())
        if ww == su_world:                                   # case 3
            qd, td = nse3.pose_mul(np.broadcast_to(q_l, (k, 4)),
                                   np.broadcast_to(t_l, (k, 3)),
                                   vq[fresh], vt[fresh])
            qn, tn = nse3.pose_mul(np.broadcast_to(q_s, (k, 4)),
                                   np.broadcast_to(t_s, (k, 3)), qd, td)
        else:                                                # case 4
            qw, tw = reg.pose(reg.find(ww), ww)
            qn, tn = nse3.pose_mul(np.broadcast_to(qw, (k, 4)),
                                   np.broadcast_to(tw, (k, 3)),
                                   vq[fresh], vt[fresh])
        q[fresh], t[fresh] = nse3.quat_normalize(qn), tn
    return q, t, s


# ---------------------------------------------------------------------------
# the problem: posegraph.py's, over the live nodes, with a prior a set
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Problem:
    """posegraph.Problem over the nodes outside every dead zone, n of
    them (`live`, their indices among the trigger's n_all), and the
    counted loop edges (`keep` among the trigger's), with a prior on each
    node prior_i."""
    n: int
    n_all: int
    live: np.ndarray
    keep: np.ndarray
    odo_i: np.ndarray
    odo_j: np.ndarray
    odo_q: np.ndarray
    odo_t: np.ndarray
    odo_w: np.ndarray
    loop_a: np.ndarray
    loop_b: np.ndarray
    loop_q: np.ndarray
    loop_t: np.ndarray
    prior_i: np.ndarray         # (P,)
    prior_q: np.ndarray         # (P, 4)
    prior_t: np.ndarray
    prior_w: np.ndarray
    pattern: tuple | None = dataclasses.field(default=None, repr=False)


def priors(g, tr: Trigger, n: int):
    """(world, node, weight) of each soft anchor: the first node of each
    world that is its set's root, among the first n."""
    ends = kidnap_nodes(g)
    out = []
    for ww in range(len(tr.reg.parent)):
        hits = np.flatnonzero(tr.w == ww)
        if not len(hits) or tr.reg.find(ww) != ww:
            continue
        first = int(hits[0])
        last = min(ends[ww] if ww < len(ends) else n - 1, n - 1)
        out.append((ww, first,
                    max(1.1, math.log(1 + max(last - first, 0)) / 2.0)))
    return out


def build_problem(g, n: int, e: int, state, cfg: dict,
                  rounding=pg._identity) -> Problem:
    fml = cfg["formulation"]
    tr = trigger(g, n, e)
    valid = tr.w >= 0
    live = np.flatnonzero(valid)
    index = np.full(n, -1, np.int64)
    index[live] = np.arange(len(live))
    vq = nse3.quat_normalize(np.asarray(g.vio_q[:n], np.float64))
    vt = np.asarray(g.vio_t[:n], np.float64)
    ii, jj, oq, ot, ow = [], [], [], [], []
    for f in range(1, fml["fanout"] + 1):
        if n <= f:
            break
        both = valid[f:] & valid[:n - f]
        u = np.arange(f, n)[both]
        rq, rt = nse3.pose_relative(vq[u], vt[u], vq[u - f], vt[u - f])
        yaw = nse3.relative_yaw_deg(rq)
        ii.append(index[u])
        jj.append(index[u - f])
        oq.append(rq)
        ot.append(rt)
        ow.append(fml["decay"] ** f * np.exp(-yaw * yaw
                                             / fml["yaw_sigma2"]))
    cat = (lambda xs, shape: np.concatenate(xs) if xs else np.zeros(shape))
    order = tr.order[:e]
    la, lb = g.loop_pairs[order, 0], g.loop_pairs[order, 1]
    keep = valid[la] & valid[lb]
    anchors = priors(g, tr, n)
    pi = np.array([i for _, i, _ in anchors], np.int64)
    return Problem(
        n=len(live), n_all=n, live=live, keep=keep,
        odo_i=cat(ii, (0,)).astype(np.int64),
        odo_j=cat(jj, (0,)).astype(np.int64),
        odo_q=rounding(cat(oq, (0, 4))), odo_t=rounding(cat(ot, (0, 3))),
        odo_w=rounding(cat(ow, (0,))),
        loop_a=index[la[keep]], loop_b=index[lb[keep]],
        loop_q=rounding(nse3.quat_normalize(g.loop_q[order][keep])
                        .reshape(-1, 4)),
        loop_t=rounding(np.asarray(g.loop_t[order][keep], np.float64)
                        .reshape(-1, 3)),
        prior_i=index[pi],
        prior_q=rounding(np.asarray(state[0], np.float64)[pi]
                         .reshape(-1, 4)),
        prior_t=rounding(np.asarray(state[1], np.float64)[pi]
                         .reshape(-1, 3)),
        prior_w=rounding(np.array([x for _, _, x in anchors], np.float64)))


def _prior_res(p: Problem, q, t):
    dq, dt = nse3.pose_relative(p.prior_q, p.prior_t, q, t)
    return np.concatenate([dt, 2.0 * dq[..., :3]], axis=-1) \
        * p.prior_w[:, None]


def _cost(p: Problem, q, t, s) -> float:
    """The cost over the live nodes and counted edges."""
    r_o = pg._odo_res(p, q[p.odo_i], t[p.odo_i], q[p.odo_j], t[p.odo_j])
    r_l = pg._loop_res(p, q[p.loop_b], t[p.loop_b], q[p.loop_a],
                       t[p.loop_a], s)
    r_p = _prior_res(p, q[p.prior_i], t[p.prior_i])
    return 0.5 * float(np.sum(r_o * r_o) + np.sum(r_l * r_l)
                       + np.sum(r_p * r_p))


def cost(p: Problem, q, t, s) -> float:
    """0.5 * sum of squares of every residual, in float64, at a state of
    the trigger's nodes and loop edges."""
    q = np.asarray(q, np.float64)[p.live]
    t = np.asarray(t, np.float64)[p.live]
    s = np.asarray(s, np.float64)[p.keep]
    return _cost(p, q, t, s)


def linearize(p: Problem, q, t, s, rounding=pg._identity) -> pg._Linear:
    o_fn = (lambda a, b, c, d: pg._odo_res(p, a, b, c, d))
    r_o, Jo1, Jo2 = pg._jac_binary(o_fn, q[p.odo_i], t[p.odo_i],
                                   q[p.odo_j], t[p.odo_j])
    l_fn = (lambda a, b, c, d, e: pg._loop_res(p, a, b, c, d, e))
    qb, tb, qa, ta = q[p.loop_b], t[p.loop_b], q[p.loop_a], t[p.loop_a]
    r_l, Jl1, Jl2 = pg._jac_binary(l_fn, qb, tb, qa, ta, s)
    s_c = s.astype(complex) + 1j * pg._H
    Jls = pg._loop_res(p, qb.astype(complex), tb.astype(complex),
                       qa.astype(complex), ta.astype(complex),
                       s_c).imag / pg._H
    qp, tp = q[p.prior_i], t[p.prior_i]
    r_p = _prior_res(p, qp, tp)
    Jp = np.empty(r_p.shape + (6,))
    for k in range(6):
        a, b = pg._perturb(qp.astype(complex), tp.astype(complex), k)
        Jp[..., k] = _prior_res(p, a, b).imag / pg._H
    R = rounding
    return pg._Linear(R(r_o), R(Jo1), R(Jo2), R(r_l), R(Jl1), R(Jl2), R(Jls),
                      R(r_p), R(Jp))


def _step(p: Problem, lin: pg._Linear, radius: float):
    """posegraph._step with a prior on each node prior_i."""
    n, S, B = p.n, pg._scatter, pg._btb
    D = (S(p.odo_i, B(lin.Jo1, lin.Jo1), n) + S(p.odo_j, B(lin.Jo2, lin.Jo2), n)
         + S(p.loop_b, B(lin.Jl1, lin.Jl1), n)
         + S(p.loop_a, B(lin.Jl2, lin.Jl2), n)
         + S(p.prior_i, B(lin.Jp, lin.Jp), n))
    g = (S(p.odo_i, pg._btr(lin.Jo1, lin.r_odo), n)
         + S(p.odo_j, pg._btr(lin.Jo2, lin.r_odo), n)
         + S(p.loop_b, pg._btr(lin.Jl1, lin.r_loop), n)
         + S(p.loop_a, pg._btr(lin.Jl2, lin.r_loop), n)
         + S(p.prior_i, pg._btr(lin.Jp, lin.r_pri), n))
    O_odo = B(lin.Jo1, lin.Jo2)
    O_loop = B(lin.Jl1, lin.Jl2)
    hss = np.sum(lin.Jls * lin.Jls, axis=-1)
    h1s = pg._btr(lin.Jl1, lin.Jls)
    h2s = pg._btr(lin.Jl2, lin.Jls)
    gs = np.sum(lin.Jls * lin.r_loop, axis=-1)

    dn = np.diagonal(D, axis1=-2, axis2=-1)
    sn = 1.0 / (1.0 + np.sqrt(np.maximum(dn, 0)))
    ss = 1.0 / (1.0 + np.sqrt(np.maximum(hss, 0)))
    lm_n = np.clip(dn * sn ** 2, pg.MIN_LM_DIAG, pg.MAX_LM_DIAG) / radius
    lm_s = np.clip(hss * ss ** 2, pg.MIN_LM_DIAG, pg.MAX_LM_DIAG) / radius

    Dh = D * sn[:, :, None] * sn[:, None, :]
    Dh[:, np.arange(6), np.arange(6)] += lm_n
    gh = g * sn
    Oo = O_odo * sn[p.odo_i][:, :, None] * sn[p.odo_j][:, None, :]
    Ol = O_loop * sn[p.loop_b][:, :, None] * sn[p.loop_a][:, None, :]
    hh = hss * ss ** 2 + lm_s
    v1 = h1s * sn[p.loop_b] * ss[:, None]
    v2 = h2s * sn[p.loop_a] * ss[:, None]
    ghs = gs * ss
    w = 1.0 / hh[:, None, None]
    Dh -= (S(p.loop_b, v1[:, :, None] * v1[:, None, :] * w, n)
           + S(p.loop_a, v2[:, :, None] * v2[:, None, :] * w, n))
    Ol = Ol - v1[:, :, None] * v2[:, None, :] * w
    gh -= (S(p.loop_b, v1 * (ghs / hh)[:, None], n)
           + S(p.loop_a, v2 * (ghs / hh)[:, None], n))

    where, indices, indptr, nnz = pg._pattern(p)
    blocks = np.concatenate([Dh, Oo, np.swapaxes(Oo, 1, 2), Ol,
                             np.swapaxes(Ol, 1, 2)])
    H = pg.sp.csc_matrix((np.bincount(where, weights=blocks.ravel(),
                                      minlength=nnz), indices, indptr),
                         shape=(6 * n, 6 * n))
    dxh = pg.solve_spd(H, -gh.ravel()).reshape(n, 6)
    dsh = (-ghs - np.sum(v1 * dxh[p.loop_b], -1)
           - np.sum(v2 * dxh[p.loop_a], -1)) / hh
    dx = dxh * sn
    ds = dsh * ss

    Jd_o = (np.einsum("kri,ki->kr", lin.Jo1, dx[p.odo_i])
            + np.einsum("kri,ki->kr", lin.Jo2, dx[p.odo_j]))
    Jd_l = (np.einsum("kri,ki->kr", lin.Jl1, dx[p.loop_b])
            + np.einsum("kri,ki->kr", lin.Jl2, dx[p.loop_a])
            + lin.Jls * ds[:, None])
    Jd_p = np.einsum("kri,ki->kr", lin.Jp, dx[p.prior_i])
    gdx = np.sum(g * dx) + np.sum(gs * ds)
    quad = np.sum(Jd_o ** 2) + np.sum(Jd_l ** 2) + np.sum(Jd_p ** 2)
    return dx, ds, -(gdx + 0.5 * quad)


def solve(p: Problem, q0, t0, s0, *, max_iterations: int,
          function_tolerance: float, parameter_tolerance: float,
          initial_radius: float, precision: str = "fp64") -> pg.Solution:
    """posegraph.solve over the live nodes and counted edges (the
    parameters' norm of its stopping rule is theirs); the solution holds
    every node and edge of the trigger, the others as they started."""
    R = pg.ROUNDING[precision]
    q_all = nse3.quat_normalize(np.asarray(q0, np.float64))
    t_all = np.asarray(t0, np.float64).copy()
    s_all = np.asarray(s0, np.float64).copy()
    q, t, s = R(q_all[p.live]), R(t_all[p.live]), R(s_all[p.keep])
    c = _cost(p, q, t, s)
    radius, decrease = initial_radius, 2.0
    accepted = 0
    it = 0
    for it in range(1, max_iterations + 1):
        lin = linearize(p, q, t, s, R)
        dx, ds, model = _step(p, lin, radius)
        dx, ds = R(dx), R(ds)
        q_new = R(pg._exp_plus(q, dx[:, :3]))
        t_new = R(t + dx[:, 3:])
        s_new = R(s + ds)
        c_new = _cost(p, q_new, t_new, s_new)
        rho = (c - c_new) / model if model > 0 else -1.0
        if model > 0 and rho > 1e-3:
            x_norm = math.sqrt(np.sum(t * t) + np.sum(q * q) + np.sum(s * s))
            step = math.sqrt(np.sum(dx * dx) + np.sum(ds * ds))
            done = (abs(c - c_new) <= function_tolerance * c
                    or step <= parameter_tolerance * (x_norm
                                                      + parameter_tolerance))
            q, t, s, c = q_new, t_new, s_new, c_new
            radius = min(radius / max(1.0 / 3.0,
                                      1.0 - (2.0 * rho - 1.0) ** 3), 1e16)
            decrease = 2.0
            accepted += 1
            if done:
                break
        else:
            radius /= decrease
            decrease *= 2.0
            if radius < 1e-32:
                break
    q_all[p.live], t_all[p.live], s_all[p.keep] = q, t, s
    return pg.Solution(q=q_all, t=t_all, s=s_all, cost=c, iterations=it,
                       accepted=accepted)


# ---------------------------------------------------------------------------
# what harness/check.py asks of a configuration's reference
# ---------------------------------------------------------------------------


def trigger_start(cfg: dict, g, answer: dict):
    return start(g, answer["node_len"], answer["edge_len"], answer["prev"],
                 cfg["formulation"]["switch_init"])


def trigger_problem(cfg: dict, g, n: int, e: int, state,
                    precision: str = "fp64") -> Problem:
    """The first n keyframes and e loop edges in stream order, a prior on
    the first node of each set-root world at the start's pose."""
    return build_problem(g, n, e, state, cfg, pg.ROUNDING[precision])


def trigger_solve(cfg: dict, p: Problem, state,
                  precision: str = "fp64") -> pg.Solution:
    lm = cfg["formulation"]["lm"]
    return solve(p, *state, max_iterations=lm["max_iterations"],
                 function_tolerance=lm["function_tolerance"],
                 parameter_tolerance=lm["parameter_tolerance"],
                 initial_radius=lm["initial_radius"], precision=precision)

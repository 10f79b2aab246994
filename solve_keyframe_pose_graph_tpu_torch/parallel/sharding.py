"""Sharding of the pose-graph solve over a mesh of devices (counterpart of
solve_keyframe_pose_graph_tpu/parallel/sharding.py).

The node axis is trajectory-contiguous and the odometry band couples each
node only to its F predecessors, so shard i owns the contiguous node block
[i*nl, (i+1)*nl), nl = n_cap / P, and the band needs a halo of F nodes from
its left neighbour only. Loop edges are split into contiguous blocks of
el = e_cap / P; their endpoints are arbitrary, so a shard also holds ghost
rows for the endpoints it does not own. Priors are replicated; each shard
applies those on the nodes it owns.

A Mesh is an ordered list of torch devices in which a device may appear
more than once: several shards may share one card (the counterpart of the
JAX package's virtual CPU devices). One process drives every shard, as one
controller drives a JAX mesh; the collectives are in collectives.py.

Each shard holds a sub-Problem on its device whose local node order is

    [left halo: F nodes | owned: nl nodes | ghosts]

and whose edges are its edge block with local endpoints, so ops/gn.py's
assemblies run on it unchanged. Its ghost block has a fixed length, g_cap
= ghost_capacity(n_cap, e_cap, F, P): min(2 el, n_cap - nl), since a
shard's el edges have at most 2 el endpoints and at most n_cap - nl nodes
lie outside its block. So every shape of the split depends on the
capacity bucket and the mesh alone, never on where the loops land, and a
bucket's captured solve (ops/graphs.py) serves every graph of it. g_cap is
not rounded further: it is already a function of the bucket, and each pad
slot is carried by every gather, assembly and owner sum. The real ghosts
come first, sorted; the pad slots after them have the identity pose,
free_mask 0, masked odometry slots and no edge, and the ghost id of the
shard's first owned node, which the owner sums read as a pad row
(collectives.OwnerSum) and no edge reads.

In the sub-Problem every node carries node_mask 1 (the owner applies the
real mask after the exchange), the halo nodes' and ghosts' odometry slots
are masked (those edges belong to other shards), free_mask holds each
local node's real value (zero for shard 0's halo, as the single-device
shift fills zeros), shard 0's halo poses are the identity, and priors on
nodes the shard does not own are masked.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from solve_keyframe_pose_graph_tpu_torch.parallel.collectives import (
    OwnerSum,
)
from solve_keyframe_pose_graph_tpu_torch.parallel.sharded_lm import (
    ShardedOps,
)
from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
    FIELDS, Problem, loop_rows_by_node,
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shard i runs on devices[i]; a device may appear more than once."""

    devices: tuple

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The mesh's devices, each once, in rank order."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: int | None = None, *, device_type: str = "cuda",
              devices=None) -> Mesh:
    """A mesh of n_devices shards: the first n_devices cards (device_type
    "cuda"; all of them when n_devices is None), n_devices CPU shards
    ("cpu"), or the given `devices`, where a device may repeat (e.g.
    ["cuda:0"] * 4: four shards on one card). Raises when fewer cards exist
    than asked for: no mesh puts its shards on fewer cards than it names."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs or (n_devices is not None and len(devs) != n_devices):
            raise ValueError(f"mesh of {n_devices} shards asked for, "
                             f"{len(devs)} devices given")
        for d in devs:
            if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
                raise ValueError(f"mesh device {d} asked for, "
                                 f"{torch.cuda.device_count()} cuda devices "
                                 "available")
        return Mesh(devs)
    if device_type == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1))
    if device_type != "cuda":
        raise ValueError(f"device_type={device_type!r}; use cuda or cpu")
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n < 1 or n > have:
        raise ValueError(f"need {n} cuda devices for the mesh, have {have}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def engine_mesh(n_devices: int, device: torch.device,
                mesh=None) -> Mesh | None:
    """The mesh an entry point solves on: `mesh` if given (it must have
    n_devices shards, all on the device's type), else None for n_devices
    <= 1, else make_mesh(n_devices) on the device's type, which raises
    when there are fewer cards."""
    if mesh is not None:
        if len(mesh) != max(n_devices, 1):
            raise ValueError(f"mesh.n_devices={n_devices} but the mesh "
                             f"passed in has {len(mesh)} shards")
        if any(d.type != device.type for d in mesh.devices):
            raise ValueError(f"device {device} but the mesh passed in is on "
                             f"{[str(d) for d in mesh.distinct]}")
        return mesh
    if n_devices <= 1:
        return None
    return make_mesh(n_devices, device_type=device.type)


def split_sizes(n_cap: int, e_cap: int, fanout: int, P: int) -> tuple:
    """(nl, el), or ValueError when P does not divide the capacities or a
    node block is narrower than the band's halo."""
    if n_cap % P or e_cap % P:
        raise ValueError(f"a mesh of {P} shards must divide the node and "
                         f"edge capacities ({n_cap}, {e_cap})")
    nl = n_cap // P
    if nl < fanout:
        raise ValueError(f"node blocks of {nl} are narrower than the band "
                         f"halo ({fanout}): use fewer shards")
    return nl, e_cap // P


def ghost_capacity(n_cap: int, e_cap: int, fanout: int, P: int) -> int:
    """g_cap, the ghost rows of each shard (see the module note)."""
    nl, el = split_sizes(n_cap, e_cap, fanout, P)
    return min(2 * el, n_cap - nl)


@dataclasses.dataclass
class Layout:
    """How a mesh splits one graph (shared by ShardedProblem and
    sharded_pcg.pcg_sharded). Shard i owns nodes [i*nl, (i+1)*nl) and
    edges [i*el, (i+1)*el); ghosts[i] (long, (g_cap,), on its device)
    lists the global ids of its ghost nodes, sorted, then its pad slots'
    ids (the module note); loops[i] carries its edges with local
    endpoints (loop_b, loop_a, loop_rows_by_node: what
    gn.loop_matvec_t and gn.recover_switches_t read); owner_sum sums ghost
    rows into their owners."""

    mesh: Mesh
    fanout: int
    nl: int
    el: int
    ghosts: tuple
    loops: tuple
    owner_sum: OwnerSum


def _split_edges(loop_b, loop_a, live, nl: int, el: int, F: int, P: int,
                 g_cap: int):
    """Per shard: (ghost ids padded to g_cap, their real count, local b,
    local a) as numpy arrays. Ghosts are the live edges' endpoints outside
    the shard's block; a masked edge's endpoints map to the first owned
    node (its rows are zero)."""
    out = []
    for i in range(P):
        lo, hi = i * nl, (i + 1) * nl
        b, a = loop_b[i * el:(i + 1) * el], loop_a[i * el:(i + 1) * el]
        m = live[i * el:(i + 1) * el]
        ends = np.concatenate([b[m], a[m]])
        ghosts = np.unique(ends[(ends < lo) | (ends >= hi)])

        def local(ids):
            own = (ids >= lo) & (ids < hi)
            idx = np.where(own, F + ids - lo,
                           F + nl + np.searchsorted(ghosts, ids))
            return np.where(m, idx, F).astype(np.int32)

        padded = np.full(g_cap, lo, np.int64)
        padded[:len(ghosts)] = ghosts
        out.append((padded, len(ghosts), local(b), local(a)))
    return out


def edge_layout(loop_b, loop_a, n_cap: int, fanout: int, mesh: Mesh,
                live=None) -> Layout:
    """The Layout of a graph given only its loop endpoints (all live unless
    `live` says otherwise), with light per-shard loop topologies."""
    P = len(mesh)
    loop_b = np.asarray(loop_b.cpu(), np.int64)
    loop_a = np.asarray(loop_a.cpu(), np.int64)
    live = (np.ones(loop_b.shape, bool) if live is None
            else np.asarray(live.cpu()) > 0.5)
    nl, el = split_sizes(n_cap, loop_b.shape[0], fanout, P)
    g_cap = ghost_capacity(n_cap, loop_b.shape[0], fanout, P)
    split = _split_edges(loop_b, loop_a, live, nl, el, fanout, P, g_cap)
    ghosts, loops = [], []
    for i, (dev, (g, _, b, a)) in enumerate(zip(mesh.devices, split)):
        ghosts.append(torch.tensor(g, dtype=torch.long, device=dev))
        lb = torch.tensor(b, device=dev)
        la = torch.tensor(a, device=dev)
        m = torch.tensor(live[i * el:(i + 1) * el], device=dev)
        loops.append(SimpleNamespace(
            loop_b=lb, loop_a=la,
            loop_rows_by_node=loop_rows_by_node(lb, la, m.double(),
                                                fanout + nl + g_cap)))
    return Layout(mesh, fanout, nl, el, tuple(ghosts), tuple(loops),
                  OwnerSum(ghosts, nl, mesh.devices))


@dataclasses.dataclass
class ShardedProblem:
    """A Problem split over a mesh: subs[i] is shard i's sub-Problem (see
    the module note) on mesh.devices[i]; node_mask[i] its owned nodes' real
    mask; loop_b[i] / loop_a[i] its edges' global endpoints. The priors'
    global indices and real mask are kept for gather_problem."""

    mesh: Mesh
    layout: Layout
    subs: tuple
    node_mask: tuple
    loop_b: tuple
    loop_a: tuple
    prior_idx: torch.Tensor
    prior_mask: torch.Tensor
    _topology: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def fanout(self) -> int:
        return self.layout.fanout

    @property
    def n_cap(self) -> int:
        return self.layout.nl * len(self.mesh)

    @property
    def e_cap(self) -> int:
        return self.layout.el * len(self.mesh)

    @property
    def p_cap(self) -> int:
        return self.prior_idx.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.subs[0].dtype

    @property
    def device(self) -> torch.device:
        """Shard 0's device, where the LM scalars and results live."""
        return self.mesh.devices[0]

    def owned(self, i: int, x, dim: int = -1):
        """Shard i's owned block of a local-layout tensor."""
        F, nl = self.fanout, self.layout.nl
        return x.narrow(dim if dim >= 0 else x.dim() + dim, F, nl)

    # the layout protocol that ops/lm.py reads (solver/problem.Problem has
    # the single-device answers): n_shards, gathered, reshard, astype
    @property
    def n_shards(self) -> int:
        return len(self.mesh)

    def gathered(self) -> Problem:
        """The whole Problem on shard 0's device."""
        return gather_problem(self)

    def reshard(self, p: Problem) -> ShardedProblem:
        """Another Problem split over this mesh."""
        return shard_problem(p, self.mesh)

    def astype(self, dtype: torch.dtype) -> ShardedProblem:
        """The same split with each sub-Problem's float fields cast to
        `dtype` (the same halo and ghost layout)."""
        return dataclasses.replace(
            self, subs=tuple(s.astype(dtype) for s in self.subs),
            node_mask=tuple(m.to(dtype) for m in self.node_mask),
            prior_mask=self.prior_mask.to(dtype), _topology={})

    def lm_ops(self, **kw) -> ShardedOps:
        """The LM loop's operations over the mesh (lm.DeviceOps' methods)."""
        return ShardedOps(self, **kw)

    # the static-buffer protocol that ops/graphs.py reads (Problem has the
    # single-device answers): devices, leaves, static_copy, refresh
    @property
    def devices(self) -> tuple:
        """The device of each shard, in rank order."""
        return self.mesh.devices

    def leaves(self) -> tuple:
        """The tensors that a solve reads, in a fixed order: each
        sub-Problem's fields, the owned nodes' masks, the edges' global
        endpoints, the priors' indices and mask, and the ghost ids."""
        return (*(x for s in self.subs for x in s.leaves()),
                *self.node_mask, *self.loop_b, *self.loop_a, self.prior_idx,
                self.prior_mask, *self.layout.ghosts)

    def static_copy(self) -> ShardedProblem:
        """A copy whose leaves and derived buffers are its own: the
        sub-Problems' loop-row groupings, the owner sums' groupings and the
        gathered topology of each of the mesh's devices."""
        subs = tuple(s.static_copy() for s in self.subs)
        ghosts = tuple(g.clone() for g in self.layout.ghosts)
        layout = dataclasses.replace(
            self.layout, ghosts=ghosts, loops=subs,
            owner_sum=OwnerSum(ghosts, self.layout.nl, self.mesh.devices))
        sp = ShardedProblem(
            self.mesh, layout, subs,
            *(tuple(x.clone() for x in xs) for xs in (
                self.node_mask, self.loop_b, self.loop_a)),
            self.prior_idx.clone(), self.prior_mask.clone())
        for dev in self.mesh.distinct:            # built, then refreshed
            sp.topology(dev).loop_rows_by_node
        return sp

    def refresh(self) -> None:
        """Recompute, in place and with no host read, what the leaves
        determine: the sub-Problems' loop-row groupings, the owner sums'
        groupings and each gathered topology built so far."""
        for s in self.subs:
            s.refresh()
        self.layout.owner_sum.refresh()
        for dev, topo in self._topology.items():
            for d, v in zip(topo.leaves(),
                            gather_problem(self, dev).leaves()):
                d.copy_(v)
            topo.refresh()

    def topology(self, device) -> Problem:
        """The gathered Problem on `device`, built once (and refreshed by
        refresh()): the band+coarse preconditioners read its loop
        endpoints, loop_rows_by_node and free_mask (never its poses, which
        the solve does not update)."""
        device = torch.device(device)
        if device not in self._topology:
            self._topology[device] = gather_problem(self, device)
        return self._topology[device]


def _identity_poses(p: Problem, n: int) -> dict:
    """n identity poses: q (n, 4), t (n, 3)."""
    q = p.q.new_zeros((n, 4))
    q[:, 3] = 1.0
    return dict(q=q, t=p.t.new_zeros((n, 3)))


def _pad_odometry(p: Problem, width: int) -> dict:
    """Masked odometry slots: identity rotation, zero everything else."""
    F = p.fanout
    oq = p.odo_q.new_zeros((F, width, 4))
    oq[..., 3] = 1.0
    return dict(odo_q=oq, odo_t=p.odo_t.new_zeros((F, width, 3)),
                odo_w=p.odo_w.new_zeros((F, width)),
                odo_mask=p.odo_mask.new_zeros((F, width)))


def shard_problem(problem: Problem, mesh: Mesh) -> ShardedProblem:
    """Split `problem` over `mesh` (see the module note). Raises when the
    mesh size does not divide both capacities, or a node block is narrower
    than the band halo F. One host copy of the loop and prior indices."""
    P, F = len(mesh), problem.fanout
    nl, el = split_sizes(problem.n_cap, problem.e_cap, F, P)
    g_cap = ghost_capacity(problem.n_cap, problem.e_cap, F, P)
    lb = problem.loop_b.cpu().numpy().astype(np.int64)
    la = problem.loop_a.cpu().numpy().astype(np.int64)
    live = problem.loop_mask.cpu().numpy() > 0.5
    pidx = problem.prior_idx.cpu().numpy().astype(np.int64)
    split = _split_edges(lb, la, live, nl, el, F, P, g_cap)
    src = problem.device
    subs, masks, ends_b, ends_a = [], [], [], []
    for i, (dev, (ghosts, n_g, b, a)) in enumerate(zip(mesh.devices, split)):
        lo, hi = i * nl, (i + 1) * nl
        g = torch.tensor(ghosts[:n_g], dtype=torch.long, device=src)
        pad = _identity_poses(problem, F + g_cap - n_g)
        if i:
            hq, ht = problem.q[lo - F:lo], problem.t[lo - F:lo]
            hf = problem.free_mask[lo - F:lo]
        else:
            hq, ht = pad["q"][:F], pad["t"][:F]
            hf = problem.free_mask.new_zeros((F,))
        n_loc = F + nl + g_cap
        odo_halo, odo_ghost = _pad_odometry(problem, F), _pad_odometry(
            problem, g_cap)
        owns = (pidx >= lo) & (pidx < hi)
        e = slice(i * el, (i + 1) * el)
        fields = dict(
            q=torch.cat([hq, problem.q[lo:hi], problem.q[g],
                         pad["q"][F:]]),
            t=torch.cat([ht, problem.t[lo:hi], problem.t[g], pad["t"][F:]]),
            node_mask=problem.node_mask.new_ones((n_loc,)),
            free_mask=torch.cat([hf, problem.free_mask[lo:hi],
                                 problem.free_mask[g],
                                 problem.free_mask.new_zeros(g_cap - n_g)]),
            loop_b=torch.tensor(b), loop_a=torch.tensor(a),
            loop_q=problem.loop_q[e], loop_t=problem.loop_t[e],
            loop_w=problem.loop_w[e], loop_mask=problem.loop_mask[e],
            switch=problem.switch[e],
            prior_idx=torch.tensor(np.where(owns, F + pidx - lo, F)
                                   .astype(np.int32)),
            prior_q=problem.prior_q, prior_t=problem.prior_t,
            prior_w=problem.prior_w,
            prior_mask=problem.prior_mask * torch.tensor(owns, device=src),
        )
        for name in ("odo_q", "odo_t", "odo_w", "odo_mask"):
            fields[name] = torch.cat([odo_halo[name],
                                      getattr(problem, name)[:, lo:hi],
                                      odo_ghost[name]], dim=1)
        sub = Problem(**{n: fields[n].to(dev) for n in FIELDS})
        subs.append(sub)
        masks.append(problem.node_mask[lo:hi].to(dev))
        ends_b.append(problem.loop_b[e].to(dev))
        ends_a.append(problem.loop_a[e].to(dev))
    ghosts = tuple(torch.tensor(g, dtype=torch.long, device=d)
                   for (g, _, _, _), d in zip(split, mesh.devices))
    layout = Layout(mesh, F, nl, el, ghosts, tuple(subs),
                    OwnerSum(ghosts, nl, mesh.devices))
    return ShardedProblem(mesh, layout, tuple(subs), tuple(masks),
                          tuple(ends_b), tuple(ends_a), problem.prior_idx,
                          problem.prior_mask)


def gather_problem(sp: ShardedProblem, device=None) -> Problem:
    """The Problem that shard_problem split, on `device` (default: shard
    0's), bit for bit."""
    dev = torch.device(device) if device is not None else sp.device

    def cat(xs, dim=0):
        return torch.cat([x.to(dev) for x in xs], dim=dim)

    fields = dict(
        node_mask=cat(sp.node_mask), loop_b=cat(sp.loop_b),
        loop_a=cat(sp.loop_a), prior_idx=sp.prior_idx.to(dev),
        prior_mask=sp.prior_mask.to(dev))
    for name in ("q", "t", "free_mask"):
        fields[name] = cat([sp.owned(i, getattr(s, name), 0)
                            for i, s in enumerate(sp.subs)])
    for name in ("odo_q", "odo_t", "odo_w", "odo_mask"):
        fields[name] = cat([sp.owned(i, getattr(s, name), 1)
                            for i, s in enumerate(sp.subs)], dim=1)
    for name in ("loop_q", "loop_t", "loop_w", "loop_mask", "switch"):
        fields[name] = cat([getattr(s, name) for s in sp.subs])
    for name in ("prior_q", "prior_t", "prior_w"):
        fields[name] = getattr(sp.subs[0], name).to(dev)
    return Problem(**fields)

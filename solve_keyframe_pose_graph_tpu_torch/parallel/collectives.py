"""The mesh's collectives and its sharded vectors (counterpart of the
jax.lax collectives that solve_keyframe_pose_graph_tpu/parallel/
sharded_pcg.py places by hand and that GSPMD inserts for
parallel/sharding.py).

One process issues every shard's work, as one controller drives a JAX mesh.
A shard's tensors live on its device; a device may hold several shards.
Nodes are split into contiguous blocks, so a node vector's shard is a block
of its node axis.

Every sum here runs in rank order with no atomics, so a sharded solve
repeats bit for bit from run to run:
  * rank_sum: per-shard values added in rank order on shard 0's device
    (the psum of a scalar);
  * all_gather: the shards' blocks concatenated in rank order, once per
    distinct device (unshard: on one device);
  * left_halo / right_halo: the last / first w slices of the left / right
    neighbour's block (ppermute);
  * OwnerSum: rows that shards hold for nodes other shards own, summed
    into the owners in rank order (psum_scatter of a node vector).
"""

from __future__ import annotations

import operator

import numpy as np
import torch


def rank_sum(values) -> torch.Tensor:
    """values[0] + values[1] + ..., in that order, on values[0]'s device."""
    total = values[0]
    for v in values[1:]:
        total = total + v.to(total.device)
    return total


def _part(x, i: int, device):
    """Shard i's operand: a Shards' part, a 0-d tensor copied to the
    shard's device, a list or tuple element-wise, anything else as is."""
    if isinstance(x, Shards):
        return x.parts[i]
    if isinstance(x, torch.Tensor):
        if x.dim():
            raise TypeError(f"a sharded operation takes 0-d tensors beside "
                            f"sharded ones, got shape {tuple(x.shape)}")
        return x.to(device)
    if isinstance(x, (list, tuple)):
        return type(x)(_part(v, i, device) for v in x)
    return x


def _map(fn, args, kwargs=None):
    kwargs = kwargs or {}
    first = next(a for a in list(args) + list(kwargs.values())
                 if isinstance(a, Shards))
    return Shards(
        fn(*(_part(a, i, p.device) for a in args),
           **{k: _part(v, i, p.device) for k, v in kwargs.items()})
        for i, p in enumerate(first.parts))


_T = torch.Tensor
_ELEMENTWISE = frozenset((
    torch.where, torch.zeros_like, torch.add, torch.sub, torch.mul,
    torch.div, torch.neg, _T.add, _T.sub, _T.mul, _T.div, _T.neg,
    _T.__add__, _T.__radd__, _T.__sub__, _T.__rsub__, _T.__mul__,
    _T.__rmul__, _T.__truediv__, _T.__rtruediv__, _T.__neg__))


class Shards:
    """One tensor per shard, in rank order, each on its shard's device.

    Arithmetic and torch.where / torch.zeros_like run shard by shard (a 0-d
    tensor operand is copied to each shard's device); torch.sum of the
    whole is the rank_sum of the shards' sums, on shard 0's device. Any
    other torch function raises, since it might reduce or move data along
    the sharded axis. So the CG loop of ops/pcg.py and the LM loop of
    ops/lm.py run unchanged on sharded vectors."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)

    @property
    def device(self) -> torch.device:
        """Shard 0's device, where rank_sum leaves its results."""
        return self.parts[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def T(self) -> "Shards":
        return Shards(p.T for p in self.parts)

    def contiguous(self) -> "Shards":
        return Shards(p.contiguous() for p in self.parts)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.sum and len(args) == 1 and not kwargs:
            return rank_sum([torch.sum(p) for p in args[0].parts])
        if func in _ELEMENTWISE:
            return _map(func, args, kwargs)
        raise TypeError(f"{getattr(func, '__name__', func)} does not run "
                        "shard by shard")

    def __add__(self, other):
        return _map(operator.add, (self, other))

    def __radd__(self, other):
        return _map(operator.add, (other, self))

    def __sub__(self, other):
        return _map(operator.sub, (self, other))

    def __rsub__(self, other):
        return _map(operator.sub, (other, self))

    def __mul__(self, other):
        return _map(operator.mul, (self, other))

    def __rmul__(self, other):
        return _map(operator.mul, (other, self))

    def __truediv__(self, other):
        return _map(operator.truediv, (self, other))

    def __rtruediv__(self, other):
        return _map(operator.truediv, (other, self))

    def __neg__(self):
        return _map(operator.neg, (self,))


def distinct_devices(x: Shards) -> tuple:
    """The devices of x's shards, each once, in rank order."""
    return tuple(dict.fromkeys(p.device for p in x.parts))


def all_gather(x: Shards, dim: int = -1) -> dict:
    """{device: the shards' blocks concatenated along dim in rank order}
    for each distinct device of x."""
    return {dev: torch.cat([p.to(dev) for p in x.parts], dim=dim)
            for dev in distinct_devices(x)}


def unshard(x: Shards, dim: int = -1, device=None) -> torch.Tensor:
    """The shards' blocks concatenated along dim in rank order, on `device`
    (default: shard 0's)."""
    dev = device if device is not None else x.device
    return torch.cat([p.to(dev) for p in x.parts], dim=dim)


def _narrow(t, dim: int, start: int, w: int):
    return t.narrow(dim, start if start >= 0 else t.shape[dim] + start, w)


def left_halo(x: Shards, w: int, dim: int = -1, first=None) -> list:
    """Shard i's copy of the last w slices along dim of shard i-1's block;
    shard 0 gets `first`, or zeros."""
    out = []
    for i, p in enumerate(x.parts):
        if i:
            out.append(_narrow(x.parts[i - 1], dim, -w, w).to(p.device))
        elif first is not None:
            out.append(first)
        else:
            out.append(torch.zeros_like(_narrow(p, dim, 0, w)))
    return out


def right_halo(x: Shards, w: int, dim: int = -1) -> list:
    """Shard i's copy of the first w slices along dim of shard i+1's block;
    the last shard gets zeros."""
    n = len(x.parts)
    return [_narrow(x.parts[i + 1], dim, 0, w).to(p.device) if i + 1 < n
            else torch.zeros_like(_narrow(p, dim, 0, w))
            for i, p in enumerate(x.parts)]


class OwnerSum:
    """Sums the rows that shards hold for other shards' nodes into their
    owners. ghosts[r] lists, sorted, the global node ids for which shard r
    holds rows (none in its own block); node u belongs to shard u // nl.
    Called with one (len(ghosts[r]), C) tensor per shard, it returns one
    (nl, C) tensor per owner: row v the sum over r, in rank order, of shard
    r's row for node owner * nl + v, zero where no shard holds one. One
    fixed-order segment sum per owner, built once."""

    def __init__(self, ghosts, nl: int, devices):
        self.nl = nl
        self.devices = tuple(devices)
        self.plans = []
        for o, dev in enumerate(self.devices):
            pieces, ids = [], []
            for r, g in enumerate(ghosts):
                # ghosts are sorted, so those shard o owns are one slice
                a, b = np.searchsorted(g, [o * nl, (o + 1) * nl])
                if b > a:
                    pieces.append((r, int(a), int(b)))
                    ids.append(g[a:b] - o * nl)
            if not pieces:
                self.plans.append(None)
                continue
            local = np.concatenate(ids)
            order = np.argsort(local, kind="stable")   # rank order per node
            self.plans.append((
                pieces, torch.tensor(order, device=dev),
                torch.tensor(np.bincount(local, minlength=nl), device=dev)))

    def __call__(self, rows) -> list:
        out = []
        for plan, dev in zip(self.plans, self.devices):
            C = rows[0].shape[1:]
            if plan is None:
                out.append(torch.zeros((self.nl,) + C, dtype=rows[0].dtype,
                                       device=dev))
                continue
            pieces, order, counts = plan
            got = torch.cat([rows[r][a:b].to(dev) for r, a, b in pieces])
            out.append(torch.segment_reduce(got[order], "sum", lengths=counts,
                                            axis=0, unsafe=True))
        return out

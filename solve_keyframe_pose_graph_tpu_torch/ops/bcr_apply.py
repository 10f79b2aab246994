"""The preconditioner apply, once per CG iteration: the band part (the
block cyclic reduction's forward and backward passes over the factor of
ops/band.py) and, for "band+coarse", the additive coarse correction of
ops/coarse.py, on a (6, Nc) residual.

Source: csrc/bcr_apply.cu (CUDA C++ for sm_90a), one launch per reduction
pass: L forward passes (the last one also applies the root), L backward
passes (the last one stores into the (6, Nc) result and adds the coarse
term), one pass at L = 0; with a coarse level, one launch of the
aggregate sums before them and the dense Hc_inv product as one torch.mv.
It replaces no Pallas kernel: the JAX package's bcr_solve and coarse_apply
are XLA-fused jnp. What bounds it (bytes: 140.1 MB, 41.8 us an apply at the
30k bucket) and how it is laid out: see the note in the .cu file.

`precond_apply_plain` is its plain twin, the composition
band_precond_apply(fac, r.T).T + coarse_apply(...) that the port ran
before; a CPU tensor takes it, a CUDA tensor the kernels, which take
every super-node size d = 6 g <= MAX_D (g = the odometry fanout, 1..5).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from solve_keyframe_pose_graph_tpu_torch.ops import _kernels
from solve_keyframe_pose_graph_tpu_torch.ops import band as band_ops
from solve_keyframe_pose_graph_tpu_torch.ops import coarse as coarse_ops
from solve_keyframe_pose_graph_tpu_torch.ops.smallinv import (
    MAX_D, batch_stride,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PER_DTYPE = {
    # b, nodes, Nc, g, Aoinv, s, Co, s, Ce, s, root, s, out, h, d
    "forward": [_P, _I, _I, _I, _P, _L, _P, _L, _P, _L, _P, _L, _P, _I, _I,
                _P],
    # x', b, b_nodes, Nc, g, Aoinv, s, Co, s, Ce, s, out, out_nodes, yc,
    # free_mask, cg, h, d
    "backward": [_P, _P, _I, _I, _I, _P, _L, _P, _L, _P, _L, _P, _I, _P, _P,
                 _I, _I, _I, _P],
    # r, Nc, g, root, s, out, out_nodes, yc, free_mask, cg, m, d
    "root": [_P, _I, _I, _P, _L, _P, _I, _P, _P, _I, _I, _I, _P],
    # r, Nc, cg, M, rc
    "coarse_sum": [_P, _I, _I, _I, _P, _P],
}
_ENTRIES = {f"kpg_bcr_apply_{k}_{s}": v for k, v in _PER_DTYPE.items()
            for s in ("f32", "f64")}
INIT = "kpg_bcr_apply_init"      # once per device: the shared-memory opt-in
# the kernels' layouts of a pass's vectors: stacked (m, d), and the (6, Nc)
# node layout row-major (the residual's) or node-major ((Nc, 6) in memory)
STACKED, ROW_MAJOR, NODE_MAJOR = 0, 1, 2


class Coarse(NamedTuple):
    """The coarse correction's operands (ops/coarse.py coarse_apply)."""
    Hc_inv: torch.Tensor         # (6M, 6M)
    free_mask: torch.Tensor      # (Nc,)
    group: int                   # nodes per aggregate


def _laid_out(x: torch.Tensor, node_major: bool) -> torch.Tensor:
    return x.T.contiguous().T if node_major else x.contiguous()


def precond_apply_plain(fac: band_ops.BCRFactor, r: torch.Tensor,
                        coarse: Coarse | None = None,
                        node_major: bool = False) -> torch.Tensor:
    """The kernels' plain twin: the band part plus the coarse term, (6, Nc)
    laid out as precond_apply lays it out."""
    x = band_ops.band_precond_apply(fac, r.T).T
    if coarse is not None:
        x = x + coarse_ops.coarse_apply(coarse.Hc_inv, coarse.free_mask, r,
                                        coarse.group)
    return _laid_out(x, node_major)


def launches_per_apply(fac: band_ops.BCRFactor, coarse: bool) -> int:
    """The kernel launches of one apply on the card: two per reduction
    level (one at L = 0), and the aggregate sums with a coarse level."""
    return max(1, 2 * len(fac.levels)) + int(coarse)


def _check_args(fac, r, coarse) -> None:
    if r.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"precond_apply takes float32 or float64, got "
                        f"{r.dtype}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"precond_apply runs on cpu or cuda, not {r.device}")
    if r.dim() != 2 or r.shape[0] != 6:
        raise ValueError(f"r must be (6, Nc), got {tuple(r.shape)}")
    if not r.is_contiguous():
        raise ValueError("precond_apply takes a contiguous r")
    Nc, d = r.shape[1], fac.root_inv.shape[-1]
    if d != 6 * fac.group or not 0 < Nc <= fac.n_pad:
        raise ValueError(f"a factor of group {fac.group}, d {d} and "
                         f"{fac.n_pad} padded nodes does not take Nc = {Nc}")
    if d > MAX_D:
        raise ValueError(f"precond_apply takes d = 6 group <= {MAX_D}, got "
                         f"{d}")
    blocks = [fac.root_inv] + [b for lvl in fac.levels for b in lvl]
    tensors = blocks + (list(coarse[:2]) if coarse is not None else [])
    for t in tensors:
        if t.dtype != r.dtype:
            raise TypeError(f"precond_apply dtypes differ: r {r.dtype}, "
                            f"operand {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"precond_apply devices differ: r {r.device}, "
                             f"operand {t.device}")
    m = fac.n_pad // fac.group
    for Ainv, Co, Ce in fac.levels:
        want = (m // 2, d, d)
        if not tuple(Ainv.shape) == tuple(Co.shape) == tuple(Ce.shape) == want:
            raise ValueError(f"a level of {m} super-nodes takes blocks "
                             f"{want}, got {tuple(Ainv.shape)}, "
                             f"{tuple(Co.shape)}, {tuple(Ce.shape)}")
        m //= 2
    if tuple(fac.root_inv.shape) != (m, d, d):
        raise ValueError(f"the root takes {(m, d, d)} blocks, got "
                         f"{tuple(fac.root_inv.shape)}")
    if coarse is not None:
        M = -(-Nc // int(coarse.group))
        if tuple(coarse.Hc_inv.shape) != (6 * M, 6 * M) or \
                tuple(coarse.free_mask.shape) != (Nc,):
            raise ValueError(
                f"the coarse level of group {coarse.group} on {Nc} nodes "
                f"takes Hc_inv {(6 * M, 6 * M)} and free_mask ({Nc},), got "
                f"{tuple(coarse.Hc_inv.shape)}, "
                f"{tuple(coarse.free_mask.shape)}")
        if not coarse.free_mask.is_contiguous():
            raise ValueError("precond_apply takes a contiguous free_mask")


def precond_apply(fac: band_ops.BCRFactor, r: torch.Tensor,
                  coarse: Coarse | None = None,
                  node_major: bool = False) -> torch.Tensor:
    """M^-1 r for the band factor `fac` (plus the coarse correction when
    `coarse` is given) of a contiguous (6, Nc) residual r; returns a (6, Nc)
    tensor, contiguous, or with `node_major` the transpose of a contiguous
    (Nc, 6) one (a mesh slices it by nodes). Launches the kernels for CUDA
    tensors and runs the plain twin for CPU tensors; raises for a dtype,
    device, shape or layout they do not take. Counts its launches in
    `precond_apply.launches`."""
    _check_args(fac, r, coarse)
    if r.device.type == "cpu":
        return precond_apply_plain(fac, r, coarse, node_major)
    lib = _kernels.load("bcr_apply", _ENTRIES, init=INIT, device=r.device)
    with torch.cuda.device(r.device):
        return passes(Launcher(lib, r), fac, r, coarse, node_major)


precond_apply.launches = 0


def passes(launch, fac: band_ops.BCRFactor, r: torch.Tensor,
           coarse: Coarse | None, node_major: bool = False) -> torch.Tensor:
    """The apply as its sequence of passes, each a call of `launch`
    (Launcher: one kernel launch each), into buffers made here."""
    Nc, g = r.shape[1], fac.group
    d = 6 * g
    yc = fm = None
    cg = 0
    if coarse is not None:
        cg = int(coarse.group)
        rc = r.new_empty(coarse.Hc_inv.shape[0])
        launch.coarse_sum(r, cg, rc)
        yc, fm = torch.mv(coarse.Hc_inv, rc), coarse.free_mask
    out = (r.new_empty((Nc, 6)).T if node_major
           else torch.empty_like(r))
    to = NODE_MAJOR if node_major else ROW_MAJOR
    if not fac.levels:
        launch.root(r, g, fac.root_inv, out, to, yc, fm, cg)
        return out
    bs = [r]                          # each level's right-hand side
    for lvl, (Ainv, Co, Ce) in enumerate(fac.levels):
        last = lvl == len(fac.levels) - 1
        b = r.new_empty((Ainv.shape[0], d))     # b', or x_L on the last
        launch.forward(bs[-1], ROW_MAJOR if lvl == 0 else STACKED, Nc, g,
                       Ainv, Co, Ce,
                       fac.root_inv if last else None, b)
        bs.append(b)
    x = bs.pop()
    for lvl in reversed(range(len(fac.levels))):
        Ainv, Co, Ce = fac.levels[lvl]
        dst = out if lvl == 0 else r.new_empty((2 * Ainv.shape[0], d))
        launch.backward(x, bs[lvl], ROW_MAJOR if lvl == 0 else STACKED, Nc,
                        g, Ainv, Co, Ce, dst, to if lvl == 0 else STACKED, yc,
                        fm, cg)
        x = dst
    return out


def _blocks(A) -> tuple:
    """(pointer, batch stride in elements) of a batch of (d, d) blocks the
    kernels read in place: each block row-major and contiguous (as
    ops/lm.py band_factor leaves them), the blocks one uniform stride
    apart, pointer and stride 16-byte aligned."""
    s = batch_stride(A)
    if s is None or (A.data_ptr() | s * A.element_size()) % 16:
        raise ValueError(
            "precond_apply reads each factor block in place: row-major "
            "(d, d) blocks one uniform stride apart, 16-byte aligned; got "
            f"shape {tuple(A.shape)} strides {A.stride()} at "
            f"{A.data_ptr():#x}")
    return A.data_ptr(), s


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


class Launcher:
    """The kernels' launches for `passes` on r's device and dtype."""

    def __init__(self, lib: ctypes.CDLL, r: torch.Tensor):
        self.lib = lib
        self.sfx = "f32" if r.dtype == torch.float32 else "f64"
        self.stream = _kernels.stream_handle(r.device)

    def _call(self, kind: str, *args) -> None:
        entry = f"kpg_bcr_apply_{kind}_{self.sfx}"
        rc = getattr(self.lib, entry)(*args, self.stream)
        _kernels.check(self.lib, "bcr_apply", rc)
        _kernels.count_launch(precond_apply, entry)

    def coarse_sum(self, r, cg, rc) -> None:
        self._call("coarse_sum", r.data_ptr(), r.shape[1], cg,
                   rc.shape[0] // 6, rc.data_ptr())

    def root(self, r, g, root_inv, out, to, yc, fm, cg) -> None:
        self._call("root", r.data_ptr(), r.shape[1], g, *_blocks(root_inv),
                   out.data_ptr(), to, _ptr(yc), _ptr(fm), cg,
                   root_inv.shape[0], root_inv.shape[-1])

    def forward(self, b, nodes, Nc, g, Ainv, Co, Ce, root, out) -> None:
        pr, sr = _blocks(root) if root is not None else (None, 0)
        self._call("forward", b.data_ptr(), nodes, Nc, g, *_blocks(Ainv),
                   *_blocks(Co), *_blocks(Ce), pr, sr, out.data_ptr(),
                   Ainv.shape[0], Ainv.shape[-1])

    def backward(self, xe, b, b_nodes, Nc, g, Ainv, Co, Ce, out, out_nodes,
                 yc, fm, cg) -> None:
        self._call("backward", xe.data_ptr(), b.data_ptr(), b_nodes, Nc, g,
                   *_blocks(Ainv), *_blocks(Co), *_blocks(Ce),
                   out.data_ptr(), out_nodes, _ptr(yc), _ptr(fm), cg,
                   Ainv.shape[0], Ainv.shape[-1])

"""Kernel K1: the odometry-band part of the reduced matvec, entry-major.

Counterpart of solve_keyframe_pose_graph_tpu/ops/pallas_band.py
(band_matvec_pre, the Pallas TPU kernel _band_kernel). For D (36,N),
B (F,36,N) and x (6,N):

    y[i,u] = sum_j D[6i+j,u] x[j,u]
           + sum_f sum_j B[f,6i+j,u]     x[j,u-f-1]
           + sum_f sum_j B[f,6j+i,u+f+1] x[j,u+f+1]

Source: csrc/band_matvec.cu (CUDA C++ for sm_90a): a block per tile of 32
node columns stages its D tile, its B tile with the upper band's halo and
its x window in shared memory by asynchronous 16-byte copies issued before
any arithmetic, so each byte of D and B is read from device memory once and
the upper band is read from the staged halo; one thread per output. Any N
and F <= MAX_FANOUT; an N that is not a multiple of 4 (fp32) or 2 (fp64)
takes the same kernel with one element per copy. What bounds it: see the
note in that file. The plain version is gn.band_matvec_t.
"""

from __future__ import annotations

import ctypes

import torch

from solve_keyframe_pose_graph_tpu_torch.ops import _kernels
from solve_keyframe_pose_graph_tpu_torch.ops import gn

MAX_FANOUT = 32          # the contract; the kernel stages F in groups
_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRIES = {
    "kpg_band_matvec_f32": [_P, _P, _P, _P, _I, _I, _P],
    "kpg_band_matvec_f64": [_P, _P, _P, _P, _I, _I, _P],
    "kpg_band_matvec_aligned": [_P, _P, _P, _I, _I],
}
INIT = "kpg_band_matvec_init"   # once per device: the shared-memory opt-in


def band_matvec_plain(D, B, x):
    """K1's plain PyTorch version."""
    return gn.band_matvec_t(D, B, x)


def _check_args(D, B, x) -> None:
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"band_matvec takes float32 or float64, got {x.dtype}")
    if D.dtype != x.dtype or B.dtype != x.dtype:
        raise TypeError(f"band_matvec dtypes differ: D {D.dtype}, "
                        f"B {B.dtype}, x {x.dtype}")
    if D.device != x.device or B.device != x.device:
        raise ValueError(f"band_matvec devices differ: D {D.device}, "
                         f"B {B.device}, x {x.device}")
    if x.dim() != 2 or x.shape[0] != 6:
        raise ValueError(f"x must be (6, N), got {tuple(x.shape)}")
    N = x.shape[1]
    if tuple(D.shape) != (36, N):
        raise ValueError(f"D must be (36, {N}), got {tuple(D.shape)}")
    if B.dim() != 3 or tuple(B.shape[1:]) != (36, N) or B.shape[0] > MAX_FANOUT:
        raise ValueError(f"B must be (F <= {MAX_FANOUT}, 36, {N}), "
                         f"got {tuple(B.shape)}")
    if not (D.is_contiguous() and B.is_contiguous() and x.is_contiguous()):
        raise ValueError("band_matvec takes contiguous D, B and x")


def band_matvec(D, B, x):
    """y = (D + band(B)) x. Launches K1 for CUDA tensors; runs the plain
    version for CPU tensors; raises for anything the kernel does not take.
    Counts its launches in `band_matvec.launches`."""
    _check_args(D, B, x)
    if x.device.type == "cpu":
        return band_matvec_plain(D, B, x)
    if x.device.type != "cuda":
        raise ValueError(f"band_matvec runs on cpu or cuda, not {x.device}")
    lib = _kernels.load("band_matvec", _ENTRIES, init=INIT, device=x.device)
    entry = ("kpg_band_matvec_f32" if x.dtype == torch.float32
             else "kpg_band_matvec_f64")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(D.data_ptr(), B.data_ptr(), x.data_ptr(),
                                 y.data_ptr(), B.shape[0], x.shape[1],
                                 _kernels.stream_handle(x.device))
    _kernels.check(lib, "band_matvec", rc)
    _kernels.count_launch(band_matvec, entry)
    return y


band_matvec.launches = 0


def takes_16_byte_copies(D, B, x) -> bool:
    """Whether K1 stages these CUDA tensors with 16-byte copies (N a
    multiple of 16 bytes, aligned pointers) rather than one element per
    copy. Asks the kernel's own library, so it builds it."""
    lib = _kernels.load("band_matvec", _ENTRIES)
    return bool(lib.kpg_band_matvec_aligned(
        D.data_ptr(), B.data_ptr(), x.data_ptr(), x.element_size(),
        x.shape[1]))

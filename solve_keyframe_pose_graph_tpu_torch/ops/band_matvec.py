"""Kernel K1: the odometry-band part of the reduced matvec, entry-major.

Counterpart of solve_keyframe_pose_graph_tpu/ops/pallas_band.py
(band_matvec_pre, the Pallas TPU kernel _band_kernel). For D (36,N),
B (F,36,N) and x (6,N):

    y[i,u] = sum_j D[6i+j,u] x[j,u]
           + sum_f sum_j B[f,6i+j,u]     x[j,u-f-1]
           + sum_f sum_j B[f,6j+i,u+f+1] x[j,u+f+1]

Source: csrc/band_matvec.cu (CUDA C++ for sm_90a; one thread per node
column, coalesced entry-major loads, the upper band read in place so no
shifted copy of B is built, x staged with its halo in shared memory, any N).
What bounds it and why it is not tuned: see the note in that file. The plain
version is gn.band_matvec_t.
"""

from __future__ import annotations

import ctypes

import torch

from solve_keyframe_pose_graph_tpu_torch.ops import _kernels
from solve_keyframe_pose_graph_tpu_torch.ops import gn

MAX_FANOUT = 32          # the kernel's shared x window holds 2*F halo columns
_P = ctypes.c_void_p
_ENTRIES = {
    "kpg_band_matvec_f32": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P],
    "kpg_band_matvec_f64": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P],
}


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
    lib = _kernels.load("band_matvec", _ENTRIES)
    fn = (lib.kpg_band_matvec_f32 if x.dtype == torch.float32
          else lib.kpg_band_matvec_f64)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = fn(D.data_ptr(), B.data_ptr(), x.data_ptr(), y.data_ptr(),
                B.shape[0], x.shape[1], _kernels.stream_handle(x.device))
    _kernels.check(lib, "band_matvec", rc)
    _kernels.count_launch(band_matvec)
    return y


band_matvec.launches = 0

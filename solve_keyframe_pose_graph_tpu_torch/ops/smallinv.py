"""Batched small SPD inverses without pivoting, and kernel K2 (counterpart
of solve_keyframe_pose_graph_tpu/ops/smallinv.py).

The band factorization only inverts damped SPD blocks, so unpivoted
Gauss-Jordan is safe. `gauss_jordan_inv` and `block_gj_inv` are the plain
PyTorch forms (`gj_inv_plain` picks one); `gj_inv` wraps kernel K2, csrc/gj_inv.cu (CUDA C++ for
sm_90a, one warp per matrix with its columns in registers and the pivot
column broadcast by warp shuffles), which replaces the Pallas TPU kernel
pallas_gj_inv / _gj_pallas_kernel. What bounds K2 and how it is laid out:
see the note in the .cu file. `gj_inv_plain` is K2's plain version.

K2 reads a strided batch in place: each (d, d) matrix contiguous, the
matrices one uniform stride apart (`batch_stride`, the C entries' extra
argument), e.g. the odd blocks A[1::2] of the cyclic reduction. Its output
is contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from solve_keyframe_pose_graph_tpu_torch.ops import _kernels

MAX_D = 64               # a lane of K2 holds at most two of the d columns
_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRIES = {
    "kpg_gj_inv_f32": [_P, _P, _I, _I, ctypes.c_longlong, _P],
    "kpg_gj_inv_f64": [_P, _P, _I, _I, ctypes.c_longlong, _P],
}


def gauss_jordan_inv(A):
    """Inverse of a batch of SPD matrices A (..., d, d), no pivoting: d
    steps over a (..., d, 2d) tableau."""
    d = A.shape[-1]
    eye = torch.eye(d, dtype=A.dtype, device=A.device).expand(A.shape)
    buf = torch.cat([A, eye], dim=-1)              # (..., d, 2d)
    row_ids = torch.arange(d, device=A.device)[:, None]
    for k in range(d):
        rowk = buf[..., k:k + 1, :] / buf[..., k:k + 1, k:k + 1]
        colk = torch.where(row_ids == k, 0.0, buf[..., :, k:k + 1])
        buf = buf - colk * rowk                    # outer product update
        buf[..., k:k + 1, :] = rowk
    return buf[..., :, d:]


def block_gj_inv(A, b: int = 6):
    """Batched SPD inverse by BLOCK Gauss-Jordan with (b,b) pivot blocks:
    d/b steps, each a batched (b,b) inverse plus two block matmul updates.
    """
    d = A.shape[-1]
    if d % b:
        raise ValueError(f"block size {b} does not divide d = {d}")
    eye = torch.eye(d, dtype=A.dtype, device=A.device).expand(A.shape)
    buf = torch.cat([A, eye], dim=-1)              # (..., d, 2d)
    for k in range(d // b):
        r0 = k * b
        rows = buf[..., r0:r0 + b, :]              # (..., b, 2d)
        piv_inv = gauss_jordan_inv(rows[..., :, r0:r0 + b])
        rows = piv_inv @ rows                      # normalize block row
        cols = buf[..., :, r0:r0 + b].clone()      # (..., d, b)
        # the pivot block row is replaced below, not updated
        cols[..., r0:r0 + b, :] = 0.0
        buf = buf - cols @ rows
        buf[..., r0:r0 + b, :] = rows
    return buf[..., :, d:]


def gj_inv_plain(A):
    """K2's plain version: the blocked form where 6 divides d, the scalar
    form otherwise."""
    d = A.shape[-1]
    return block_gj_inv(A) if d % 6 == 0 else gauss_jordan_inv(A)


def batch_stride(A) -> int | None:
    """The uniform stride, in elements, between the (d, d) matrices of the
    batch A (..., d, d) when K2 can read it in place (every matrix
    contiguous, the leading dims one uniform stride apart); None when it
    cannot."""
    d = A.shape[-1]
    if d > 1 and (A.stride(-1) != 1 or A.stride(-2) != d):
        return None
    n = A.numel() // (d * d) if d else 0
    if n <= 1:
        return d * d
    try:
        return A.view(n, d, d).stride(0)
    except RuntimeError:                           # leading dims not uniform
        return None


def gj_inv(A):
    """Inverse of a batch of SPD blocks A (..., d, d), d <= 64, returned
    contiguous. Launches K2 for a CUDA tensor; runs the plain version for a
    CPU tensor; raises for anything the kernel does not take: a batch whose
    matrices are not each contiguous and one uniform stride apart (see
    batch_stride) raises on either device. Counts launches in
    `gj_inv.launches`."""
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gj_inv takes float32 or float64, got {A.dtype}")
    if A.dim() < 2 or A.shape[-1] != A.shape[-2] or not 1 <= A.shape[-1] <= MAX_D:
        raise ValueError(f"gj_inv takes (..., d, d) with 1 <= d <= {MAX_D}, "
                         f"got {tuple(A.shape)}")
    stride = batch_stride(A)
    if stride is None:
        raise ValueError(
            "gj_inv takes a batch of contiguous (d, d) matrices one uniform "
            f"stride apart, got shape {tuple(A.shape)} strides {A.stride()}")
    d = A.shape[-1]
    if A.device.type == "cpu":
        return gj_inv_plain(A).contiguous()
    if A.device.type != "cuda":
        raise ValueError(f"gj_inv runs on cpu or cuda, not {A.device}")
    n = A.numel() // (d * d)
    lib = _kernels.load("gj_inv", _ENTRIES)
    fn = (lib.kpg_gj_inv_f32 if A.dtype == torch.float32
          else lib.kpg_gj_inv_f64)
    out = torch.empty(A.shape, dtype=A.dtype, device=A.device)
    with torch.cuda.device(A.device):
        rc = fn(A.data_ptr(), out.data_ptr(), n, d, stride,
                _kernels.stream_handle(A.device))
    _kernels.check(lib, "gj_inv", rc)
    _kernels.count_launch(gj_inv)
    return out


gj_inv.launches = 0


def best_inv(A, b: int = 6):
    """Batched SPD inverse: K2 for a CUDA tensor with 12 <= d <= 64 (the
    band factorization's supernode blocks), the plain blocked or scalar
    Gauss-Jordan otherwise (the d = 6 jacobi blocks stay plain, as on the
    TPU). K2 reads a uniformly strided batch such as A[1::2] in place;
    any other layout is copied first."""
    d = A.shape[-1]
    if A.is_cuda and 12 <= d <= MAX_D:
        return gj_inv(A if batch_stride(A) is not None else A.contiguous())
    if d % b == 0:
        return block_gj_inv(A, b=b)
    return gauss_jordan_inv(A)

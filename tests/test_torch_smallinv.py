"""PyTorch port, kernel K2 (ops/smallinv.py): the plain Gauss-Jordan forms
and best_inv's CPU path against the JAX package's block_gj_inv and
np.linalg.inv. The reference's own K2 (pallas_gj_inv) runs only on a TPU,
and the CUDA kernel only on the card: chip_smoke.py holds it against the
plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu.ops import smallinv as jsi
from solve_keyframe_pose_graph_tpu_torch.ops import smallinv as tsi

from test_torch_threads import one_torch_thread  # noqa: F401

# relative to max|inverse|: fp64 the same math up to summation order; fp32
# bounded by the conditioning of the damped SPD blocks (~1e3 here)
RTOL = {np.float64: 1e-10, np.float32: 2e-4}


def spd_blocks(rng, n, d, dtype):
    """Damped SPD blocks like the band factorization's."""
    G = rng.normal(size=(n, d, d))
    A = G @ np.swapaxes(G, -1, -2) / d + 0.05 * np.eye(d)
    return A.astype(dtype)


def _close(got, ref, dtype):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=RTOL[dtype] * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("d", [6, 30])
def test_plain_inverses_match_reference(rng, d, dtype):
    A = spd_blocks(rng, 24, d, dtype)
    exact = np.linalg.inv(A.astype(np.float64))
    ref = np.asarray(jsi.block_gj_inv(jnp.asarray(A)))
    tA = torch.from_numpy(A)
    for got in (tsi.gauss_jordan_inv(tA), tsi.block_gj_inv(tA),
                tsi.best_inv(tA), tsi.gj_inv(tA)):
        assert got.dtype == tA.dtype and got.shape == tA.shape
        _close(got.numpy(), ref, dtype)
        _close(got.numpy(), exact, dtype)


def test_plain_inverse_batch_shapes(rng):
    A = spd_blocks(rng, 12, 12, np.float64).reshape(3, 4, 12, 12)
    got = tsi.gj_inv(torch.from_numpy(A))
    _close(got.numpy(), np.linalg.inv(A), np.float64)
    # d not a multiple of 6 takes the scalar Gauss-Jordan form
    B = spd_blocks(rng, 5, 7, np.float64)
    _close(tsi.best_inv(torch.from_numpy(B)).numpy(), np.linalg.inv(B),
           np.float64)


def test_gj_inv_wrapper_rejects_what_the_kernel_does_not_take(rng):
    A = torch.from_numpy(spd_blocks(rng, 4, 30, np.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tsi.gj_inv(A.transpose(-1, -2))
    with pytest.raises(ValueError, match="d <= 64"):
        tsi.gj_inv(torch.eye(66, dtype=torch.float64)[None])
    with pytest.raises(ValueError):
        tsi.gj_inv(A[..., :29])
    with pytest.raises(TypeError):
        tsi.gj_inv(A.to(torch.int64))
    before = tsi.gj_inv.launches
    tsi.gj_inv(A)                                # CPU: plain, no launch
    assert tsi.gj_inv.launches == before
    with pytest.raises(ValueError, match="does not divide"):
        tsi.block_gj_inv(A[..., :28, :28])

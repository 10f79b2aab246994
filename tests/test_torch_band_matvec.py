"""PyTorch port, kernel K1 (ops/band_matvec.py): its plain version against
the JAX package's Pallas kernel in interpret mode and its XLA form, the
wrapper's input checks, and the nvcc build plumbing of ops/_kernels.py.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it against
the plain version there."""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu.ops import pallas_band
from solve_keyframe_pose_graph_tpu_torch.ops import _kernels, band_matvec, gn

from test_torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-10      # fp64, only the summation order differs


def _inputs(rng, n, F):
    return (rng.normal(size=(36, n)), rng.normal(size=(F, 36, n)),
            rng.normal(size=(6, n)))


def _loop_ref(D, B, x):
    """Literal per-column sum of the K1 formula (zero outside [0, N))."""
    F, _, N = B.shape
    y = np.zeros((6, N))
    for u in range(N):
        for i in range(6):
            acc = sum(D[6 * i + j, u] * x[j, u] for j in range(6))
            for f in range(F):
                lo, hi = u - f - 1, u + f + 1
                if lo >= 0:
                    acc += sum(B[f, 6 * i + j, u] * x[j, lo] for j in range(6))
                if hi < N:
                    acc += sum(B[f, 6 * j + i, hi] * x[j, hi] for j in range(6))
            y[i, u] = acc
    return y


@pytest.mark.parametrize("n,F", [(256, 5), (512, 3), (384, 8)])
def test_plain_matches_pallas_interpret(rng, n, F):
    D, B, x = _inputs(rng, n, F)
    ref = np.asarray(pallas_band.band_matvec(
        jnp.asarray(D), jnp.asarray(B), jnp.asarray(x), block_n=128,
        interpret=True))
    got = band_matvec.band_matvec(*map(torch.from_numpy, (D, B, x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("n,F", [(256, 5), (130, 2)])
def test_plain_matches_reference_xla_form(rng, n, F):
    from solve_keyframe_pose_graph_tpu.ops import gn as jgn

    D, B, x = _inputs(rng, n, F)
    red = jgn.ReducedSystemT(Dh=jnp.asarray(D), Bh=jnp.asarray(B),
                             Aba_h=None, rhs_n=None, chb=None, cha=None,
                             ds_inv=None, rhs_s=None)

    class _P:
        fanout = F

    ref = np.asarray(jgn.band_matvec_t(red, _P, jnp.asarray(x)))
    got = band_matvec.band_matvec_plain(*map(torch.from_numpy, (D, B, x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("n,F", [(37, 5), (5, 5), (300, 1)])
def test_ragged_n_matches_literal_formula(rng, n, F):
    """The port takes any N (the TPU kernel needed N % block == 0)."""
    D, B, x = _inputs(rng, n, F)
    got = band_matvec.band_matvec(*map(torch.from_numpy, (D, B, x)))
    ref = _loop_ref(D, B, x)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=RTOL * np.abs(ref).max())


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    D, B, x = map(torch.from_numpy, _inputs(rng, 64, 5))
    with pytest.raises(ValueError, match="contiguous"):
        band_matvec.band_matvec(D, B, x.T.contiguous().T)
    with pytest.raises(TypeError):
        band_matvec.band_matvec(D, B, x.float())
    with pytest.raises(TypeError):
        band_matvec.band_matvec(D.int(), B.int(), x.int())
    with pytest.raises(ValueError, match="D must be"):
        band_matvec.band_matvec(D[:, :63], B, x)
    with pytest.raises(ValueError, match="B must be"):
        band_matvec.band_matvec(D, torch.zeros(33, 36, 64, dtype=D.dtype), x)
    with pytest.raises(ValueError, match=r"x must be"):
        band_matvec.band_matvec(D, B, x[:5])
    before = band_matvec.band_matvec.launches
    band_matvec.band_matvec(D, B, x)             # CPU: plain, no launch
    assert band_matvec.band_matvec.launches == before


def test_reduced_matvec_band_part_is_the_wrapper(rng, monkeypatch):
    """gn.reduced_matvec_t routes its band part through the K1 wrapper."""
    seen = []
    real = band_matvec.band_matvec

    def spy(D, B, x):
        seen.append(x.shape)
        return real(D, B, x)

    monkeypatch.setattr(band_matvec, "band_matvec", spy)
    n, e = 64, 8
    D, B, x = map(torch.from_numpy, _inputs(rng, n, 5))
    red = gn.ReducedSystemT(Dh=D, Bh=B, Aba_h=torch.zeros(36, e,
                                                         dtype=D.dtype),
                            rhs_n=None, chb=None, cha=None, ds_inv=None,
                            rhs_s=None)

    class _P:
        loop_a = torch.zeros(e, dtype=torch.int32)
        loop_b = torch.ones(e, dtype=torch.int32)
        # Problem.loop_rows_by_node: the a-side rows land on node 0, the
        # b-side rows on node 1
        loop_rows_by_node = (torch.cat([torch.arange(e, 2 * e),
                                        torch.arange(e)]),
                             torch.tensor([e, e] + [0] * (n - 2)))

    y = gn.reduced_matvec_t(red, _P, x)
    assert seen == [(6, n)]
    np.testing.assert_allclose(y.numpy(), gn.band_matvec_t(D, B, x).numpy())


def _fake_csrc(tmp_path, monkeypatch, body="int main() { return 0; }\n"):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text(body)
    monkeypatch.setattr(_kernels, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "_build"))
    return csrc


def test_library_path_follows_source_hash(tmp_path, monkeypatch):
    csrc = _fake_csrc(tmp_path, monkeypatch)
    p1 = _kernels.library_path("k")
    assert p1 == _kernels.library_path("k")
    assert os.path.dirname(p1) == str(tmp_path / "_build")
    (csrc / "k.cu").write_text("// edited\n")
    assert _kernels.library_path("k") != p1


def test_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    _fake_csrc(tmp_path, monkeypatch)
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_kernels, "find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _kernels.build("k")
    assert not os.path.exists(_kernels.library_path("k"))


def test_build_reuses_a_built_library(tmp_path, monkeypatch):
    _fake_csrc(tmp_path, monkeypatch)
    out = _kernels.library_path("k")
    os.makedirs(os.path.dirname(out))
    open(out, "w").close()

    def no_nvcc():
        raise AssertionError("must not compile an up-to-date library")

    monkeypatch.setattr(_kernels, "find_nvcc", no_nvcc)
    assert _kernels.build("k") == out


@pytest.mark.parametrize("n,F", [(4099, 1), (1027, 8), (70, 32)])
def test_wrapper_takes_n_not_a_multiple_of_4_and_f_up_to_the_limit(rng, n, F):
    """The kernel takes any N (one element per copy where N is not a
    multiple of 16 bytes) and F up to MAX_FANOUT; the wrapper passes both."""
    D, B, x = _inputs(rng, n, F)
    got = band_matvec.band_matvec(*map(torch.from_numpy, (D, B, x)))
    ref = _loop_ref(D, B, x)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=RTOL * np.abs(ref).max())
    assert F <= band_matvec.MAX_FANOUT


def test_wrapper_raises_on_other_devices(rng):
    D, B, x = (t.to("meta") for t in map(torch.from_numpy,
                                         _inputs(rng, 64, 5)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        band_matvec.band_matvec(D, B, x)

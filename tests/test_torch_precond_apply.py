"""PyTorch port, the preconditioner apply (ops/bcr_apply.py precond_apply):
on the CPU the plain twin and the kernels' pass sequence, run through a
CPU emulation of each kernel; the wrapper's input checks; and, on the card
alone (marker `card`), the kernels of csrc/bcr_apply.cu against the plain
twin at the main path's buckets and the launch count of a graphed solve.

On the card (this file imports no JAX; the suite's conftest.py does):
`python3 -m pytest tests/test_torch_precond_apply.py -m card --noconftest`.
"""

import itertools

import numpy as np
import pytest
import torch

from solve_keyframe_pose_graph_tpu_torch.ops import band as band_ops
from solve_keyframe_pose_graph_tpu_torch.ops import bcr_apply
from solve_keyframe_pose_graph_tpu_torch.ops import coarse as coarse_ops
from solve_keyframe_pose_graph_tpu_torch.ops import lm as lm_ops

from test_torch_threads import one_torch_thread  # noqa: F401

LEVELS = [0, 1, 2, 3, None]
GROUPS = range(1, 11)                  # d = 6 .. 60
DTYPES = [torch.float32, torch.float64]


def band_blocks(rng, Nc: int, F: int, dtype, device="cpu"):
    """Reduced blocks Dh (36, Nc), Bh (F, 36, Nc) of a diagonally dominant
    band: symmetric node blocks near 10 I, couplings of 0.1."""
    G = rng.normal(size=(Nc, 6, 6))
    D = 10.0 * np.eye(6) + 0.1 * (G + G.transpose(0, 2, 1))
    B = 0.1 * rng.normal(size=(F, Nc, 36))
    return (torch.tensor(D.reshape(Nc, 36).T.copy(), dtype=dtype,
                         device=device),
            torch.tensor(B.transpose(0, 2, 1).copy(), dtype=dtype,
                         device=device))


def coarse_level(rng, Nc: int, group: int, dtype, device="cpu"):
    """A coarse level's operands: an SPD Hc_inv, a 0/1 free mask."""
    M = -(-Nc // group)
    G = rng.normal(size=(6 * M, 6 * M))
    H = G @ G.T / (6 * M) + np.eye(6 * M)
    fm = (rng.random(Nc) > 0.2).astype(float)
    return bcr_apply.Coarse(torch.tensor(H, dtype=dtype, device=device),
                            torch.tensor(fm, dtype=dtype, device=device),
                            group)


def case(rng, g: int, levels, dtype, with_coarse: bool, Nc=None,
         device="cpu"):
    """(factor, r, coarse) with Nc not a multiple of the group by default."""
    Nc = 13 * g + 1 if Nc is None else Nc
    Dh, Bh = band_blocks(rng, Nc, g, dtype, device)
    fac = lm_ops.band_factor(Dh, Bh, levels)
    r = torch.tensor(rng.normal(size=(6, Nc)), dtype=dtype, device=device)
    coarse = coarse_level(rng, Nc, 8, dtype, device) if with_coarse else None
    return fac, r, coarse


def composition(fac, r, coarse):
    """What the port's callers computed before precond_apply."""
    x = band_ops.band_precond_apply(fac, r.T).T
    if coarse is not None:
        x = x + coarse_ops.coarse_apply(coarse.Hc_inv, coarse.free_mask, r,
                                        coarse.group)
    return x


def test_cpu_takes_the_plain_twin(rng, monkeypatch):
    """On the CPU precond_apply is the plain twin, bit for bit and laid out
    alike, and launches nothing."""
    monkeypatch.setattr(bcr_apply, "passes", None)
    before = bcr_apply.precond_apply.launches
    for levels, dtype, g in itertools.product(LEVELS, DTYPES, GROUPS):
        fac, r, coarse = case(rng, g, levels, dtype, True)
        for c, node_major in itertools.product((None, coarse),
                                               (False, True)):
            got = bcr_apply.precond_apply(fac, r, c, node_major)
            want = bcr_apply.precond_apply_plain(fac, r, c, node_major)
            assert torch.equal(got, want), (levels, g)
            assert got.stride() == ((1, 6) if node_major
                                    else (r.shape[1], 1))
            assert torch.equal(want, composition(fac, r, c))
    assert bcr_apply.precond_apply.launches == before


class Emulator:
    """Each kernel of csrc/bcr_apply.cu as torch operations on the CPU, on
    the same arguments as bcr_apply.Launcher's methods: a block of R
    consecutive outputs at a time, with y_{i-1} recomputed from Aoinv at
    the block's first output (y_{-1} = 0), reads and stores through the
    kernels' flat index of each layout (stacked s d + j; value j of
    super-node s is node u = s g + j // 6, row c = j % 6, at c Nc + u
    row-major or u 6 + c node-major, none for u >= Nc), the coarse term
    added in the last store. It records the launches."""

    def __init__(self, R: int):
        self.R = R
        self.launched = []

    @staticmethod
    def _flat(t):
        """t's memory as one dense vector, as the kernels address it."""
        return torch.as_strided(t, (t.numel(),), (1,))

    @staticmethod
    def _at(nodes, Nc, g, s, j):
        """The kernels' Layout::at: flat index, or -1 past Nc."""
        if nodes == bcr_apply.STACKED:
            return s * 6 * g + j
        u, c = s * g + j // 6, j % 6
        if u >= Nc:
            return -1
        return c * Nc + u if nodes == bcr_apply.ROW_MAJOR else u * 6 + c

    def _vec(self, b, nodes, Nc, g, s, m):
        """Super-node s's d-vector: zeros outside [0, m) or past Nc."""
        v = b.new_zeros(6 * g)
        if 0 <= s < m:
            flat = self._flat(b)
            for j in range(6 * g):
                k = self._at(nodes, Nc, g, s, j)
                if k >= 0:
                    v[j] = flat[k]
        return v

    def _store(self, out, nodes, Nc, g, s, x, yc, fm, cg):
        flat = self._flat(out)
        for j in range(x.shape[0]):
            k = self._at(nodes, Nc, g, s, j)
            if k < 0:
                continue
            v = x[j]
            if nodes != bcr_apply.STACKED and yc is not None:
                u = s * g + j // 6
                v = v + yc[(u // cg) * 6 + j % 6] * fm[u]
            flat[k] = v

    def _runs(self, h):
        for i0 in range(0, h, self.R):
            yield i0, range(i0, min(i0 + self.R, h))

    def coarse_sum(self, r, cg, rc):
        self.launched.append("coarse_sum")
        Nc = r.shape[1]
        for a in range(rc.shape[0] // 6):
            rc[6 * a:6 * a + 6] = r[:, a * cg:min((a + 1) * cg, Nc)].sum(1)

    def root(self, r, g, root_inv, out, to, yc, fm, cg):
        self.launched.append("root")
        Nc, m = r.shape[1], root_inv.shape[0]
        for _, run in self._runs(m):
            for s in run:
                v = self._vec(r, bcr_apply.ROW_MAJOR, Nc, g, s, m)
                self._store(out, to, Nc, g, s, root_inv[s] @ v, yc, fm, cg)

    def forward(self, b, nodes, Nc, g, Ainv, Co, Ce, root, out):
        self.launched.append("forward")
        h = Ainv.shape[0]
        for i0, run in self._runs(h):
            # y of outputs i0 - 1 .. the run's last, the first recomputed
            y = {i: (Ainv[i] @ self._vec(b, nodes, Nc, g, 2 * i + 1, 2 * h)
                     if i >= 0 else b.new_zeros(6 * g))
                 for i in range(i0 - 1, run[-1] + 1)}
            for i in run:
                v = (self._vec(b, nodes, Nc, g, 2 * i, 2 * h)
                     - Co[i].T @ y[i] - Ce[i] @ y[i - 1])
                out[i] = v if root is None else root[i] @ v

    def backward(self, xe, b, b_nodes, Nc, g, Ainv, Co, Ce, out, out_nodes,
                 yc, fm, cg):
        self.launched.append("backward")
        h = Ainv.shape[0]
        for _, run in self._runs(h):
            for i in run:
                bo = self._vec(b, b_nodes, Nc, g, 2 * i + 1, 2 * h)
                rhs = bo - Co[i] @ xe[i]
                if i + 1 < h:
                    rhs = rhs - Ce[i + 1].T @ xe[i + 1]
                for s, x in ((2 * i, xe[i]), (2 * i + 1, Ainv[i] @ rhs)):
                    self._store(out, out_nodes, Nc, g, s, x, yc, fm, cg)


@pytest.mark.parametrize("node_major", [False, True])
@pytest.mark.parametrize("with_coarse", [False, True])
@pytest.mark.parametrize("levels", LEVELS)
def test_kernel_passes_match_the_plain_twin(rng, levels, with_coarse,
                                            node_major):
    """The wrapper's pass sequence (buffers, level order, the root on the
    last forward pass, the node layouts at pass 0, the coarse term in the
    last store), each kernel emulated with runs of R = 1 .. 4 outputs
    (h not a multiple of R), equals the plain twin, laid out alike; its
    launches are launches_per_apply."""
    for g in GROUPS:
        fac, r, coarse = case(rng, g, levels, torch.float64, with_coarse)
        want = bcr_apply.precond_apply_plain(fac, r, coarse, node_major)
        for R in (1, 2, 3, 4):
            emu = Emulator(R)
            got = bcr_apply.passes(emu, fac, r, coarse, node_major)
            assert got.shape == want.shape
            assert got.stride() == want.stride()
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=0,
                atol=1e-12 * float(want.abs().max()), err_msg=f"g {g} R {R}")
            L = len(fac.levels)
            assert len(emu.launched) == bcr_apply.launches_per_apply(
                fac, with_coarse)
            assert emu.launched == (["coarse_sum"] * with_coarse
                                    + (["forward"] * L + ["backward"] * L
                                       if L else ["root"]))


def test_launches_per_apply():
    rng = np.random.default_rng(0)
    fac, _, _ = case(rng, 5, 2, torch.float64, False, Nc=8192)
    assert [len(fac.levels), fac.root_inv.shape[0]] == [2, 512]
    assert bcr_apply.launches_per_apply(fac, True) == 5
    assert bcr_apply.launches_per_apply(fac, False) == 4
    fac0, _, _ = case(rng, 5, 0, torch.float64, False, Nc=100)
    assert bcr_apply.launches_per_apply(fac0, True) == 2
    # d = 6 (odometry fanout 1) takes the kernels too
    fac1, _, _ = case(rng, 1, 2, torch.float64, False, Nc=40)
    assert fac1.root_inv.shape[-1] == 6
    assert bcr_apply.launches_per_apply(fac1, True) == 5


def test_band_factor_leaves_every_block_row_major(rng, monkeypatch):
    """A factor whose C blocks come column-major (as bcr_factorize's einsum
    leaves them on the card from level 1 on) reaches the apply row-major,
    the same values; a row-major level is kept as it is; at d = 6 every
    batch, the root's too, is one the kernels read."""
    real = band_ops.bcr_factorize

    def column_major_c(A, C, group, max_levels=None):
        fac = real(A, C, group, max_levels)
        return fac._replace(levels=tuple(
            (Ainv, Co.transpose(-1, -2).contiguous().transpose(-1, -2),
             Ce.transpose(-1, -2).contiguous().transpose(-1, -2))
            for Ainv, Co, Ce in fac.levels))

    Dh, Bh = band_blocks(rng, 64, 5, torch.float64)
    want = lm_ops.band_factor(Dh, Bh, 2)
    monkeypatch.setattr(band_ops, "bcr_factorize", column_major_c)
    got = lm_ops.band_factor(Dh, Bh, 2)
    # level 0's Co: every other block of the row-major C, read in place
    assert bcr_apply._blocks(want.levels[0][1])[1] == 2 * 36 * 25
    for lvl_got, lvl_want in zip(got.levels, want.levels, strict=True):
        for a, b in zip(lvl_got, lvl_want):
            assert bcr_apply._blocks(a)[1] == 36 * 25
            assert torch.equal(a, b)
    # d = 6: the plain inverse's strided blocks, the root's among them
    Dh, Bh = band_blocks(rng, 64, 1, torch.float64)
    monkeypatch.setattr(band_ops, "bcr_factorize", real)
    fac = lm_ops.band_factor(Dh, Bh, 2)
    for blocks in [fac.root_inv] + [b for lvl in fac.levels for b in lvl]:
        bcr_apply._blocks(blocks)


def test_wrapper_rejects_what_the_kernels_do_not_take(rng):
    fac, r, coarse = case(rng, 5, 2, torch.float64, True)
    Nc = r.shape[1]
    with pytest.raises(TypeError, match="float32 or float64"):
        bcr_apply.precond_apply(fac, r.half())
    with pytest.raises(TypeError, match="dtypes differ"):
        bcr_apply.precond_apply(fac, r.float())
    with pytest.raises(TypeError, match="dtypes differ"):
        bcr_apply.precond_apply(fac, r, coarse._replace(
            free_mask=coarse.free_mask.float()))
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        bcr_apply.precond_apply(fac, r.to("meta"))
    with pytest.raises(ValueError, match="devices differ"):
        bcr_apply.precond_apply(fac, r, coarse._replace(
            Hc_inv=coarse.Hc_inv.to("meta")))
    with pytest.raises(ValueError, match=r"r must be \(6, Nc\)"):
        bcr_apply.precond_apply(fac, r[:5])
    with pytest.raises(ValueError, match="does not take Nc"):
        bcr_apply.precond_apply(fac, torch.zeros(6, fac.n_pad + 1,
                                                 dtype=r.dtype))
    with pytest.raises(ValueError, match="contiguous r"):
        bcr_apply.precond_apply(fac, r.T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous free_mask"):
        bcr_apply.precond_apply(fac, r, coarse._replace(
            free_mask=torch.zeros(2 * Nc, dtype=r.dtype)[::2]))
    with pytest.raises(ValueError, match="coarse level"):
        bcr_apply.precond_apply(fac, r, coarse._replace(group=4))
    with pytest.raises(ValueError, match="the root takes"):
        bcr_apply.precond_apply(fac._replace(root_inv=fac.root_inv[1:]), r)
    with pytest.raises(ValueError, match="a level of"):
        bcr_apply.precond_apply(fac._replace(levels=fac.levels[1:]), r)
    big, r_big, _ = case(rng, 11, 1, torch.float64, False)
    with pytest.raises(ValueError, match=r"d = 6 group <= 64, got 66"):
        bcr_apply.precond_apply(big, r_big)


def test_blocks_are_read_in_place_or_refused():
    A = torch.zeros(8, 30, 30)
    assert bcr_apply._blocks(A) == (A.data_ptr(), 900)
    assert bcr_apply._blocks(A[1::2]) == (A[1::2].data_ptr(), 1800)
    B = torch.zeros(8, 6, 6)                                 # d = 6: 144 B
    assert bcr_apply._blocks(B[1::2]) == (B[1::2].data_ptr(), 72)
    with pytest.raises(ValueError, match="in place"):        # column-major
        bcr_apply._blocks(A.transpose(-1, -2))
    with pytest.raises(ValueError, match="in place"):        # 4-byte offset
        bcr_apply._blocks(A.view(-1)[1:1 + 7 * 900].view(7, 30, 30))
    with pytest.raises(ValueError, match="in place"):        # not a block
        bcr_apply._blocks(torch.zeros(4, 30, 60)[..., ::2])


def test_callers_take_precond_apply(rng, monkeypatch):
    """Every preconditioner with a band part goes through precond_apply:
    band, band+coarse (with its coarse term) and the two-grid's band."""
    seen = []
    real = bcr_apply.precond_apply

    def spy(fac, r, coarse=None):
        seen.append(coarse is not None)
        return real(fac, r, coarse)

    monkeypatch.setattr(bcr_apply, "precond_apply", spy)
    Nc = 64
    Dh, Bh = band_blocks(rng, Nc, 5, torch.float64)
    red = type("Red", (), dict(Dh=Dh, Bh=Bh,
                               Aba_h=torch.zeros(36, 4, dtype=Dh.dtype)))
    prob = type("P", (), dict(
        loop_b=torch.zeros(4, dtype=torch.long),
        loop_a=torch.zeros(4, dtype=torch.long), fanout=5,
        free_mask=torch.ones(Nc, dtype=Dh.dtype),
        loop_rows_by_node=None))
    r = torch.tensor(rng.normal(size=(6, Nc)))
    for kind, want in (("band", [False]), ("band+coarse", [True]),
                       ("band*coarse", [False])):
        ops = lm_ops.DeviceOps.__new__(lm_ops.DeviceOps)
        ops.preconditioner, ops.bcr_levels = kind, 2
        ops.coarse_group, ops.problem = 16, prob
        monkeypatch.setattr(
            lm_ops.coarse_ops, "build_coarse_inverse_arrays",
            lambda *a: (torch.eye(6 * (Nc // 16), dtype=Dh.dtype),
                        torch.zeros((), dtype=torch.int32)))
        seen.clear()
        apply, _ = ops.precond(red, lambda p: p)
        out = apply(r)
        assert seen == want and out.is_contiguous(), kind


# --- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/bcr_apply.cu runs only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# fp32: the kernels and cuBLAS sum each (d, d) product in another order,
# ~30 terms a product and three products a pass, four passes deep, on a
# factor of norm ~1: a few ulp of the result's largest value;
# fp64: the same at double precision.
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.card
@pytest.mark.parametrize("g", [5, 1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_cap,cg", [(8192, 64), (32768, 128)])
def test_kernels_match_the_plain_twin_on_the_card(card, n_cap, cg, dtype, g):
    """At the product's fanout (g = 5, d = 30) and at fanout 1 (d = 6), in
    both layouts of the result."""
    rng = np.random.default_rng(n_cap + g)
    for levels in (2, 0, 1, None):
        fac, r, _ = case(rng, g, levels, dtype, False, Nc=n_cap, device=card)
        coarse = coarse_level(rng, n_cap, cg, dtype, card)
        for c in (None, coarse):
            for node_major in (False, True):
                before = bcr_apply.precond_apply.launches
                got = bcr_apply.precond_apply(fac, r, c, node_major)
                want = bcr_apply.precond_apply_plain(fac, r, c, node_major)
                torch.cuda.synchronize()
                assert bcr_apply.precond_apply.launches - before == \
                    bcr_apply.launches_per_apply(fac, c is not None)
                assert got.stride() == want.stride()
                err = float((got - want).abs().max() / want.abs().max())
                assert err <= TOL[dtype], (levels, c is not None, err)


@pytest.mark.card
def test_a_graphed_solve_launches_the_apply_per_cg_and_lm_iteration(card):
    from solve_keyframe_pose_graph_tpu_torch.graph import synthetic
    from solve_keyframe_pose_graph_tpu_torch.solver.problem import (
        build_problem_np,
    )

    n, n_loops = 5000, 10000
    g = synthetic.circle_graph(n_nodes=n, n_loops=n_loops, seed=0,
                               outlier_fraction=0.2)
    prob = build_problem_np(
        q=g.vio_q, t=g.vio_t, vio_q=g.vio_q, vio_t=g.vio_t,
        node_valid=np.ones(n, bool), loop_pairs=g.loop_pairs,
        loop_q=g.loop_q, loop_t=g.loop_t, loop_w=g.loop_w,
        loop_valid=np.ones(n_loops, bool), switch=np.full(n_loops, 0.99),
        prior_idx=np.array([0]), prior_q=g.vio_q[:1], prior_t=g.vio_t[:1],
        prior_w=np.array([1.1]), n_cap=8192, e_cap=16384, p_cap=8,
        dtype=np.float32, device=card)
    kw = dict(max_iterations=10, preconditioner="band+coarse", bcr_levels=2,
              max_cg_iterations=45)
    lm_ops.lm_solve(prob, **kw)                 # captures the graphs
    before = bcr_apply.precond_apply.launches
    res = lm_ops.lm_solve(prob, **kw)
    torch.cuda.synchronize()
    per_apply = 2 * 2 + 1
    want = (int(res.total_cg_iterations) + int(res.iterations)) * per_apply
    assert bcr_apply.precond_apply.launches - before == want

"""ctypes binding for the native block-sparse LDL^T (native/kpg_ldl.cpp;
counterpart of solve_keyframe_pose_graph_tpu/solver/native_ldl.py).

The CPU Ceres-class linear solver: simplicial up-looking LDL^T over the
problem's 6x6 pose blocks (the algorithm class of Ceres'
SPARSE_NORMAL_CHOLESKY with the EIGEN_SPARSE backend — reference use at
/root/reference/src/PoseGraphSLAM.cpp:1270), with the symbolic analysis
reused across LM iterations. The port's host fp64 rung
(solver/cpu_rung.py) solves with it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_ROOT, "native", "libkpg_ldl.so")

c_i64 = ctypes.c_int64
c_ip = ctypes.POINTER(c_i64)
c_dp = ctypes.POINTER(ctypes.c_double)

_lib = None
# one build and load at a time: the engine's warm-up thread and a first
# escalation may both ask for the library of a fresh tree
_load_lock = threading.Lock()


def load_library(auto_build: bool = True):
    with _load_lock:
        return _load(auto_build)


def _load(auto_build: bool):
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and auto_build:
        subprocess.run(["make", "-C", os.path.join(_ROOT, "native")],
                       capture_output=True)
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.kpg_ldl_symbolic.restype = ctypes.c_void_p
    lib.kpg_ldl_symbolic.argtypes = [c_i64, c_ip, c_ip]
    lib.kpg_ldl_numeric.restype = ctypes.c_int
    lib.kpg_ldl_numeric.argtypes = [ctypes.c_void_p, c_dp]
    lib.kpg_ldl_solve.argtypes = [ctypes.c_void_p, c_dp]
    lib.kpg_ldl_nnz_blocks.restype = c_i64
    lib.kpg_ldl_nnz_blocks.argtypes = [ctypes.c_void_p]
    lib.kpg_ldl_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class BlockLDL:
    """Factor of a symmetric block matrix given as UPPER block-CSC
    (column k holds ascending block rows i <= k; block (i,k), i<k, is the
    upper block; diagonal blocks symmetric)."""

    def __init__(self, n_blocks: int, Ap: np.ndarray, Ai: np.ndarray):
        lib = load_library()
        if lib is None:
            raise RuntimeError("libkpg_ldl.so unavailable; "
                               "build with make -C native/")
        self._lib = lib
        self.n = int(n_blocks)
        self._Ap = np.ascontiguousarray(Ap, np.int64)
        self._Ai = np.ascontiguousarray(Ai, np.int64)
        self._h = ctypes.c_void_p(lib.kpg_ldl_symbolic(
            self.n, self._Ap.ctypes.data_as(c_ip),
            self._Ai.ctypes.data_as(c_ip)))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.kpg_ldl_free(h)
            self._h = None

    @property
    def nnz_blocks(self) -> int:
        return int(self._lib.kpg_ldl_nnz_blocks(self._h))

    def factor(self, Ax: np.ndarray) -> bool:
        """Ax: (nnzA, 6, 6) blocks aligned with the symbolic pattern."""
        Ax = np.ascontiguousarray(Ax, np.float64)
        rc = self._lib.kpg_ldl_numeric(self._h, Ax.ctypes.data_as(c_dp))
        return rc == 0

    def solve(self, b: np.ndarray) -> np.ndarray:
        """b: (n, 6). Returns x solving (L D L^T) x = b."""
        x = np.ascontiguousarray(b, np.float64).copy()
        self._lib.kpg_ldl_solve(self._h, x.ctypes.data_as(c_dp))
        return x


def _rcm_permutation(n: int, pairs: np.ndarray) -> np.ndarray:
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    if len(pairs) == 0:
        return np.arange(n, dtype=np.int64)
    i = np.concatenate([pairs[:, 0], pairs[:, 1], np.arange(n)])
    j = np.concatenate([pairs[:, 1], pairs[:, 0], np.arange(n)])
    ind = sp.coo_matrix((np.ones(len(i)), (i, j)), shape=(n, n)).tocsr()
    return np.asarray(reverse_cuthill_mckee(ind, symmetric_mode=True),
                      np.int64)


def fill_reducing_permutation(n: int, pairs: np.ndarray) -> np.ndarray:
    """Fill-reducing block permutation via SuperLU's MMD-on-A^T+A ordering
    of the block adjacency indicator (cheap at block counts: thousands)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    if len(pairs) == 0:
        return np.arange(n, dtype=np.int64)
    i = np.concatenate([pairs[:, 0], pairs[:, 1], np.arange(n)])
    j = np.concatenate([pairs[:, 1], pairs[:, 0], np.arange(n)])
    v = np.concatenate([np.full(2 * len(pairs), -0.1), np.full(n, float(n))])
    ind = sp.coo_matrix((v, (i, j)), shape=(n, n)).tocsc()
    lu = spla.splu(ind, permc_spec="MMD_AT_PLUS_A",
                   options=dict(SymmetricMode=True, DiagPivotThresh=0.0))
    return np.asarray(lu.perm_c, np.int64)


class BlockSystem:
    """Static-structure builder for the reduced (node-only) block system:
    given the unique off-diagonal block pairs, precomputes the permuted
    upper-CSC pattern and a slot mapping so each LM iteration only fills
    values (structure and symbolic analysis are reused).

    sources are (kind, index, transposed): kind 0 = diagonal block i,
    kind 1 = band block (f, u) [couples u row, u-f-1 col],
    kind 2 = loop block e [couples b row, a col].
    """

    def __init__(self, n: int, band_f: np.ndarray, band_u: np.ndarray,
                 loop_b: np.ndarray, loop_a: np.ndarray,
                 perm: Optional[np.ndarray] = None):
        self.n = n
        # raw contribution list: (row, col) in ORIGINAL block ids + source
        rows = [np.arange(n)]
        cols = [np.arange(n)]
        kinds = [np.zeros(n, np.int64)]
        if len(band_u):
            rows.append(band_u)
            cols.append(band_u - band_f - 1)
            kinds.append(np.ones(len(band_u), np.int64))
        if len(loop_b):
            rows.append(loop_b)
            cols.append(loop_a)
            kinds.append(np.full(len(loop_b), 2, np.int64))
        row = np.concatenate(rows)
        col = np.concatenate(cols)
        kind = np.concatenate(kinds)

        if perm is not None:
            candidates = [np.ascontiguousarray(perm, np.int64)]
        else:
            # candidate orderings; the symbolic analysis is cheap, so pick
            # the one with least block fill (chain-dominated graphs favor
            # RCM; loop-dense ones favor MMD — measured 3x fill swings)
            off = np.stack([row, col], -1)[kind > 0]
            candidates = [fill_reducing_permutation(n, off),
                          _rcm_permutation(n, off)]

        best = None
        for cand in candidates:
            built = self._build_pattern(n, row, col, cand)
            ldl = BlockLDL(n, built[0], built[1])
            if best is None or ldl.nnz_blocks < best[0]:
                best = (ldl.nnz_blocks, cand, built, ldl)
        _, self.perm, (self.Ap, self.Ai, self.slot, self.transposed,
                       self.nnz), self.ldl = best

    @staticmethod
    def _build_pattern(n, row, col, perm):
        """Permuted upper-CSC pattern + per-contribution slot mapping.
        A contribution couples (row -> col) with block M, meaning
        A[row, col] = M and A[col, row] = M^T; the upper entry at
        (min, max) of the permuted ids takes M or M^T accordingly."""
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        pr = inv[row]
        pc = inv[col]
        upper_r = np.minimum(pr, pc)
        upper_c = np.maximum(pr, pc)
        transposed = pr > pc

        key = upper_c * n + upper_r
        order = np.argsort(key, kind="stable")
        uniq, slot_of_sorted = np.unique(key[order], return_inverse=True)
        nnz = len(uniq)
        Ap = np.zeros(n + 1, np.int64)
        np.add.at(Ap, uniq // n + 1, 1)
        Ap = np.cumsum(Ap)
        Ai = (uniq % n).astype(np.int64)
        slot = np.empty(len(key), np.int64)
        slot[order] = slot_of_sorted
        return Ap, Ai, slot, transposed, nnz

    def fill(self, D: np.ndarray, Bh, band_f, Aba) -> np.ndarray:
        """Accumulate values: D (n,6,6), band blocks (K,6,6) (aligned with
        the band_u/band_f lists), Aba (E,6,6). Returns (nnz,6,6)."""
        vals = [D]
        if Bh is not None and len(Bh):
            vals.append(Bh)
        if Aba is not None and len(Aba):
            vals.append(Aba)
        contrib = np.concatenate(vals, axis=0)
        contrib = np.where(self.transposed[:, None, None],
                           np.swapaxes(contrib, -1, -2), contrib)
        Ax = np.zeros((self.nnz, 6, 6))
        np.add.at(Ax, self.slot, contrib)
        return Ax

    def solve(self, Ax: np.ndarray, rhs: np.ndarray
              ) -> Tuple[bool, np.ndarray]:
        """Factor + solve; rhs (n,6) in ORIGINAL block ids."""
        ok = self.ldl.factor(Ax)
        if not ok:
            return False, rhs
        x_p = self.ldl.solve(rhs[self.perm])
        x = np.empty_like(x_p)
        x[self.perm] = x_p
        return True, x

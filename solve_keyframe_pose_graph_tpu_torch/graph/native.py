"""ctypes binding for the native (C++) GraphStore core (counterpart of
solve_keyframe_pose_graph_tpu/graph/native.py, with a bounded
`node_worlds()`).

The reference's state store is compiled C++; ours is too (native/
kpg_store.cpp), with this thin binding exposing zero-copy numpy views.
`NativeGraphStore` is a drop-in replacement for graph.store.GraphStore: it
subclasses it, overrides the storage/mutation paths to delegate to the C
core, and presents the SoA buffers as numpy views so all inherited logic
(JSON persistence, world bookkeeping glue, composer access) works unchanged.

The reference's `node_worlds()` sizes its output from the node count it
reads in Python, then lets the C core write as many entries as the core's
own count, which a concurrent `add_node` may have raised in between: the C
side then writes past the end of the buffer. Here `node_worlds()` reads into
a buffer of the store's full hard reservation (`max_capacity`, which the core
never exceeds) and returns the prefix counted before the call, so every entry
it returns was written and no write can overflow. Every caller that holds a
store made here goes through it: the engine, the Composer, the viz sink and
the store's own world queries (`nodeidx_of_world_i_started`).

Build: `make -C native/` at the repo root, or
`python -m solve_keyframe_pose_graph_tpu_torch.graph.native` (builds
in-tree).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
from solve_keyframe_pose_graph_tpu_torch.graph.worlds import WorldRegistry

_LIB_NAME = "libkpg_store.so"
_lib = None


def _native_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "native")


def build_native(quiet: bool = True) -> str:
    """Compile the shared library; returns its path."""
    d = _native_dir()
    subprocess.run(["make", "-C", d],
                   check=True,
                   capture_output=quiet)
    return os.path.join(d, _LIB_NAME)


def load_library(auto_build: bool = True):
    """Load (building if needed) the native core; returns the ctypes lib or
    None when unavailable (callers fall back to the pure-numpy store)."""
    global _lib
    if _lib is not None:
        return _lib
    path = os.path.join(_native_dir(), _LIB_NAME)
    if not os.path.exists(path):
        if not auto_build:
            return None
        try:
            build_native()
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None

    c_i64 = ctypes.c_int64
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int64)
    sig = {
        "kpg_store_new": ([c_i64], ctypes.c_void_p),
        "kpg_store_new_max": ([c_i64, c_i64], ctypes.c_void_p),
        "kpg_store_free": ([ctypes.c_void_p], None),
        "kpg_add_node": ([ctypes.c_void_p, c_i64, c_dp, c_dp, c_dp], c_i64),
        "kpg_find_indexof_node": ([ctypes.c_void_p, c_i64], c_i64),
        "kpg_add_loop_edge": (
            [ctypes.c_void_p, c_i64, c_i64, c_dp, c_dp, ctypes.c_double],
            c_i64),
        "kpg_add_loop_edge_by_index": (
            [ctypes.c_void_p, c_i64, c_i64, c_dp, c_dp, ctypes.c_double],
            c_i64),
        "kpg_node_len": ([ctypes.c_void_p], c_i64),
        "kpg_edge_len": ([ctypes.c_void_p], c_i64),
        "kpg_ts_ptr": ([ctypes.c_void_p], c_ip),
        "kpg_q_ptr": ([ctypes.c_void_p], c_dp),
        "kpg_t_ptr": ([ctypes.c_void_p], c_dp),
        "kpg_cov_ptr": ([ctypes.c_void_p], c_dp),
        "kpg_ea_ptr": ([ctypes.c_void_p], c_ip),
        "kpg_eb_ptr": ([ctypes.c_void_p], c_ip),
        "kpg_eq_ptr": ([ctypes.c_void_p], c_dp),
        "kpg_et_ptr": ([ctypes.c_void_p], c_dp),
        "kpg_ew_ptr": ([ctypes.c_void_p], c_dp),
        "kpg_mark_kidnapped": ([ctypes.c_void_p, c_i64], ctypes.c_int),
        "kpg_mark_unkidnapped": ([ctypes.c_void_p, c_i64], ctypes.c_int),
        "kpg_is_kidnapped": ([ctypes.c_void_p], ctypes.c_int),
        "kpg_n_kidnap_starts": ([ctypes.c_void_p], c_i64),
        "kpg_n_kidnap_ends": ([ctypes.c_void_p], c_i64),
        "kpg_kidnap_starts_ptr": ([ctypes.c_void_p], c_ip),
        "kpg_kidnap_ends_ptr": ([ctypes.c_void_p], c_ip),
        "kpg_set_kidnap_data": (
            [ctypes.c_void_p, c_ip, c_i64, c_ip, c_i64, ctypes.c_int], None),
        "kpg_which_world": ([ctypes.c_void_p, c_i64], ctypes.c_int),
        "kpg_node_worlds": ([ctypes.c_void_p, c_ip], None),
    }
    for name, (argtypes, restype) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return _lib


def _as_dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _view(ptr, n, dtype, shape=None):
    if n == 0:
        return np.zeros(shape or (0,), dtype)
    size = int(np.prod(shape)) if shape else n
    buf = np.ctypeslib.as_array(ptr, shape=(size,))
    a = buf.view(dtype)
    return a.reshape(shape) if shape else a


class NativeGraphStore(GraphStore):
    """GraphStore backed by the C++ core (nodes/edges/kidnap/world timeline
    in native memory; worlds registry, descriptions, masks, JSON in Python,
    same as the reference keeps JSON outside its hot path)."""

    def __init__(self, initial_capacity: int = 1024,
                 max_capacity: int = 65536):
        lib = load_library()
        if lib is None:
            raise RuntimeError(
                "native core unavailable; build with make -C native/")
        self._lib = lib
        # buffers are reserved to max_capacity up front: the zero-copy numpy
        # views must never be invalidated by a reallocating append
        self._h = ctypes.c_void_p(lib.kpg_store_new_max(
            int(initial_capacity), int(max_capacity)))
        # the core reserves max(16, initial, max) node slots and never holds
        # more (native/kpg_store.cpp, Store::Store and kpg_add_node)
        self.max_capacity = max(16, int(initial_capacity), int(max_capacity))

        # python-side leftovers of the base class
        self._e_desc: List[str] = []
        self.edge_mask: List[bool] = []
        self.worlds = WorldRegistry()
        self.imu_T_cam_q: Optional[np.ndarray] = None
        self.imu_T_cam_t: Optional[np.ndarray] = None

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.kpg_store_free(h)
            self._h = None

    # ---------------- storage views ----------------

    @property
    def _n(self):
        return int(self._lib.kpg_node_len(self._h))

    @property
    def _e(self):
        return int(self._lib.kpg_edge_len(self._h))

    @property
    def _ts(self):
        n = self._n
        return _view(self._lib.kpg_ts_ptr(self._h), n, np.int64, (n,))

    @property
    def _q(self):
        n = self._n
        return _view(self._lib.kpg_q_ptr(self._h), n, np.float64, (n, 4))

    @property
    def _t(self):
        n = self._n
        return _view(self._lib.kpg_t_ptr(self._h), n, np.float64, (n, 3))

    @property
    def _cov(self):
        n = self._n
        return _view(self._lib.kpg_cov_ptr(self._h), n, np.float64, (n, 6, 6))

    @property
    def _e_a(self):
        e = self._e
        return _view(self._lib.kpg_ea_ptr(self._h), e, np.int64, (e,))

    @property
    def _e_b(self):
        e = self._e
        return _view(self._lib.kpg_eb_ptr(self._h), e, np.int64, (e,))

    @property
    def _e_q(self):
        e = self._e
        return _view(self._lib.kpg_eq_ptr(self._h), e, np.float64, (e, 4))

    @property
    def _e_t(self):
        e = self._e
        return _view(self._lib.kpg_et_ptr(self._h), e, np.float64, (e, 3))

    @property
    def _e_w(self):
        e = self._e
        return _view(self._lib.kpg_ew_ptr(self._h), e, np.float64, (e,))

    @property
    def kidnap_starts(self):
        n = int(self._lib.kpg_n_kidnap_starts(self._h))
        return [int(x) for x in _view(
            self._lib.kpg_kidnap_starts_ptr(self._h), n, np.int64, (n,))]

    @kidnap_starts.setter
    def kidnap_starts(self, v):
        self._set_kidnaps(v, self.kidnap_ends if hasattr(self, "_h") else [])

    @property
    def kidnap_ends(self):
        n = int(self._lib.kpg_n_kidnap_ends(self._h))
        return [int(x) for x in _view(
            self._lib.kpg_kidnap_ends_ptr(self._h), n, np.int64, (n,))]

    @kidnap_ends.setter
    def kidnap_ends(self, v):
        self._set_kidnaps(self.kidnap_starts if hasattr(self, "_h") else [], v)

    def _set_kidnaps(self, starts, ends, kidnapped=None):
        ks = np.asarray(list(starts), np.int64)
        ke = np.asarray(list(ends), np.int64)
        kd = self.current_kidnap_status if kidnapped is None else kidnapped
        self._lib.kpg_set_kidnap_data(
            self._h,
            ks.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(ks),
            ke.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(ke),
            1 if kd else 0)

    @property
    def current_kidnap_status(self):
        return bool(self._lib.kpg_is_kidnapped(self._h))

    @current_kidnap_status.setter
    def current_kidnap_status(self, v):
        if hasattr(self, "_h"):
            self._set_kidnaps(self.kidnap_starts, self.kidnap_ends, bool(v))

    # ---------------- mutations ----------------

    def add_node(self, t_ns: int, q, t, cov=None) -> int:
        q = np.ascontiguousarray(q, np.float64)
        t = np.ascontiguousarray(t, np.float64)
        covp = (None if cov is None
                else _as_dp(np.ascontiguousarray(cov, np.float64)))
        i = int(self._lib.kpg_add_node(self._h, int(t_ns), _as_dp(q),
                                       _as_dp(t), covp))
        if i == -2:
            raise RuntimeError("native store at hard node capacity")
        assert i >= 0, "non-monotonic node timestamp"
        if len(self.worlds.world_start_stamps) == 0:
            self.worlds.world_starts(int(t_ns))
        return i

    def find_indexof_node(self, t_ns: int) -> int:
        return int(self._lib.kpg_find_indexof_node(self._h, int(t_ns)))

    def add_loop_edge(self, t_ns_a, t_ns_b, q_b_T_a, t_b_T_a, weight,
                      description: str = ""):
        q = np.ascontiguousarray(q_b_T_a, np.float64)
        t = np.ascontiguousarray(t_b_T_a, np.float64)
        e = int(self._lib.kpg_add_loop_edge(
            self._h, int(t_ns_a), int(t_ns_b), _as_dp(q), _as_dp(t),
            float(weight)))
        if e == -2:
            raise RuntimeError("native store at hard edge capacity")
        if e < 0:
            return None
        self._e_desc.append(description)
        self.edge_mask.append(True)
        return e

    def add_loop_edge_by_index(self, ia, ib, q_b_T_a, t_b_T_a, weight,
                               description: str = "") -> int:
        q = np.ascontiguousarray(q_b_T_a, np.float64)
        t = np.ascontiguousarray(t_b_T_a, np.float64)
        e = int(self._lib.kpg_add_loop_edge_by_index(
            self._h, int(ia), int(ib), _as_dp(q), _as_dp(t), float(weight)))
        if e == -2:
            raise RuntimeError("native store at hard edge capacity")
        if e < 0:          # out-of-range node index (same contract as numpy)
            return None
        self._e_desc.append(description)
        self.edge_mask.append(True)
        return e

    def mark_as_kidnapped(self, t_ns: int) -> None:
        rc = self._lib.kpg_mark_kidnapped(self._h, int(t_ns))
        assert rc == 0, "can mark as kidnapped only when not kidnapped"
        self.worlds.world_ends(int(t_ns))

    def mark_as_unkidnapped(self, t_ns: int) -> None:
        rc = self._lib.kpg_mark_unkidnapped(self._h, int(t_ns))
        assert rc == 0, "can mark as unkidnapped only when kidnapped"
        self.worlds.world_starts(int(t_ns))

    # ---------------- timeline queries ----------------

    def which_world_is_this(self, t_ns: int) -> int:
        return int(self._lib.kpg_which_world(self._h, int(t_ns)))

    def node_worlds(self) -> np.ndarray:
        n = self._n                       # counted before the core writes
        out = np.empty(self.max_capacity, np.int64)
        self._lib.kpg_node_worlds(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out[:n]


def make_store(initial_capacity: int = 1024, native: Optional[bool] = None,
               max_capacity: int = 65536):
    """Factory: native store when available (or required), else numpy.
    max_capacity is the native store's hard buffer reservation (plumb
    CapacityConfig.max_nodes here; the numpy store grows dynamically and the
    engine enforces the ceiling at trigger time)."""
    max_capacity = max(int(max_capacity), int(initial_capacity))
    if native is False:
        return GraphStore(initial_capacity)
    if load_library(auto_build=bool(native)) is not None:
        try:
            return NativeGraphStore(initial_capacity, max_capacity)
        except RuntimeError:
            pass
    if native:
        raise RuntimeError("native store requested but unavailable")
    return GraphStore(initial_capacity)


if __name__ == "__main__":
    print(build_native(quiet=False))

"""The native (C++) graph store for the port, with a bounded
`node_worlds()` (counterpart of solve_keyframe_pose_graph_tpu/graph/
native.py, whose `NativeGraphStore` this subclasses).

The reference's `node_worlds()` sizes its output from the node count it
reads in Python, then lets the C core write as many entries as the core's
own count, which a concurrent `add_node` may have raised in between: the
C side then writes past the end of the buffer. This subclass reads into a
buffer of the store's full hard reservation (`max_capacity`, which the core
never exceeds) and returns the prefix counted before the call, so every
entry it returns was written and no write can overflow. Every caller that
holds a store made here goes through it: the engine, the Composer, the viz
sink and the store's own world queries (`nodeidx_of_world_i_started`).

The reference package and the native sources are left as they are.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from solve_keyframe_pose_graph_tpu.graph import native as _ref
from solve_keyframe_pose_graph_tpu.graph.native import (  # noqa: F401
    build_native, load_library,
)
from solve_keyframe_pose_graph_tpu.graph.store import GraphStore


class NativeGraphStore(_ref.NativeGraphStore):
    """The reference's native store with a `node_worlds()` that is safe
    against concurrent appends."""

    def __init__(self, initial_capacity: int = 1024,
                 max_capacity: int = 65536):
        super().__init__(initial_capacity, max_capacity)
        # the core reserves max(16, initial, max) node slots and never holds
        # more (native/kpg_store.cpp, Store::Store and kpg_add_node)
        self.max_capacity = max(16, int(initial_capacity), int(max_capacity))

    def node_worlds(self) -> np.ndarray:
        n = self._n                       # counted before the core writes
        out = np.empty(self.max_capacity, np.int64)
        self._lib.kpg_node_worlds(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out[:n]


def make_store(initial_capacity: int = 1024, native: Optional[bool] = None,
               max_capacity: int = 65536):
    """Factory with the reference's signature: the bounded native store
    when the library is available (or required), else the numpy store."""
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

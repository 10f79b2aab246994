"""The solve's device-resident loops (counterpart of jax.lax.while_loop in
the JAX package's lm_solve, ops/lm.py:634, and pcg_nodes, ops/pcg.py:104).

compose() takes the four captured pieces of a Program (ops/graphs.py:
init, pre, cg_iter, post) and the device addresses of the two loop
conditions, and returns an object whose launch(name) runs one of three
executables:

    init   the loop's first state;
    step   pre -> WHILE(cg) { cg_iter } -> post: one LM iteration whose CG
           loop ends on the device (the reference's chunk_fn at
           chunk_iters=1, lm.py:773-777);
    solve  init -> WHILE(lm) { step }: the whole solve in one launch (the
           reference's lm_solve_aot, lm.py:755).

A loop's condition is the reference's cond, !done && k < cap, on its loop
state (Cond: the done flag, the count and the cap, 0-d device tensors at
static addresses), tested before the first iteration as while_loop tests
it.

Source: csrc/graph_loops.cu (CUDA C++ for sm_90a): conditional WHILE nodes
(CUDA >= 12.4) whose bodies hold the pieces as child graphs and end in a
one-thread kernel that sets the condition from the loop state. The
executables run only on the card (the CPU solves eagerly: ops/graphs.py
on_card); a failure to build, compose, instantiate or launch raises.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import torch

from solve_keyframe_pose_graph_tpu_torch.ops import _kernels

NAMES = ("init", "step", "solve")
_P = ctypes.c_void_p
_ENTRIES = {
    "kpg_graph_loops_compose": [_P] * 10 + [ctypes.POINTER(_P)],
    "kpg_graph_loops_launch": [_P, _P],
    "kpg_graph_loops_destroy": [_P],
    "kpg_graph_loops_versions": [ctypes.POINTER(ctypes.c_int)] * 2,
}


class Cond(NamedTuple):
    """A loop's condition, !done && k < cap: 0-d device tensors, bool and
    int32, which the executables read at their addresses."""
    done: torch.Tensor
    k: torch.Tensor
    cap: torch.Tensor


def _destroy(lib, execs) -> None:
    for e in execs:
        if e:
            lib.kpg_graph_loops_destroy(e)


class DeviceLoops:
    """The three executables composed on the card (csrc/graph_loops.cu).
    The pieces' graphs, their memory pools and the conditions' tensors
    must outlive it: the executables write and read their addresses."""

    def __init__(self, lib, execs: dict, device: torch.device):
        self.lib, self.execs, self.device = lib, execs, device
        fin = weakref.finalize(self, _destroy, lib, list(execs.values()))
        fin.atexit = False

    def launch(self, name: str) -> None:
        with torch.cuda.device(self.device):
            rc = self.lib.kpg_graph_loops_launch(
                self.execs[name], _kernels.stream_handle(self.device))
        _kernels.check(self.lib, "graph_loops", rc)


def load() -> ctypes.CDLL:
    """The built and loaded library."""
    return _kernels.load("graph_loops", _ENTRIES)


def versions() -> dict:
    """The CUDA runtime the library was built with and the driver's
    version, as integers (12080 = 12.8)."""
    rt, drv = ctypes.c_int(), ctypes.c_int()
    lib = load()
    _kernels.check(lib, "graph_loops",
                   lib.kpg_graph_loops_versions(ctypes.byref(rt),
                                                ctypes.byref(drv)))
    return {"runtime": rt.value, "driver": drv.value}


def compose(pieces: dict, cg: Cond, lm: Cond, device: torch.device):
    """The init, step and solve executables of `pieces` ({"init", "pre",
    "cg_iter", "post"}: torch.cuda.CUDAGraph captured with
    keep_graph=True on the CUDA `device`) on the loop conditions cg and
    lm: a DeviceLoops, whose launch(name) for name in NAMES enqueues the
    executable on the current stream."""
    if device.type != "cuda":
        raise ValueError(f"graph_loops runs on a CUDA device, not {device}")
    lib = load()
    raw = [pieces[n].raw_cuda_graph() for n in ("init", "pre", "cg_iter",
                                                "post")]
    execs = (_P * 3)()
    with torch.cuda.device(device):
        rc = lib.kpg_graph_loops_compose(
            *raw, cg.done.data_ptr(), cg.k.data_ptr(), cg.cap.data_ptr(),
            lm.done.data_ptr(), lm.k.data_ptr(), lm.cap.data_ptr(), execs)
    _kernels.check(lib, "graph_loops", rc)
    return DeviceLoops(lib, dict(zip(NAMES, execs)), device)

"""Build and load the port's CUDA kernels (csrc/*.cu).

Each kernel source compiles, at first use, into its own shared library with
a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/lib<name>_<hash>.so csrc/<name>.cu

and is loaded with ctypes. The file name carries a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused. The build
directory `solve_keyframe_pose_graph_tpu_torch/_build/` is not versioned.
Nothing is built when a module is imported, and a missing or failing nvcc
raises with nvcc's own error output. A library's one-time set-up on a device
(`load(..., init=, device=)`) runs there before its first launch, so that a
launch makes no CUDA call but the launch itself and may be captured into a
CUDA graph (ops/graphs.py).

Launch counts: each wrapper counts its launches on itself (`launches`) and
by C entry point (ENTRY_LAUNCHES). A launch made while its thread captures a
graph does not run then: it goes into the capture's tally (capturing()),
which ops/graphs.py adds to the counts at each replay (add_launches).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_inited: set = set()                 # (library name, device index)
_tls = threading.local()
ENTRY_LAUNCHES: dict[str, int] = {}  # C entry point -> launches


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch."""


def is_device_error(exc: BaseException) -> bool:
    """True for a failure of a kernel or of the CUDA device itself, which no
    caller may log and carry on past."""
    return isinstance(exc, (KernelError, torch.cuda.OutOfMemoryError,
                            torch.AcceleratorError))


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda."""
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        candidates.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin",
                                          "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise KernelError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit")


def library_path(name: str) -> str:
    """Where the library built from csrc/<name>.cu lives."""
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library is already built; returns
    the library's path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    return out


def load(name: str, entries: dict[str, list], init: str | None = None,
         device: torch.device | None = None) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built on first call), with
    argtypes set for each entry point (all return an int CUDA error code)
    and for its `kpg_<name>_error_string`. With `init`, the library's
    set-up entry (no arguments) has run once on `device`."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
            for fn, argtypes in entries.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, f"kpg_{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        if init is not None and (name, device.index) not in _inited:
            fn = getattr(lib, init)
            fn.argtypes, fn.restype = [], ctypes.c_int
            with torch.cuda.device(device):
                check(lib, name, fn())
            _inited.add((name, device.index))
    return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a kernel's C entry returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, f"kpg_{name}_error_string")(rc).decode()
        raise KernelError(f"CUDA kernel {name} failed to launch: {msg} "
                           f"(cudaError {rc})")


def count_launch(wrapper, entry: str) -> None:
    """Count one launch of `wrapper` through C entry point `entry`: on the
    counters, or, while this thread captures a graph, in the capture's
    tally. A launch in a capture must have gone into the graph: one on a
    stream that is not capturing ran once, now, and raises rather than be
    counted at every replay. The counters' read-modify-write runs under a
    lock: the trigger, warmup and escalation threads all launch kernels."""
    tally = getattr(_tls, "tally", None)
    if tally is not None:
        if not torch.cuda.is_current_stream_capturing():
            raise KernelError(
                f"{entry} launched during a graph capture on a stream that "
                "is not capturing")
        tally[wrapper, entry] = tally.get((wrapper, entry), 0) + 1
    else:
        add_launches({(wrapper, entry): 1})


def add_launches(tally: dict) -> None:
    """Add a tally {(wrapper, entry): launches} to the counters."""
    with _count_lock:
        for (wrapper, entry), n in tally.items():
            wrapper.launches += n
            ENTRY_LAUNCHES[entry] = ENTRY_LAUNCHES.get(entry, 0) + n


@contextlib.contextmanager
def capturing():
    """Count this thread's launches into a tally, which the context yields,
    instead of on the counters: around the capture of a CUDA graph, whose
    launches run only when it is replayed."""
    tally: dict = {}
    _tls.tally = tally
    try:
        yield tally
    finally:
        _tls.tally = None


def stream_handle(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream

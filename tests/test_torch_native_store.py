"""PyTorch port: the bounded node_worlds() of the port's native store.

The reference store's node_worlds() can be written past its end by the C
core when a node is appended between the Python-side count and the C call.
The port's subclass reads into a buffer of the full reservation and returns
the prefix counted first. The stress test runs in a subprocess, so that a
heap corruption shows as a non-zero return code and not as a dead test
worker."""

import os
import subprocess
import sys

import numpy as np
import pytest

from solve_keyframe_pose_graph_tpu.graph import native as jnative
from solve_keyframe_pose_graph_tpu.utils import nse3
from solve_keyframe_pose_graph_tpu_torch.graph import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 1_000_000_000


@pytest.fixture(scope="module")
def native_lib():
    if native.load_library() is None:
        pytest.skip("libkpg_store.so cannot be built here")


def _kidnapped_store(cls):
    store = cls(16, 4096)
    t = 1000 * S
    for i in range(300):
        if i in (90, 200):
            store.kidnap_indicator(t, "kidnapped")
            t += S
        if i in (110, 230):
            store.kidnap_indicator(t, "unkidnapped")
            t += S
        store.add_node(t, nse3.quat_identity(), [float(i), 0, 0])
        t += S
    return store


def test_node_worlds_equals_reference_on_a_quiescent_store(native_lib):
    ref = _kidnapped_store(jnative.NativeGraphStore)
    got = _kidnapped_store(native.NativeGraphStore)
    want = ref.node_worlds()
    np.testing.assert_array_equal(got.node_worlds(), want)
    assert set(want.tolist()) == {0, -1, 1, -2, 2}
    assert got.max_capacity == 4096
    # the inherited world queries go through the bounded read too
    for w in range(got.n_worlds()):
        assert (got.nodeidx_of_world_i_started(w)
                == ref.nodeidx_of_world_i_started(w))


def test_make_store_picks_the_bounded_store(native_lib):
    assert type(native.make_store(native=True)) is native.NativeGraphStore
    assert type(native.make_store(native=False)).__name__ == "GraphStore"


_STRESS = r"""
import sys, threading
import numpy as np
sys.setswitchinterval(1e-6)
from solve_keyframe_pose_graph_tpu_torch.graph.native import NativeGraphStore
S = 1_000_000_000
store = NativeGraphStore(16, 1 << 16)
stop = threading.Event()

def writer():
    t = 1000 * S
    q = np.array([0.0, 0.0, 0.0, 1.0])
    for i in range(60000):
        if i % 997 == 500:
            store.kidnap_indicator(t, "kidnapped"); t += S
        elif i % 997 == 600:
            store.kidnap_indicator(t, "unkidnapped"); t += S
        store.add_node(t, q, [float(i), 0.0, 0.0]); t += S
    stop.set()

th = threading.Thread(target=writer)
th.start()
reads = 0
while not stop.is_set() or reads < 3000:
    w = store.node_worlds()
    assert w.ndim == 1 and len(w) <= store.node_len
    reads += 1
th.join(timeout=120)
assert not th.is_alive()
print(reads, store.node_len)
"""


def test_node_worlds_survives_concurrent_appends(native_lib):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _STRESS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, (out.returncode, out.stderr[-2000:])
    reads, n = map(int, out.stdout.split())
    assert reads >= 3000 and n == 60000

"""The repository's two configurations run as they did before a
configuration could bring its own generator, events, program settings
and reference: the plan file that stream._run writes, and the
store calls and socket bytes of its set-up, are the same byte for byte.

The digests were taken from the harness at commit bc94fc9: its own
stream._run's plan file (stopped where it starts the clients, the socket's
path replaced by "SOCKET"), and its set-up ingest's calls over the whole
head followed by the tail batches' bytes, recorded as Recorder does, at
the run's 51 s."""

from __future__ import annotations

import glob
import hashlib
import json
import os
import tempfile
import time

import numpy as np
import pytest

from conftest import ROOT
from port_bench.harness import manifest, stream

SECONDS = 51.0
SETUP_5K = "4340e9aa4fe9d52132447cab1149eb8be5edf5cd11682fed57b6824163314498"
SETUP_30K = "aa325ae6eaf918674e9ab5be4a9522c62079c43d62cf783679351215bf0b5bde"
PINNED = {
    ("stream5k_revisit", 2_147_483_659): (
        "b869e9e26a7ee12643901e47477402c1f2f111d9988605272f0287b42cc70509",
        SETUP_5K),
    ("stream5k_revisit", 4_000_000_007): (
        "ae2545fa59a8831e2cb4ff89431340e67ea1a99083703e6edabf32cf1bddc503",
        SETUP_5K),
    ("stream30k_revisit", 2_147_483_659): (
        "9800003ebe413edda1616cf5af20225794eeab1eaa264af10d72872a8097ac59",
        SETUP_30K),
    ("stream30k_revisit", 4_000_000_007): (
        "e4dbe1205558631b7bdef055d8a517a5180e0d8b5f4e179e74b6664cf94d6449",
        SETUP_30K),
}


class Recorder:
    """A store that hashes the calls it gets, and the bytes sent."""

    def __init__(self):
        self.h = hashlib.sha256()

    def _call(self, name, *args):
        self.h.update(json.dumps(
            [name] + [a.tolist() if isinstance(a, np.ndarray) else a
                      for a in args]).encode() + b"\n")

    def add_node(self, *args):
        self._call("add_node", *args)

    def add_loop_edge(self, *args):
        self._call("add_loop_edge", *args)

    def send(self, data: bytes):
        self.h.update(b"send\n" + data)


class _Stop(Exception):
    pass


def _cell(cell):
    bench = manifest.load()
    wl = manifest.workload(bench, cell)
    return (manifest.config(bench, wl["config"]),
            manifest.traffic(wl["traffic"]))


def _plan_digest(cell, seed, monkeypatch, tmp):
    """sha256 of the plan file that stream._run writes, stopped where it
    would start the clients."""
    def stop(*a, **kw):
        raise _Stop

    monkeypatch.setattr(tempfile, "tempdir", tmp)
    monkeypatch.setattr(stream.subprocess, "Popen", stop)
    with pytest.raises(_Stop):
        stream.run(cell, seed, SECONDS, False, t_start=time.monotonic(),
                   device="cpu", root=ROOT)
    [path] = glob.glob(os.path.join(tmp, "port_bench", "*.plan.json"))
    with open(path, "rb") as f:
        raw = f.read()
    sock = json.loads(raw)["socket"]
    return hashlib.sha256(
        raw.replace(json.dumps(sock).encode(), b'"SOCKET"')).hexdigest()


def _setup_digest(cell, seed):
    cfg, mix = _cell(cell)
    sch = stream.prepare(cfg, mix, seed, SECONDS)
    store = Recorder()
    stream.ingest(store, sch, 0, sch.head)
    for lines, query, _ in stream.tail_sends(sch):
        store.send(lines)
        store.send(query)
    return store.h.hexdigest()


@pytest.mark.parametrize("cell,seed", sorted(PINNED))
def test_plan_and_setup_are_the_pinned(cell, seed, monkeypatch, tmp_path):
    plan, setup = PINNED[cell, seed]
    assert _plan_digest(cell, seed, monkeypatch, str(tmp_path)) == plan
    assert _setup_digest(cell, seed) == setup


@pytest.mark.parametrize("cell", sorted({c for c, _ in PINNED}))
def test_settings_are_the_products_defaults(cell):
    from solve_keyframe_pose_graph_tpu_torch.config import Config
    cfg, _ = _cell(cell)
    assert cfg["settings"] == {}
    assert Config.from_json(stream._settings(cfg)) == Config()

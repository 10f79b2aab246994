"""PyTorch port: the live ingest server end to end over a Unix socket, as
tests/test_server.py:test_server_end_to_end, on the port's engine (CPU) and
its bounded native store, with a kidnap/unkidnap pair in the stream."""

import json
import socket
import threading
import time

import numpy as np

from solve_keyframe_pose_graph_tpu.graph import messages as msgs
from solve_keyframe_pose_graph_tpu.graph import synthetic
from solve_keyframe_pose_graph_tpu.utils import nse3
from solve_keyframe_pose_graph_tpu_torch.graph.native import make_store
from solve_keyframe_pose_graph_tpu_torch.runtime_server import (
    PoseGraphServer,
)

from test_torch_threads import one_torch_thread  # noqa: F401


def _ask(f, **query):
    f.write(json.dumps(dict(kind="query", **query)) + "\n")
    f.flush()
    return json.loads(f.readline())


def test_server_end_to_end(tmp_path):
    store = make_store()
    server = PoseGraphServer(store, save_dir=str(tmp_path / "ckpt"),
                             device="cpu")
    sock_path = str(tmp_path / "kpg.sock")
    th = threading.Thread(target=server.serve,
                          kwargs=dict(socket_path=sock_path, poll_hz=50.0),
                          daemon=True)
    th.start()
    for _ in range(100):
        time.sleep(0.05)
        try:
            probe = socket.socket(socket.AF_UNIX)
            probe.connect(sock_path)
            probe.close()
            break
        except OSError:
            continue

    g = synthetic.circle_graph(n_nodes=150, n_loops=20, seed=2)
    t0, dtn = 1_000_000_000, 100_000_000
    client = socket.socket(socket.AF_UNIX)
    client.connect(sock_path)
    f = client.makefile("rw")

    def send(msg):
        f.write(json.dumps(msg.to_json()) + "\n")

    # nodes 100-104 fall in a kidnap dead zone (a second world follows)
    for i in range(g.n_nodes):
        if i in (100, 105):
            send(msgs.KidnapIndicatorMsg(
                t0 + i * dtn - dtn // 2,
                "kidnapped" if i == 100 else "unkidnapped"))
        send(msgs.NodePoseMsg(t0 + i * dtn, g.vio_q[i], g.vio_t[i]))
    for e in range(g.n_loops):
        a, b = map(int, g.loop_pairs[e])
        send(msgs.LoopEdgeMsg(t0 + a * dtn, t0 + b * dtn, g.loop_q[e],
                              g.loop_t[e], float(g.loop_w[e])))
    f.flush()

    deadline = time.time() + 240
    st = {}
    while time.time() < deadline:
        st = _ask(f, what="status")
        if st["nodes"] == g.n_nodes and st["solved_until"] == g.n_nodes - 1:
            break
        time.sleep(0.25)
    assert st["solved_until"] == g.n_nodes - 1, st
    assert st["worlds"] == 2 and not st["kidnapped"]
    last = st["last_solve"]
    assert last["final_cost"] <= last["initial_cost"]

    traj = _ask(f, what="trajectory")
    assert traj["n"] == g.n_nodes and len(traj["t"]) == g.n_nodes
    assert set(traj["world_of"]) == {0, -1, 1}
    assert np.isfinite(np.asarray(traj["t"])).all()
    again = _ask(f, what="trajectory", version=traj["version"],
                 since_n=traj["n"])
    assert again["version"] == traj["version"] and again["from"] == traj["n"]
    pose = _ask(f, what="pose")
    assert pose["ok"] and len(pose["t"]) == 3
    path = _ask(f, what="path", frame="camera")
    assert path["n"] == g.n_nodes - 5

    q_ic = nse3.quat_normalize(np.asarray([0.0, 0.0, 0.1, 1.0]))
    send(msgs.ExtrinsicMsg(t0, q_ic, np.asarray([0.05, 0.0, 0.02])))
    f.flush()
    time.sleep(0.2)
    replies = []
    for k in range(2):
        send(msgs.ImuPropagateMsg(t0 + (200 + k) * dtn, nse3.quat_identity(),
                                  np.asarray([float(k), 0.0, 0.0])))
        f.flush()
        replies.append(json.loads(f.readline()))
    assert all(r["ok"] for r in replies), replies
    d = np.asarray(replies[1]["t"]) - np.asarray(replies[0]["t"])
    np.testing.assert_allclose(np.linalg.norm(d), 1.0, atol=1e-6)

    wt = _ask(f, what="world_transform", m=0, n=0)
    assert wt["ok"]
    np.testing.assert_allclose(np.asarray(wt["m_T_n"]), np.eye(4),
                               atol=1e-12)
    assert _ask(f, what="world_transform", m=0, n=7)["ok"] is False
    assert "error" in _ask(f, what="nonsense")

    f.write(json.dumps({"kind": "shutdown"}) + "\n")
    f.flush()
    assert json.loads(f.readline()).get("shutdown")
    client.close()
    th.join(timeout=120)
    assert not th.is_alive()
    assert (tmp_path / "ckpt" / "solved_posegraph.json").exists()


def test_server_stops_and_raises_when_the_solver_fails(tmp_path):
    """A kernel failure on the solver thread stops the server: serve()
    raises it instead of answering from a dead solver."""
    from solve_keyframe_pose_graph_tpu_torch.ops._kernels import KernelError

    server = PoseGraphServer(make_store(), device="cpu")

    def failing():
        raise KernelError("CUDA kernel gj_inv failed to launch")

    server.engine.trigger = failing
    raised = []

    def serve():
        try:
            server.serve(socket_path=str(tmp_path / "kpg.sock"))
        except KernelError as e:
            raised.append(e)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive() and len(raised) == 1

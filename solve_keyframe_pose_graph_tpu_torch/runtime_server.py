"""Live ingest server for the port (counterpart of
solve_keyframe_pose_graph_tpu/runtime_server.py, carried over with the
port's engine, Composer and an explicit solve device).

The wire is a Unix-domain socket carrying JSONL messages in the
graph.messages schema. The server runs the full pipeline:

  ingest thread(s): one per client connection, feeding the GraphStore
  solver thread:    SolverEngine.run() trigger loop
  status thread:    1 Hz StatusPrinter
  assembler thread: Composer.assemble() at stream.assembler_hz

Query protocol (client sends a JSON line, server replies one JSON line):
  {"kind": "query", "what": "status"}      -> pipeline status summary, with
                                              the threads' counters under
                                              "trace" (see _trace)
  {"kind": "query", "what": "trajectory"}  -> corrected trajectory (solved
                                              prefix + extrapolated suffix)
  {"kind": "query", "what": "pose"}        -> newest composed pose
  {"kind": "query", "what": "path"}        -> corrected poses, imu frame
  {"kind": "query", "what": "world_transform", "m": .., "n": ..}
  {"kind": "imu_propagate", ...}           -> 200 Hz compose path

Shutdown: {"kind": "shutdown"} (or KeyboardInterrupt); saves state when a
save_dir was given. Pass a store from graph.native.make_store: its
node_worlds() is safe under the concurrent ingest this server does.
"""

from __future__ import annotations

import json
import os
import socketserver
import threading
import time
from typing import Optional

import numpy as np

from solve_keyframe_pose_graph_tpu_torch.compose.composer import Composer
from solve_keyframe_pose_graph_tpu_torch.config import Config
from solve_keyframe_pose_graph_tpu_torch.graph import messages as msgs
from solve_keyframe_pose_graph_tpu_torch.solver.engine import SolverEngine
from solve_keyframe_pose_graph_tpu_torch.utils import nse3
from solve_keyframe_pose_graph_tpu_torch.utils.log import StatusPrinter, get_logger


def _pose_matrix_list(q, t):
    return [[float(v) for v in row] for row in nse3.pose_to_matrix(q, t)]


class PoseGraphServer:
    def __init__(self, store, config: Optional[Config] = None,
                 save_dir: Optional[str] = None,
                 load_dir: Optional[str] = None, device="cuda", mesh=None):
        self.store = store
        self.config = config or Config()
        self.engine = SolverEngine(store, self.config, device=device,
                                   mesh=mesh)
        self.composer = Composer(store, self.engine)
        self.save_dir = save_dir
        self.logger = get_logger("kpg-serve")
        self.status = StatusPrinter(store, self.engine, logger=self.logger)
        self._stop = threading.Event()
        self._ingest_lock = threading.Lock()
        # messages applied to the store, and their waits for _ingest_lock
        self.ingest_trace = {"messages": 0, "lock_wait_s": 0.0,
                             "lock_wait_max_s": 0.0}
        if load_dir:
            ok = self.composer.load_state_from_disk(load_dir)
            self.logger.info(f"load_state_from_disk({load_dir}) -> {ok}")

    # ------------------------------------------------------------------

    def handle_line(self, line: str) -> Optional[str]:
        """Apply one JSONL message; returns a reply line for queries."""
        obj = json.loads(line)
        kind = obj.get("kind")
        if kind == "query":
            return json.dumps(self._query(obj))
        if kind == "shutdown":
            self._stop.set()
            return json.dumps({"ok": True, "shutdown": True})
        if kind == "imu_propagate":
            # the 200 Hz serving path: answer immediately with the corrected
            # world-frame pose composed through the latest solved map — never
            # touches the graph and never waits for a solve
            # (Composer.cpp:848-943; wired at node.cpp:458-461)
            msg = msgs.message_from_json(obj)
            out = self.composer.imu_propagate(msg.q, msg.t)
            if out is None:
                return json.dumps({"ok": False, "t_ns": int(msg.t_ns)})
            q_o, t_o = out
            return json.dumps({
                "ok": True, "t_ns": int(msg.t_ns),
                "q": list(map(float, q_o)), "t": list(map(float, t_o)),
            })
        msg = msgs.message_from_json(obj)
        t0 = time.monotonic()
        with self._ingest_lock:   # serialize multi-client appends
            wait = time.monotonic() - t0
            tr = self.ingest_trace
            tr["messages"] += 1
            tr["lock_wait_s"] += wait
            if wait > tr["lock_wait_max_s"]:
                tr["lock_wait_max_s"] = wait
            msg.apply(self.store)
        return None

    def _trace(self) -> dict:
        """The threads' counters: the ingest threads' messages and
        _ingest_lock waits, the assembles and their hold of the engine's
        state_lock (Composer.trace), the solver loop's poll sleeps and its
        triggers refused while kidnapped (kidnap_polls), and
        under "phases" the engine's time by phase (PhaseTimer.snapshot:
        each part of the triggers so far, world_mapping, first_contact,
        initial_guesses, priors, device_solve with prepare, problem_build
        and to_host, write_back, the lock waits, collect and async_solve)."""
        eng = self.engine
        return {"ingest": dict(self.ingest_trace),
                "assembler": dict(self.composer.trace),
                "poll": {"sleeps": eng.poll_sleeps,
                         "sleep_s": eng.poll_sleep_s,
                         "kidnap_polls": eng.kidnap_polls},
                "phases": eng.timer.snapshot()}

    def _query(self, obj) -> dict:
        what = obj.get("what", "status")
        if what == "status":
            return {
                "nodes": self.store.node_len,
                "edges": self.store.edge_len,
                "worlds": self.store.n_worlds(),
                "kidnapped": self.store.current_kidnap_status,
                "solved_until": self.engine.solved_until,
                "solver_status": self.engine.status,
                "triggers": self.engine.trigger_id,
                "last_solve": (self.engine.solve_stats[-1]
                               if self.engine.solve_stats else None),
                "trace": self._trace(),
            }
        if what == "trajectory":
            # incremental protocol: the client echoes the last reply's
            # "version" plus "since_n"; while the version is unchanged (no
            # solve landed and no world merged) the already-sent prefix is
            # still valid and only nodes >= since_n are returned. On a
            # version change the full trajectory is re-sent. Reads the
            # assembler thread's snapshot — no per-query O(N) assemble. The
            # version is the SNAPSHOT's own stamp (set inside assemble()
            # under engine.state_lock): recomputing it here from live
            # engine/store state could stamp pre-solve poses with a
            # post-solve version, leaving clients on a stale prefix.
            comp = self.composer.latest
            if comp is None:
                comp = self.composer.assemble()
            if comp is None:
                return {"n": 0, "from": 0, "version": ""}
            version = comp.version
            start = 0
            if obj.get("version") == version:
                start = max(0, min(int(obj.get("since_n", 0)), len(comp.t)))
            return {
                "n": len(comp.t),
                "from": start,
                "version": version,
                "t": np.asarray(comp.t[start:]).tolist(),
                "q": np.asarray(comp.q[start:]).tolist(),
                "world_of": np.asarray(comp.world_of[start:]).tolist(),
            }
        if what == "pose":
            # cheap: read the assembler thread's latest snapshot (assemble
            # on demand only before the first tick)
            if self.composer.latest is None:
                self.composer.assemble()
            idx, q, t, stamp = self.composer.last_known_camerapose()
            if idx < 0:
                return {"ok": False}
            return {"ok": True, "idx": int(idx), "stamp_ns": int(stamp),
                    "q": list(map(float, q)), "t": list(map(float, t))}
        if what == "path":
            # the reference's path / adhoc detailed-path publishers
            # (Composer.cpp:441-596, enabled via the adhoc_pubpath param,
            # node.cpp:404-413): corrected poses in the IMU frame
            # (w_T_imu = w_T_c * imu_T_cam^-1), dead-zone nodes skipped
            comp = self.composer.latest
            if comp is None:
                comp = self.composer.assemble()
            if comp is None:
                return {"n": 0}
            q_out = np.asarray(comp.q)
            t_out = np.asarray(comp.t)
            if (obj.get("frame", "imu") == "imu"
                    and self.store.imu_T_cam_q is not None):
                q_ci, t_ci = nse3.pose_inv(self.store.imu_T_cam_q,
                                            self.store.imu_T_cam_t)
                n = len(t_out)
                q_out, t_out = nse3.pose_mul(
                    q_out, t_out,
                    np.broadcast_to(q_ci, (n, 4)),
                    np.broadcast_to(t_ci, (n, 3)))
            live = np.asarray(comp.world_of) >= 0
            return {
                "n": int(live.sum()),
                "idx": np.nonzero(live)[0].tolist(),
                "q": q_out[live].tolist(),
                "t": t_out[live].tolist(),
            }
        if what == "world_transform":
            # w0_T_w1-style query (the reference publishes world 0 -> world 1
            # on demand, Composer.cpp:601-644; here any known pair)
            m = int(obj.get("m", 0))
            n = int(obj.get("n", 1))
            worlds = self.store.worlds
            if (m < 0 or n < 0 or not worlds.is_exist(m, n)):
                return {"ok": False, "m": m, "n": n}
            q, t = worlds.get_pose_between_worlds(m, n)
            T = _pose_matrix_list(q, t)
            return {"ok": True, "m": m, "n": n, "m_T_n": T,
                    "q": list(map(float, q)), "t": list(map(float, t))}
        return {"error": f"unknown query {what!r}"}

    # ------------------------------------------------------------------

    def serve(self, socket_path: str, poll_hz: Optional[float] = None):
        """Blocking serve loop on a Unix domain socket."""
        server_self = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    line = raw.decode().strip()
                    if not line:
                        continue
                    try:
                        reply = server_self.handle_line(line)
                    except Exception as e:
                        reply = json.dumps({"error": repr(e)})
                    if reply is not None:
                        self.wfile.write((reply + "\n").encode())
                        self.wfile.flush()
                    if server_self._stop.is_set():
                        break

        class Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True

        if os.path.exists(socket_path):
            os.unlink(socket_path)

        solver_error = []

        def solver_loop():
            # a failed kernel or device stops the server: serve() raises it
            # after shutdown instead of answering from a dead solver
            try:
                self.engine.run(poll_hz=poll_hz, stop_when=self._stop.is_set)
            except BaseException as e:
                self.logger.error(f"solver loop failed: {e!r}; stopping")
                solver_error.append(e)
                self._stop.set()

        solver = threading.Thread(target=solver_loop, daemon=True)
        solver.start()

        def status_loop():
            while not self._stop.wait(1.0):
                self.status.tick(force=True)
        threading.Thread(target=status_loop, daemon=True).start()

        # assembler thread (the reference's 30 Hz pose_assember_thread,
        # Composer.cpp:10): keeps composer.latest fresh so pose /
        # imu_propagate serving reads a snapshot instead of assembling
        # per request
        period = 1.0 / max(self.config.stream.assembler_hz, 1e-3)

        def assembler_loop():
            while not self._stop.wait(period):
                try:
                    self.composer.assemble()
                except Exception as e:     # never kill serving on a race
                    self.logger.warning(f"assemble failed: {e!r}")
        threading.Thread(target=assembler_loop, daemon=True).start()

        with Server(socket_path, Handler) as srv:
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            self.logger.info(f"listening on {socket_path}")
            try:
                self._stop.wait()
            except KeyboardInterrupt:
                self._stop.set()
            srv.shutdown()
        solver.join(timeout=30)
        if solver_error:
            raise solver_error[0]
        self.engine.drain()       # barrier: async solve + bg escalation
        self.engine.trigger()     # settle edges that accumulated while busy
        self.engine.drain()
        if self.save_dir:
            path = self.composer.save_state_to_disk(self.save_dir)
            self.logger.info(f"state -> {path}")

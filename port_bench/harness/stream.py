"""One run of a cell: the program's server under the cell's traffic.

In order:
  1. generate the run's graph (generators.session, by the configuration's
     generator file): the session a robot already has, drawn from the
     configuration's fixed session seed, the same in every run, and after
     it the run's traffic, drawn from the seed; stamp its nodes as the
     mix's keyframes arrive, and refuse a kidnap left open where set-up
     or the drain waits for a solve (prepare);
  2. write the window's plan and start the clients' process (clients.py),
     before the program touches the card;
  3. start the program's server, PoseGraphServer(store, config,
     device).serve(), config the configuration's "settings" (overrides of
     the program's Config, through Config.from_json; {} is Config()), on
     a Unix socket: its solver thread (SolverEngine.run,
     the 2 Hz poll), its 30 Hz assembler and its ingest. Before it serves,
     the engine captures the configuration's one capacity bucket (its own
     per-bucket warm-up, _warm_one); every trigger of the session then
     solves in that bucket (the engine's bucket cover), so set-up captures
     nothing else. The prefix's head streams into the store in chunks of
     keyframes (ingest), from the first that closes a loop, the next chunk
     added as each solve returns: the session that a running robot has,
     solved as it grew;
  4. send the prefix's tail through the socket in batches, each solved
     and any escalated re-solve it started joined before the next;
  5. the clients' open loops: the mix's lead-in, then the window of
     `seconds`;
  6. drain: wait until every loop edge is in a written-back trajectory,
     stop the server.

The loop edges due in the window are those the formulation counts, as
the harness works them out from the graph's kidnap events
(Graph.loop_counted); every edge is sent and stored.

The benchmark stamps each return of the engine's trigger() by wrapping the
bound method on the engine instance (TriggerStamps); the program is not
edited. Stamps and the clients' records share CLOCK_MONOTONIC.

A run starts two child processes, the clients and the nvidia-smi sampler,
and stops both on every path out of it, a failure included (run's finally).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from port_bench.harness import generators, manifest, traffic
from port_bench.harness import trace as trace_mod

CLIENTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "clients.py")
DRAIN_LIMIT_S = 60.0
SOCKET_PATH_MAX = 100               # bytes, under AF_UNIX's 107


class TriggerStamps:
    """Wraps engine.trigger: one row per call (call and return times,
    fired, the engine's prev_edge_len after it, its device_solve phase, and
    its solve_stats row when it fired). Drives the profiler in a traced
    run (trace.Session).

    It also keeps the answers that the check judges: the session's first
    solve, and the first solve called after each time in `sample_at`. An
    answer is the trigger's sizes (its solve_stats row), the result it
    wrote back (the engine's last_result), and the result that the solve
    before it wrote back, from which the check's reference works out the
    trigger's start itself. Where the judged solve's fp32 result showed
    distress and the engine re-solved it in the background, the re-solve's
    result, which the engine writes back in its place, is the answer. A
    solve during which an escalated re-solve landed is not judged (the
    state it started from is not the one read before it): the next one is.
    """

    def __init__(self, engine, session=None):
        self.engine = engine
        self.inner = engine.trigger
        self.session = session
        self.rows: list = []
        self.feed: list = []        # set-up: ingest steps, one per solve
        self.sample_at: list = []
        self.answers: list = []
        self._first = True
        self._seen = 0              # solve_stats rows looked at
        self._landed = 0            # background re-solves that landed
        self._waiting: list = []    # judged answers whose re-solve is out

    def collect(self) -> None:
        """Take in the background re-solves that landed since the last
        look: a judged answer's, once applied, replaces its fp32 result
        (the engine's last_result holds it until the next solve)."""
        stats = self.engine.solve_stats
        new, self._seen = stats[self._seen:], len(stats)
        for r in new:
            if not r.get("background_escalation"):
                continue
            self._landed += 1
            for a in self._waiting:
                if a["trigger"] == r["trigger"]:
                    if r.get("applied"):
                        a["res"] = self.engine.last_result
                        a["escalated"] = True
                    self._waiting.remove(a)
                    break

    def __call__(self) -> bool:
        t_call = time.monotonic()
        self.collect()
        eng = self.engine
        armed = self._first or bool(self.sample_at
                                    and t_call >= self.sample_at[0])
        prev, landed = eng.last_result, self._landed
        sess = self.session
        if sess is not None:
            sess.before_trigger(t_call)
        with sess.span("trigger") if sess else contextlib.nullcontext():
            fired = self.inner()
        t_ret = time.monotonic()
        row = None
        if fired:
            last = eng.solve_stats[-1] if eng.solve_stats else None
            if last is not None and last.get("trigger") == eng.trigger_id:
                row = dict(last)
        self.rows.append({
            "call": t_call, "ret": t_ret, "fired": bool(fired),
            "edge_len": int(eng.prev_edge_len),
            "device_solve_ms": (1000.0 * eng.timer.last["device_solve"]
                                if fired else None),
            "stats": row})
        if fired and armed and row is not None:
            self.collect()
            if self._landed == landed:
                a = {"first": self._first, "call": t_call,
                     "trigger": row["trigger"], "node_len": row["node_len"],
                     "edge_len": row["edge_len"],
                     "prev": None if self._first else prev,
                     "res": eng.last_result, "escalated": False,
                     "stats": row}
                self.answers.append(a)
                if row.get("fp64_escalated") == "pending":
                    self._waiting.append(a)
                if not self._first:
                    self.sample_at.pop(0)
        if fired:
            self._first = False
        if sess is not None:
            sess.after_trigger(t_ret, fired, row)
        if fired and self.feed:
            self.feed.pop(0)()
        return fired


def _answer(a: dict) -> dict:
    """A judged answer with its results as float64 arrays."""
    def arrays(res):
        return None if res is None else (res.q.double().numpy().copy(),
                                         res.t.double().numpy().copy(),
                                         res.switch.double().numpy().copy())
    out = {k: v for k, v in a.items() if k not in ("prev", "res")}
    out["prev"], out["res"] = arrays(a["prev"]), arrays(a["res"])
    return out


def _cuda_check(device: str, chips: int) -> None:
    if device != "cuda":
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("port_bench: no CUDA device (torch.cuda.is_available() "
                 "is false); no result")
    if torch.cuda.device_count() < chips:
        sys.exit(f"port_bench: the cell asks for {chips} cards, "
                 f"{torch.cuda.device_count()} present; no result")


def say(tag: str, **kv) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _card_lines(device: str, children: list) -> tuple:
    """[card] and the nvidia-smi sampler, started beside the window."""
    if device != "cuda":
        return {}, None
    import torch
    card = {"name": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split("\n")[0].split(",")
        card["power_limit_w"] = out[0].strip()
        card["max_sm_mhz"] = out[1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    say("card", **{k: json.dumps(v) for k, v in card.items()})
    try:
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits", "-lms", "1000"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        smi = None
    else:
        children.append(smi)
    return card, smi


def _smi_summary(smi) -> dict:
    if smi is None:
        return {}
    smi.terminate()
    out, _ = smi.communicate(timeout=30)
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    if not rows:
        return {}
    a = np.array(rows)
    return {"samples": len(a),
            "sm_mhz_min_med_max": [float(a[:, 0].min()),
                                   float(np.median(a[:, 0])),
                                   float(a[:, 0].max())],
            "power_w_min_med_max": [float(a[:, 1].min()),
                                    float(np.median(a[:, 1])),
                                    float(a[:, 1].max())],
            "temp_c_max": float(a[:, 2].max())}


def _stop(proc) -> None:
    """Ends a child process, if it has not ended, and waits for it."""
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    for f in (proc.stdin, proc.stdout):
        if f is not None:
            with contextlib.suppress(OSError):
                f.close()


def _program_present() -> None:
    """Exits with no result where the program is not there to import,
    before the run starts a child process."""
    import importlib.util
    if importlib.util.find_spec("solve_keyframe_pose_graph_tpu_torch") is None:
        sys.exit("port_bench: the program, solve_keyframe_pose_graph_tpu_"
                 "torch, is not importable here; no result")


def _shutdown(server, sock_path: str) -> None:
    """The server's own shutdown message; its stop event where the socket
    does not answer."""
    import socket
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(30)
            s.connect(sock_path)
            s.sendall(b'{"kind": "shutdown"}\n')
            s.makefile("rb").readline()
    except OSError:
        server._stop.set()


def _wait(cond, limit_s: float, what: str) -> None:
    t_end = time.monotonic() + limit_s
    while not cond():
        if time.monotonic() > t_end:
            raise RuntimeError(f"port_bench: {what} did not happen within "
                               f"{limit_s} s")
        time.sleep(0.005)


def run(cell: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", bench: dict | None = None,
        root: str = manifest.ROOT, patch=None) -> dict:
    """One run of `cell`; returns its record (see metrics readers). `patch`
    (tests only) is called with the server before it serves. Every child
    process the run starts has ended when it returns or raises."""
    children: list = []
    cwd = os.getcwd()
    try:
        return _run(cell, seed, seconds, trace, t_start=t_start,
                    device=device, bench=bench, root=root, patch=patch,
                    children=children)
    finally:
        for proc in children:
            _stop(proc)
        os.chdir(cwd)                   # see _socket_path


def _socket_path(tmp: str) -> str:
    """The server's Unix socket in `tmp`, named by the process id. A
    socket's path takes at most 107 bytes (AF_UNIX), which a deep TMPDIR
    and a long process id can pass; the server then could not bind and
    the run would end with no result. Such a path is given by the socket's
    name alone, and the process, and with it the clients' process that it
    starts, works in `tmp` until run() returns."""
    path = os.path.join(tmp, f"{os.getpid()}.sock")
    if len(os.fsencode(path)) <= SOCKET_PATH_MAX:
        return path
    os.chdir(tmp)
    return os.path.basename(path)


@dataclasses.dataclass
class Schedule:
    """A run's graph, its nodes' stamp spacing, set-up's cuts and the
    window's keyframes."""
    g: generators.Graph
    by_later: dict              # traffic.edges_by_later(g)
    dt: int                     # ns between keyframe stamps
    head: int                   # nodes ingested directly in set-up
    first: int                  # the first node of the traffic
    cuts: list                  # the head's chunk ends, head last
    tail: list                  # the tail batches' nodes, one array each
    kf_due: np.ndarray          # due offsets (s) from the window's start
    kf_nodes: np.ndarray        # the node of each


def prepare(cfg: dict, mix: dict, seed: int, seconds: float,
            base: str = manifest.BENCH_DIR) -> Schedule:
    """Step 1: the graph of the run and its schedule: the mix's lead-in,
    then the window of `seconds`. Set-up waits for a solve of every loop
    edge at the end of each head chunk and tail batch, and the drain at
    the window's last keyframe; the program does not solve while
    kidnapped, so a kidnap still open at one of those ends is refused
    here, before anything waits for it."""
    head, tail = int(cfg["prefix"]["nodes"]), int(cfg["prefix"]["tail"])
    first = head + tail
    g = generators.session(cfg["graph"], int(cfg["prefix"]["seed"]), seed,
                           first, base)
    by_later = traffic.edges_by_later(g)
    lead = float(mix["lead_s"])
    kf_due = traffic.keyframe_due(mix, lead + seconds) - lead
    if first + len(kf_due) > g.n_nodes:
        raise ValueError(f"{len(kf_due)} keyframes in {lead + seconds} s run "
                         f"past the graph's {g.n_nodes} nodes")
    chunk = int(cfg["prefix"]["chunk"])
    cuts = list(range(min(by_later) + chunk, head, chunk)) + [head]
    batches = np.array_split(np.arange(head, first),
                             int(cfg["prefix"]["tail_batches"]))
    kidnapped = g.kidnapped()[:, 1]
    for what, ends in (("head chunk", cuts),
                       ("tail batch", [int(b[-1]) + 1 for b in batches]),
                       ("window", [first + len(kf_due)])):
        for end in ends:
            if kidnapped[end - 1]:
                raise ValueError(
                    f"a kidnap is open at the end of the {what} that ends "
                    f"with node {end - 1}: set-up and the drain wait there "
                    f"for a solve, which the program does not make while "
                    f"kidnapped")
    return Schedule(g=g, by_later=by_later, dt=traffic.stamp_ns(mix),
                    head=head, first=first, cuts=cuts, tail=batches,
                    kf_due=kf_due, kf_nodes=first + np.arange(len(kf_due)))


def ingest(store, sch: Schedule, lo: int, hi: int) -> None:
    """Set-up's ingest of nodes lo..hi - 1 in stream order: each node and
    its loop edges by the store's own calls, the graph's events before or
    after the node as the program's wire messages (messages.message_from_
    json(...).apply(store)), as the socket would apply them."""
    from solve_keyframe_pose_graph_tpu_torch.graph.messages import (
        message_from_json)
    g, dt = sch.g, sch.dt

    def events(i, after):
        for e in g.events_at(i, after):
            message_from_json(traffic.event_message(e, dt)).apply(store)

    for i in range(lo, hi):
        events(i, False)
        store.add_node(traffic.T0_NS + i * dt, g.vio_q[i], g.vio_t[i])
        for k in sch.by_later.get(i, ()):
            a, b = (int(v) for v in g.loop_pairs[k])
            store.add_loop_edge(traffic.T0_NS + a * dt, traffic.T0_NS + b * dt,
                                g.loop_q[k], g.loop_t[k], float(g.loop_w[k]))
        events(i, True)


def tail_sends(sch: Schedule) -> list:
    """The prefix's tail in its batches, each as sent on the socket: (its
    keyframes' lines, a pose query at its last keyframe, the store's node
    count once it is in)."""
    return [("".join("\n".join(traffic.keyframe_lines(sch.g, int(i),
                                                      sch.by_later, sch.dt))
                     + "\n" for i in batch).encode(),
             (traffic.pose_line(sch.g, int(batch[-1]), sch.dt)
              + "\n").encode(), int(batch[-1]) + 1)
            for batch in sch.tail]


def _settings(cfg: dict) -> str:
    settings = cfg["settings"]
    if not isinstance(settings, dict):
        raise ValueError(f"a configuration's settings are an object of "
                         f"Config overrides, not {settings!r}")
    return json.dumps(settings)


def _run(cell: str, seed: int, seconds: float, trace: bool, *,
         t_start: float, device: str, bench: dict | None, root: str, patch,
         children: list) -> dict:
    bench = bench if bench is not None else manifest.load(root)
    wl = manifest.workload(bench, cell)
    cfg = manifest.config(bench, wl["config"], root)
    mix = manifest.traffic(wl["traffic"], os.path.join(root, "port_bench"))
    _cuda_check(device, int(wl["chips"]))
    _program_present()

    # 1. the graph and the window's plan: the mix's lead-in, then the window
    t = time.monotonic()
    start_s = t - t_start           # the interpreter, imports, CUDA's start
    sch = prepare(cfg, mix, seed, seconds, os.path.join(root, "port_bench"))
    g, head = sch.g, sch.head
    kf_due, kf_nodes = sch.kf_due, sch.kf_nodes
    lead = float(mix["lead_s"])
    pose_due = traffic.pose_due(mix, seconds)
    pose_of = traffic.pose_nodes(kf_due, np.arange(len(kf_due)), pose_due)
    rng = np.random.default_rng([seed, 2])
    sample_at = np.sort(rng.uniform(0.1, 0.9, int(cfg["reference"]["answers"])))
    tmp = os.path.join(os.path.abspath(tempfile.gettempdir()), "port_bench")
    os.makedirs(tmp, exist_ok=True)
    tag = f"{cell}-{seed}-{os.getpid()}"
    sock_path = _socket_path(tmp)
    plan_path = os.path.join(tmp, tag + ".plan.json")
    out_path = os.path.join(tmp, tag + ".clients.json")
    with open(plan_path, "w") as f:
        json.dump({"socket": sock_path,
                   "keyframes": [
                       [float(d), "\n".join(traffic.keyframe_lines(
                           g, int(i), sch.by_later, sch.dt)) + "\n"]
                       for d, i in zip(kf_due, kf_nodes)],
                   "pose_due": pose_due.tolist(),
                   "pose_lines": [traffic.pose_line(g, int(i), sch.dt)
                                  for i in kf_nodes],
                   "pose_line_of": pose_of.tolist()}, f)
    generate_s = time.monotonic() - t

    # 2. the clients, before the program touches the card
    clients = subprocess.Popen(
        [sys.executable, CLIENTS, plan_path, out_path],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    children.append(clients)

    # 3. the program, its store and its server
    t = time.monotonic()
    from solve_keyframe_pose_graph_tpu_torch.config import Config
    from solve_keyframe_pose_graph_tpu_torch.graph.native import make_store
    from solve_keyframe_pose_graph_tpu_torch.runtime_server import (
        PoseGraphServer)
    import torch
    import_s = time.monotonic() - t
    t = time.monotonic()
    session = trace_mod.Session(t_mid=None, solves=3) if trace else None
    if session is not None and device == "cuda":
        trace_mod.prime_profiler()
    card, smi = _card_lines(device, children)
    card_s = time.monotonic() - t

    t = time.monotonic()
    config = Config.from_json(_settings(cfg))
    # the numpy store: the native store's binding races the solver's reads
    # under concurrent ingest (PERF.md, Open questions), and its library,
    # which the host rung's first build makes, would be picked up by the
    # next run in the same checkout
    store = make_store(config.capacity.initial_nodes, native=False,
                       max_capacity=config.capacity.max_nodes)
    store.set_extrinsic(np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3))

    # the head streams in chunks from the first node that closes a loop,
    # the next chunk fed as each solve returns (see TriggerStamps.feed)
    ingest(store, sch, 0, sch.cuts[0])
    server = PoseGraphServer(store, config, device=device)
    engine = server.engine
    store_s = time.monotonic() - t
    # the cell's one capacity bucket, captured before the first trigger:
    # every trigger of the session solves in it (the engine's bucket
    # cover), so set-up captures nothing else
    t = time.monotonic()
    engine._warm_one(*(int(v) for v in cfg["bucket"]))
    capture_s = time.monotonic() - t
    stamps = TriggerStamps(engine, session)
    stamps.feed = [lambda lo=lo, hi=hi: ingest(store, sch, lo, hi)
                   for lo, hi in zip(sch.cuts, sch.cuts[1:])]
    engine.trigger = stamps
    if session is not None:
        session.wrap_server(server)
    if patch is not None:
        patch(server)
    serve_error: list = []

    def serve():
        try:
            server.serve(sock_path)
        except BaseException as e:          # raised again below
            serve_error.append(e)

    serve_thread = threading.Thread(target=serve, daemon=True)
    try:
        t = time.monotonic()
        serve_thread.start()
        _wait(lambda: serve_error or (not stamps.feed and any(
            r["fired"] and r["edge_len"] == store.edge_len
            for r in stamps.rows)), 900, "the prefix's solves")
        prefix_s = time.monotonic() - t
        # 4. the tail through the socket in batches, each solved (delta
        # builds and replays) and any escalated re-solve it started joined
        import socket
        t = time.monotonic()
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(sock_path)
            for lines, query, n_now in tail_sends(sch):
                s.sendall(lines)
                s.sendall(query)
                s.makefile("rb").readline()
                _wait(lambda: store.node_len == n_now, 60, "a tail batch")
                _wait(lambda: serve_error or any(
                    r["fired"] and r["edge_len"] == store.edge_len
                    for r in stamps.rows), 120, "a tail batch's solve")
                if serve_error:
                    raise serve_error[0]
                engine.drain()
        warm_s = time.monotonic() - t
        t = time.monotonic()
        if clients.stdout.readline().strip() != "READY":
            raise RuntimeError("port_bench: the clients did not connect")
        ready_s = time.monotonic() - t
        edges0 = store.edge_len
        # 5. the lead-in's traffic, then the window
        t0 = time.monotonic() + lead + 0.05
        t_end = t0 + seconds
        stamps.sample_at = list(t0 + sample_at * seconds)
        if session is not None:
            session.t_mid, session.t_end = t0 + seconds / 2, t_end
        trace_mod.check_no_jax("before the window")
        setup_s = t0 - t_start
        clients.stdin.write(f"GO {t0!r}\n")
        clients.stdin.flush()

        # 6. the drain
        if clients.stdout.readline().strip() != "DONE":
            raise RuntimeError("port_bench: the clients failed")
        clients.wait(timeout=60)
        n_sent = sum(len(sch.by_later.get(int(i), ())) for i in kf_nodes)
        _wait(lambda: store.edge_len == edges0 + n_sent or serve_error,
              DRAIN_LIMIT_S, "the window's ingest")
        drain_t = time.monotonic()
        done = (lambda: serve_error or (
            stamps.rows and stamps.rows[-1]["edge_len"] == store.edge_len))
        try:
            _wait(done, DRAIN_LIMIT_S, "the drain")
        except RuntimeError:
            pass                    # counted as uncorrected edges
        engine.drain()
        stamps.collect()
        drain_s = time.monotonic() - drain_t
        if session is not None:
            session.stop()
        peak = (int(torch.cuda.max_memory_allocated()) if device == "cuda"
                else 0)
        solve_stats = [dict(r) for r in engine.solve_stats]
    finally:
        _shutdown(server, sock_path)
        serve_thread.join(timeout=120)
        if clients.poll() is None:
            clients.kill()
        clients.wait()
        smi_summary = _smi_summary(smi)
    if serve_error:
        raise serve_error[0]

    with open(out_path) as f:
        cl = json.load(f)
    profile = session.summary() if session is not None else None
    store_kind = type(store).__name__
    del server, engine, store, stamps.engine, stamps.inner
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    trace_mod.check_no_jax("after the window")

    # every counted loop edge due in the window, by its store index
    due, index, counted = [], edges0, g.loop_counted
    for d, i in zip(kf_due, kf_nodes):
        for k in sch.by_later.get(int(i), ()):
            if d >= 0 and counted[k]:
                due.append((index, t0 + float(d)))
            index += 1
    fired = [r for r in stamps.rows if r["fired"]]
    done_at, j = [], 0
    for idx, _ in due:
        while j < len(fired) and fired[j]["edge_len"] <= idx:
            j += 1
        done_at.append(fired[j]["ret"] if j < len(fired) else None)
    for p in (plan_path, out_path):
        with contextlib.suppress(OSError):
            os.unlink(p)
    return {
        "cell": cell, "seed": seed, "seconds": seconds, "trace": trace,
        "device": device, "card": card, "clock": smi_summary,
        "t0": t0, "t_end": t_end, "setup_s": setup_s,
        "setup": {"start_s": start_s, "generate_s": generate_s,
                  "import_s": import_s, "card_s": card_s,
                  "store_s": store_s, "capture_s": capture_s,
                  "prefix_s": prefix_s, "warm_s": warm_s,
                  "ready_s": ready_s},
        "store": store_kind,
        "drain_s": drain_s, "memory_peak_bytes": peak,
        "edges": {"due": [u for _, u in due], "done": done_at,
                  "index": [i for i, _ in due]},
        "keyframes": {"due": [t0 + float(d) for d in kf_due],
                      "sent": cl["keyframes_sent"]},
        "queries": cl["pose"],
        "triggers": stamps.rows,
        "solve_stats": solve_stats,
        "answers": [_answer(a) for a in stamps.answers],
        "capacity": {"initial_nodes": config.capacity.initial_nodes,
                     "initial_edges": config.capacity.initial_edges},
        "profile": profile,
        "graph": g,
    }

"""Command-line driver of the port (counterpart of
solve_keyframe_pose_graph_tpu/cli.py, with the same subcommands and flags
plus --device):

  kpg-solve-torch info    --input g.json|g.g2o          graph summary
  kpg-solve-torch solve   --input g.json|g.g2o          batch solve -> poses
  kpg-solve-torch replay  --input g.json [--save-dir D] streaming replay of
                          [--load-dir D]                the recorded events
                                                        (kidnaps included)
  kpg-solve-torch ablate  --input g.json [--edges 1,2]  per-edge chi^2
                                                        ablation
  kpg-solve-torch serve   --socket path                 live ingest server
                                                        (JSONL, Unix socket)

--device (default cuda) is the device the engine solves on. With cuda and no
CUDA device the command exits non-zero; it never carries on on the CPU.
Offline subcommands accept --viz-dir to dump TrajectoryWriter primitives.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from solve_keyframe_pose_graph_tpu_torch.config import Config


# ---------------------------------------------------------------------------
# graph loading
# ---------------------------------------------------------------------------


def _store_from_input(path: str, edge_mask=None, native: bool = False):
    """GraphStore from a log_posegraph.json dump or a .g2o file."""
    from solve_keyframe_pose_graph_tpu_torch.graph.store import GraphStore
    from solve_keyframe_pose_graph_tpu_torch.graph.native import make_store

    if path.endswith(".g2o"):
        from solve_keyframe_pose_graph_tpu_torch.graph import g2o as g2o_io

        g = g2o_io.load_g2o(path)
        inp = g2o_io.g2o_to_problem_inputs(g)
        store = make_store(initial_capacity=max(g.n_nodes, 16),
                           native=native or None,
                           max_capacity=max(g.n_nodes, 65536))
        t0 = 1_000_000_000
        dt = 100_000_000
        for i in range(g.n_nodes):
            store.add_node(t0 + i * dt, inp["vio_q"][i], inp["vio_t"][i])
        for k in range(len(inp["loop_pairs"])):
            a, b = map(int, inp["loop_pairs"][k])
            idx = store.add_loop_edge_by_index(
                a, b, inp["loop_q"][k], inp["loop_t"][k],
                float(inp["loop_w"][k]), f"g2o:{k}",
            )
            if edge_mask is not None and not edge_mask[k]:
                store.edge_mask[idx] = False
        return store
    return GraphStore.load_from_json(path, edge_mask=edge_mask)


def _device_from_args(args) -> torch.device:
    """The solve device; exits non-zero when CUDA is asked for and absent."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"kpg-solve-torch: --device {args.device} but no CUDA device is "
            "available (torch.cuda.is_available() is false); pass "
            "--device cpu to solve on the CPU")
    return dev


def _build_pipeline(store, cfg: Config, device):
    from solve_keyframe_pose_graph_tpu_torch.compose.composer import Composer
    from solve_keyframe_pose_graph_tpu_torch.solver.engine import (
        SolverEngine,
    )

    eng = SolverEngine(store, cfg, device=device)
    cmp_ = Composer(store, eng)
    return eng, cmp_


def _config_from_args(args) -> Config:
    """The run's Config; exits non-zero for one the port cannot run (a mesh
    of several devices)."""
    from solve_keyframe_pose_graph_tpu_torch.solver.engine import (
        refuse_multi_device,
    )

    cfg = Config()
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    try:
        refuse_multi_device(cfg)
    except ValueError as e:
        raise SystemExit(f"kpg-solve-torch: {e}") from None
    if getattr(args, "max_iters", None):
        import dataclasses
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(
                cfg.solver, max_lm_iterations=args.max_iters))
    if getattr(args, "async_dispatch", False):
        import dataclasses
        cfg = dataclasses.replace(
            cfg, stream=dataclasses.replace(
                cfg.stream, async_dispatch=True))
    return cfg


def _maybe_viz(args, cmp_, tag):
    if getattr(args, "viz_dir", None):
        from solve_keyframe_pose_graph_tpu_torch.compose.vizsink import (
            TrajectoryWriter,
        )
        writer = TrajectoryWriter(
            args.viz_dir,
            color_by_set=getattr(args, "viz_color_by_set", False))
        path = writer.write(cmp_, tag)
        print(f"viz -> {path}")


def _dump_solution(path, store, eng, cmp_):
    """log_optimized_poses.json analog (PoseGraphSLAM.cpp:1111-1207), plus
    every row of the engine's solve_stats (each trigger and each escalated
    re-solve)."""
    from solve_keyframe_pose_graph_tpu_torch.utils import nse3

    comp = cmp_.assemble()
    nodes = []
    for i in range(store.node_len):
        T = nse3.pose_to_matrix(comp.q[i], comp.t[i])
        nodes.append({
            "idx": i,
            "stampNSec": store.node_timestamp(i),
            "world_id": int(comp.world_of[i]),
            "w_T_c": ";".join(",".join(f"{v:.12g}" for v in row) for row in T),
        })
    switches = [eng.get_switch(e) for e in range(store.edge_len)]
    with eng.state_lock:
        rows = list(eng.solve_stats)
    obj = {"nodes": nodes, "switches": switches,
           "last_solve": rows[-1] if rows else {},
           "solved_until": eng.solved_until, "solve_stats": rows}
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
    print(f"solution -> {path}")


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------


def cmd_info(args):
    store = _store_from_input(args.input)
    w = store.worlds
    print(f"nodes:        {store.node_len}")
    print(f"loop edges:   {store.edge_len}")
    print(f"worlds:       {store.n_worlds()} (sets: {w.n_sets()})")
    print(f"kidnaps:      {store.n_kidnaps()}")
    if store.node_len:
        t0 = store.node_timestamp(0)
        t1 = store.node_timestamp(store.node_len - 1)
        print(f"span:         {(t1 - t0) / 1e9:.1f} s")
    print(w.disjoint_set_status())
    return 0


def cmd_solve(args):
    dev = _device_from_args(args)
    cfg = _config_from_args(args)
    store = _store_from_input(args.input)
    eng, cmp_ = _build_pipeline(store, cfg, dev)
    t0 = time.perf_counter()
    fired = eng.trigger()
    eng.drain()
    dt = (time.perf_counter() - t0) * 1e3
    if not fired:
        print("no solve fired (no loop edges / kidnapped)", file=sys.stderr)
    stats = eng.solve_stats[-1] if eng.solve_stats else {}
    if stats:
        print(f"solve: {dt:.1f} ms wall  "
              f"cost {stats.get('initial_cost'):.6g} -> "
              f"{stats.get('final_cost'):.6g}  "
              f"iters {stats.get('lm_iterations')}  cg {stats.get('cg_iterations')}")
    _dump_solution(args.output, store, eng, cmp_)
    _maybe_viz(args, cmp_, "solve")
    return 0


def cmd_replay(args):
    """Feed recorded events through the live pipeline in timestamp order
    (ingest callbacks -> trigger loop -> composer), the offline twin of the
    reference's ROS-driven run."""
    dev = _device_from_args(args)
    cfg = _config_from_args(args)
    from solve_keyframe_pose_graph_tpu_torch.graph.native import make_store

    rec = _store_from_input(args.input)   # recorded data, replayed below
    store = make_store(initial_capacity=max(rec.node_len, 16),
                       native=getattr(args, "native", False) or None,
                       max_capacity=cfg.capacity.max_nodes)
    eng, cmp_ = _build_pipeline(store, cfg, dev)

    if args.load_dir:
        ok = cmp_.load_state_from_disk(args.load_dir)
        print(f"load_state_from_disk({args.load_dir}) -> {ok}")

    # event tape: nodes, edges (at their later endpoint's time), kidnaps
    events = []
    for i in range(rec.node_len):
        q, t = rec.node_pose(i)
        events.append((rec.node_timestamp(i), 0, ("node", q, t)))
    for e in range(rec.edge_len):
        a, b = rec.edge_idx_info(e)
        tse = max(rec.node_timestamp(a), rec.node_timestamp(b))
        q, t = rec.edge_pose(e)
        events.append((tse, 1, ("edge", rec.node_timestamp(a),
                                rec.node_timestamp(b), q, t,
                                rec.edge_weight(e))))
    for k, ts in enumerate(rec.kidnap_starts):
        events.append((ts, 2, ("kidnap",)))
    for k, ts in enumerate(rec.kidnap_ends):
        events.append((ts, 2, ("unkidnap",)))
    events.sort(key=lambda x: (x[0], x[1]))

    trigger_every = max(1, int(args.trigger_every))
    n_solves = 0
    t_start = time.perf_counter()
    for n_ev, (ts, _, ev) in enumerate(events):
        kind = ev[0]
        if kind == "node":
            store.add_node(ts, ev[1], ev[2])
        elif kind == "edge":
            store.add_loop_edge(ev[1], ev[2], ev[3], ev[4], ev[5])
        elif kind == "kidnap":
            store.kidnap_indicator(ts, "kidnapped")
        elif kind == "unkidnap":
            store.kidnap_indicator(ts, "unkidnapped")
        if n_ev % trigger_every == 0 and eng.trigger():
            n_solves += 1
            cmp_.assemble()
    eng.drain()          # barrier: async solve + background escalation
    eng.trigger()        # settle edges that accumulated while busy
    eng.drain()
    wall = time.perf_counter() - t_start
    print(f"replayed {len(events)} events, {n_solves} solves, "
          f"{wall:.2f} s wall")
    if eng.solve_stats:
        ms = [s["trigger_wall_ms"] for s in eng.solve_stats if "trigger_wall_ms" in s]
        if ms:
            print(f"solve wall per trigger: median {np.median(ms):.1f} ms, "
                  f"p90 {np.percentile(ms, 90):.1f} ms")

    if args.output:
        _dump_solution(args.output, store, eng, cmp_)
    _maybe_viz(args, cmp_, "replay")
    if args.save_dir:
        path = cmp_.save_state_to_disk(args.save_dir)
        print(f"state -> {path}")
    return 0


def cmd_serve(args):
    """Live ingest server on a Unix socket (the ROS-subscriber analog)."""
    dev = _device_from_args(args)
    cfg = _config_from_args(args)
    from solve_keyframe_pose_graph_tpu_torch.graph.native import make_store
    from solve_keyframe_pose_graph_tpu_torch.runtime_server import (
        PoseGraphServer,
    )

    store = make_store(native=getattr(args, "native", False) or None,
                       max_capacity=cfg.capacity.max_nodes)
    server = PoseGraphServer(store, cfg, save_dir=args.save_dir or None,
                             load_dir=args.load_dir or None, device=dev)
    if args.warmup_nodes:
        # builds both kernels and primes one solve at the first bucket, so
        # the first live trigger pays no nvcc build
        server.engine.warmup(args.warmup_nodes,
                             args.warmup_edges or args.warmup_nodes)
        server.logger.info("kernels built, first bucket primed")
    server.serve(args.socket)
    return 0


def cmd_ablate(args):
    """Edge-ablation study: re-solve with each listed edge disabled and
    report the chi^2 delta (offline replacement for the reference's
    debug_kf_slam_node OpenCV GUI)."""
    dev = _device_from_args(args)
    cfg = _config_from_args(args)
    store0 = _store_from_input(args.input)
    ne = store0.edge_len
    eng0, cmp0 = _build_pipeline(store0, cfg, dev)
    eng0.trigger()
    eng0.drain()         # an escalated re-solve lands before it is read
    base = eng0.solve_stats[-1]["final_cost"] if eng0.solve_stats else None
    print(f"baseline chi2: {base:.6g}  ({ne} edges)")

    targets = (list(range(ne)) if args.edges == "all"
               else [int(x) for x in args.edges.split(",") if x.strip()])
    rows = []
    for e in targets:
        mask = [True] * ne
        mask[e] = False
        store = _store_from_input(args.input, edge_mask=mask)
        eng, _ = _build_pipeline(store, cfg, dev)
        eng.trigger()
        eng.drain()
        chi2 = eng.solve_stats[-1]["final_cost"] if eng.solve_stats else None
        delta = chi2 - base if (chi2 is not None and base is not None) else None
        rows.append({"edge": e, "chi2": chi2, "delta_vs_baseline": delta})
        print(f"edge {e:5d} disabled: chi2 {chi2:.6g}  delta {delta:+.6g}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"baseline_chi2": base, "ablation": rows}, f, indent=2)
        print(f"ablation report -> {args.output}")
    return 0


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="kpg-solve-torch",
        description="keyframe pose-graph SLAM back-end, PyTorch/CUDA port",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="graph summary")
    p.add_argument("--input", required=True)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("solve", help="batch solve a recorded graph")
    p.add_argument("--input", required=True, help=".json (log_posegraph) or .g2o")
    p.add_argument("--output", default="log_optimized_poses.json")
    p.add_argument("--config", help="Config JSON file")
    p.add_argument("--max-iters", type=int)
    p.add_argument("--viz-dir")
    p.add_argument("--viz-color-by-set", action="store_true",
                   help="color trajectory strips by setID instead of "
                        "worldID (Composer.cpp:285)")
    p.add_argument("--device", default="cuda",
                   help="device the engine solves on (cuda, cuda:N or cpu)")
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("replay", help="streaming replay of recorded events")
    p.add_argument("--input", required=True)
    p.add_argument("--output", default="")
    p.add_argument("--config")
    p.add_argument("--max-iters", type=int)
    p.add_argument("--trigger-every", default=25,
                   help="poll the solver every N events")
    p.add_argument("--save-dir", help="checkpoint on exit (saveStateToDisk)")
    p.add_argument("--load-dir", help="restore at start (loadStateFromDisk)")
    p.add_argument("--viz-dir")
    p.add_argument("--viz-color-by-set", action="store_true",
                   help="color trajectory strips by setID instead of "
                        "worldID (Composer.cpp:285)")
    p.add_argument("--native", action="store_true",
                   help="require the C++ store core (default: auto)")
    p.add_argument("--async-dispatch", dest="async_dispatch",
                   action="store_true",
                   help="overlap the host problem-build with the in-flight "
                        "device solve (stream.async_dispatch)")
    p.add_argument("--device", default="cuda",
                   help="device the engine solves on (cuda, cuda:N or cpu)")
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("serve", help="live ingest server (unix socket JSONL)")
    p.add_argument("--socket", required=True, help="unix socket path")
    p.add_argument("--config")
    p.add_argument("--max-iters", type=int)
    p.add_argument("--save-dir", default="")
    p.add_argument("--load-dir", default="")
    p.add_argument("--native", action="store_true")
    p.add_argument("--warmup-nodes", type=int, default=0,
                   help="build the kernels and prime one solve before "
                        "serving (nonzero: on; checked against the node "
                        "ceiling)")
    p.add_argument("--warmup-edges", type=int, default=0)
    p.add_argument("--async-dispatch", dest="async_dispatch",
                   action="store_true",
                   help="overlap the host problem-build with the in-flight "
                        "device solve (stream.async_dispatch)")
    p.add_argument("--device", default="cuda",
                   help="device the engine solves on (cuda, cuda:N or cpu)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("ablate", help="per-edge chi^2 ablation")
    p.add_argument("--input", required=True)
    p.add_argument("--edges", default="all", help="'all' or comma list")
    p.add_argument("--output", default="")
    p.add_argument("--config")
    p.add_argument("--max-iters", type=int)
    p.add_argument("--device", default="cuda",
                   help="device the engine solves on (cuda, cuda:N or cpu)")
    p.set_defaults(fn=cmd_ablate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""The run's clients, a child process that speaks to the server's socket.

    python3 clients.py PLAN OUT

PLAN (JSON) names the socket and holds the window's keyframes (due offset,
wire lines), the pose queries' due offsets and, for each, the index of its
line in "pose_lines". The process
connects, prints READY, and waits for a line "GO <t0>" on its standard
input, t0 the window's start on CLOCK_MONOTONIC (time.monotonic). Then two
threads run open loops until every message is sent:

  keyframe client: at each keyframe's due time its node and loop edges in
    one write; records the monotonic time after the write;
  pose client: at each query's due time one imu_propagate query, then
    reads the reply; records the reply's time and whether it holds a pose.

It writes the records to OUT as JSON and exits. It gives up, with no
records, where the run that started it ends before the server listens or
before "GO". It imports nothing but the standard library, so it starts fast
and never touches the card.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time


def _sleep_until(t: float) -> None:
    d = t - time.monotonic()
    if d > 0:
        time.sleep(d)


def _connect(path: str, parent: int,
             limit_s: float = 1200.0) -> socket.socket:
    """A connection to the server, which may not listen yet. Gives up
    where the run that started this process has ended."""
    t_end = time.monotonic() + limit_s
    while True:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.connect(path)
            return s
        except OSError:
            s.close()
            if time.monotonic() > t_end or os.getppid() != parent:
                raise
            time.sleep(0.05)


def keyframes(sock: socket.socket, t0: float, plan: dict, out: list) -> None:
    for due, lines in plan["keyframes"]:
        _sleep_until(t0 + due)
        sock.sendall(lines.encode())
        out.append(time.monotonic())


def poses(sock: socket.socket, t0: float, plan: dict, out: list) -> None:
    msgs = [(line + "\n").encode() for line in plan["pose_lines"]]
    f = sock.makefile("rb")
    for due, k in zip(plan["pose_due"], plan["pose_line_of"]):
        _sleep_until(t0 + due)
        sock.sendall(msgs[k])
        reply = f.readline()
        t = time.monotonic()
        try:
            ok = bool(json.loads(reply).get("ok"))
        except ValueError:
            ok = False
        out.append([t0 + due, t, ok])


def main(plan_path: str, out_path: str) -> None:
    with open(plan_path) as f:
        plan = json.load(f)
    parent = os.getppid()
    socks = [_connect(plan["socket"], parent) for _ in range(2)]
    print("READY", flush=True)
    line = sys.stdin.readline().split()
    if not line or line[0] != "GO":
        return
    t0 = float(line[1])
    sent, replies = [], []
    threads = [threading.Thread(target=keyframes, args=(socks[0], t0, plan,
                                                        sent)),
               threading.Thread(target=poses, args=(socks[1], t0, plan,
                                                    replies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for s in socks:
        s.close()
    with open(out_path, "w") as f:
        json.dump({"t0": t0, "keyframes_sent": sent, "pose": replies}, f)
    print("DONE", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])

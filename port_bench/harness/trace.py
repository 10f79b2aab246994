"""The traced run's profile, and the check that nothing of JAX is loaded.

A traced run opens one torch.profiler session (CPU and CUDA activity) over
the triggers of the window's middle: from the first trigger called after
the window's midpoint until `solves` of them have solved. It ends the
session with torch.autograd._disable_profiler(), which returns the raw
events: profile.stop() would also turn them into Python objects, seconds
of work on the solver thread inside the window. The process first runs
prime_profiler, before the program composes its executables: in
executables composed before a process's first profiler session the
profiler has seen each WHILE node's body run once (an H100 showed 1 of 318
K1 launches of a 5k/10k solve). So the process has two sessions, the first
over one trivial operation.

Inside the session the benchmark marks, with record_function spans from
its own wrappers, what the solver thread was doing: "trigger" (a call of
the engine's trigger), inside it "guesses", "build" (the problem build and
its copy to the card) and "write_back"; "poll_sleep" (from a trigger that
found nothing to the next call). The session runs on the solver thread,
which starts and stops it: the profiler records the host operations of the
thread that started it, and the card's activity whatever launched it. So
the server's other threads (ingest, pose queries, the assembler) have no
spans. The session holds the solver thread from its start to the end of
stop() (t_on, t_off): host-clock readers of the solver loop leave that
span out. summary() reduces the session's raw events: device
time by kernel name, the busy share of the traced span (the union of the
device's kernels and copies), and the idle gaps labelled by the innermost
span that covers their midpoint.
"""

from __future__ import annotations

import contextlib
import sys
import time

JAX_NAMES = ("jax", "jaxlib", "flax", "solve_keyframe_pose_graph_tpu")
SHORT_GAP_NS = 20_000
SPANS = ("trigger", "guesses", "build", "write_back", "poll_sleep")


def loaded_jax(modules=None) -> list:
    """Modules whose top-level name, the part before the first dot, is one
    of JAX_NAMES, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules)
                  if m.split(".", 1)[0] in JAX_NAMES)


def check_no_jax(when: str) -> None:
    found = loaded_jax()
    if found:
        sys.exit(f"port_bench: JAX or the JAX package is loaded {when}: "
                 f"{', '.join(found[:20])}; no result")


def prime_profiler() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Session:
    """The one profiler session of a traced run, driven by the trigger
    wrapper (stream.TriggerStamps)."""

    def __init__(self, t_mid, solves: int = 3):
        self.t_mid = t_mid
        self.t_end = None
        self.solves = solves
        self.results = None
        self.active = False
        self.done = False
        self.rows: list = []
        self._sleep = None
        self._k1 = None
        self.t_on = self.t_off = None

    # -- driven by the wrappers --------------------------------------------

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def _end_sleep(self) -> None:
        if self._sleep is not None:
            self._sleep.__exit__(None, None, None)
            self._sleep = None

    def before_trigger(self, t_call: float) -> None:
        if self.active:
            self._end_sleep()
        elif (not self.done and self.t_mid is not None
              and t_call >= self.t_mid):
            from torch.profiler import ProfilerActivity, profile
            from solve_keyframe_pose_graph_tpu_torch.ops import band_matvec
            self._k1 = (band_matvec.band_matvec, band_matvec.band_matvec
                        .launches)
            self.t_on = t_call
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]).start()
            self.active = True

    def after_trigger(self, t_ret: float, fired: bool, row) -> None:
        if not self.active:
            return
        if fired:
            self.rows.append(row)
            if len(self.rows) >= self.solves:
                self.stop()
                return
        if self.t_end is not None and t_ret >= self.t_end:
            self.stop()
        elif not fired:
            from torch.profiler import record_function
            self._sleep = record_function("poll_sleep")
            self._sleep.__enter__()

    def stop(self) -> None:
        """End the session (after its solves, or at the window's end)."""
        if not self.active:
            return
        import torch
        self._end_sleep()
        self.active = False
        self.done = True
        fn, before = self._k1
        self._k1 = fn.launches - before
        self.results = torch.autograd._disable_profiler()
        self.t_off = time.monotonic()

    def wrap_server(self, server) -> None:
        """Spans around three steps of the engine's trigger, by wrapping
        the bound methods on the engine instance."""
        def wrapped(inner, name_of):
            def call(*a, **kw):
                if not self.active:
                    return inner(*a, **kw)
                with self.span(name_of(a)):
                    return inner(*a, **kw)
            return call

        eng = server.engine
        for attr, name in (("_set_initial_guesses", "guesses"),
                           ("_prepare_solve", "build"),
                           ("_finish_solve", "write_back")):
            setattr(eng, attr, wrapped(getattr(eng, attr),
                                       lambda a, n=name: n))

    # -- after the window ----------------------------------------------------

    def summary(self) -> dict | None:
        """The session's reduction (see the module note); None where no
        session ran."""
        if self.results is None:
            return None
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        dev, spans = [], []
        for e in self.results.events():
            name = e.name()
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    dev.append((e.start_ns(), e.duration_ns(), name))
            elif name in SPANS:
                spans.append((e.start_ns(), e.duration_ns(), name))
        self.results = None
        trig = [s for s in spans if s[2] == "trigger"]
        held = {"t_on": self.t_on, "t_off": self.t_off}
        if not trig or not dev:
            return {"solves": self.rows, "device_events": len(dev),
                    "k1_counted": self._k1, **held}
        lo = min(s[0] for s in trig)
        hi = max(s[0] + s[1] for s in trig)
        by_name: dict = {}
        for s, d, n in dev:
            c, tot = by_name.get(n, (0, 0))
            by_name[n] = (c + 1, tot + d)
        busy, gaps = 0, []
        cur_s = cur_e = None
        for s, d, _ in sorted(dev):
            e = s + d
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if cur_e is None:
                if s > lo:
                    gaps.append((lo, s - lo))
                cur_s, cur_e = s, e
            elif s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s - cur_e))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
            if hi > cur_e:
                gaps.append((cur_e, hi - cur_e))

        def label(g0, g1):
            m = g0 + g1 / 2
            cover = [s for s in spans if s[0] <= m <= s[0] + s[1]]
            return min(cover, key=lambda s: s[1])[2] if cover else "none"

        # gaps under SHORT_GAP_NS lie between the kernels of one launch
        labelled = [(label(g0, g1) if g1 >= SHORT_GAP_NS else "in_launch",
                     g1) for g0, g1 in gaps]
        labelled.sort(key=lambda g: -g[1])
        return {
            "solves": self.rows,
            "span_ns": hi - lo, "busy_ns": busy,
            "device_events": len(dev),
            "by_name": {n: [c, t] for n, (c, t) in by_name.items()},
            "gaps": [list(g) for g in labelled[:10]],
            "gap_ns_by_label": _sum_by(labelled),
            "k1_counted": self._k1, **held,
        }


def _sum_by(pairs) -> dict:
    out: dict = {}
    for k, v in pairs:
        out[k] = out.get(k, 0) + v
    return out

"""The traced run (--trace 1): spans, counters, kernel events and a
device trace, recorded from the benchmark's own files around its calls
into the port's layers.

- Spans: `patch` wraps a function of the port (FinalizePool.collect,
  Aligner._retry_overflow, ...) and adds the wall seconds of its calls
  inside the window to `spans[name]`; while the profiler records, the
  call is also a `pb.<name>` annotation, so the device's idle gaps can
  be named by what the host was doing.
- Counters and the port's own PROF phases: the deltas over the window.
- Kernel time: the port's CUDA event pairs around each launch of the
  named kernels (`ops.kernels.TIMED`), summed once the window closes.
- Device trace: torch.profiler (CPU and CUDA activity) over a steady
  sub-window, started and stopped from the main thread by `tick`; the
  union of the device's activity in it gives busy_s, and the trace the
  breakdown.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    def __init__(self):
        self.active = False
        self.spans = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)
        self.counters = {}
        self.prof_delta = {}
        self.prof_counts = {}
        self.kernel_ms = {}
        self.kernel_launches = {}
        self.stage_ms = {}
        self.esc_stage_ms = {}
        self.work = 0
        self.unit = None
        self.window_len = None
        self.busy_s = None
        self.window_s = None
        self.breakdown = None
        self._patches = []
        self._kernels = ()
        self._prof = None
        self._prof_ann = None
        self._prof_at = self._prof_len = 0.0
        self._t_open = None
        self._prof_t0 = None
        self._prof_done = False
        self._prof_path = None

    # ---- spans
    def patch(self, owner, name: str, span: str, static: bool = False,
              tick: bool = False):
        """Wrap owner.name so that its calls in the window add to
        spans[span]; with tick, each call first lets the profiler start
        or stop (call it from a function the main thread runs)."""
        inner = owner.__dict__[name]
        fn = inner.__func__ if isinstance(inner, staticmethod) else inner
        tracer = self

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if tick:
                tracer.tick()
            if not tracer.active:
                return fn(*a, **kw)
            ann = tracer._annotation(span)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                tracer.spans[span] += time.perf_counter() - t0
                tracer.calls[span] += 1
                if ann is not None:
                    ann.__exit__(None, None, None)

        setattr(owner, name, staticmethod(wrapper) if static else wrapper)
        self._patches.append((owner, name, inner))

    def _annotation(self, span):
        if self._prof is None or self._prof_done:
            return None
        import torch
        ann = torch.profiler.record_function("pb." + span)
        ann.__enter__()
        return ann

    def restore(self):
        for owner, name, inner in reversed(self._patches):
            setattr(owner, name, inner)
        self._patches = []

    # ---- the window
    def open(self, kernels=(), profile=(5.0, 5.0), seconds=30.0):
        """At the window's opening: snapshot the port's PROF, ask the
        port for event pairs around the named kernels' launches, and
        arm the profiler `profile[0]` s into the window for
        `profile[1]` s (cut to fit a shorter window)."""
        from fgdp_tpu_torch.ops import kernels as kmod
        from fgdp_tpu_torch.utils.profiling import PROF
        self._prof0 = dict(PROF.acc)
        self._counts0 = dict(PROF.counts)
        self._kernels = tuple(kernels)
        self._launch0 = {k: kmod.LAUNCHES.get(k, 0) for k in kernels}
        for k in kernels:
            kmod.TIMED[k] = []
        self._prof_at = min(profile[0], 0.3 * seconds)
        self._prof_len = min(profile[1], 0.4 * seconds)
        self._t_open = time.perf_counter()
        self.active = True

    def tick(self):
        """Start or stop the profiler by the window's clock."""
        if not self.active or self._prof_done:
            return
        now = time.perf_counter() - self._t_open
        if self._prof is None and now >= self._prof_at:
            self._start_profiler()
        elif self._prof is not None and \
                time.perf_counter() - self._prof_t0 >= self._prof_len:
            self._stop_profiler()

    def _start_profiler(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._prof_ann = torch.profiler.record_function("pb.window")
        self._prof_ann.__enter__()
        self._prof_t0 = time.perf_counter()

    def _stop_profiler(self):
        import tempfile
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof_ann.__exit__(None, None, None)
        self._prof_done = True
        self._prof.stop()
        fd, self._prof_path = tempfile.mkstemp(suffix=".json",
                                               prefix="portbench-trace-")
        os.close(fd)
        self._prof.export_chrome_trace(self._prof_path)

    def close(self, work: int, window_len: float, unit: str, aligner=None):
        """At the window's closing: stop the profiler if it still runs,
        and take the deltas."""
        from fgdp_tpu_torch.utils.profiling import PROF
        if self._prof is not None and not self._prof_done:
            self._stop_profiler()
        self.active = False
        self.work = work
        self.unit = unit
        self.window_len = window_len
        self.prof_delta = {k: v - self._prof0.get(k, 0.0)
                           for k, v in PROF.acc.items()}
        self.prof_counts = {k: v - self._counts0.get(k, 0)
                            for k, v in PROF.counts.items()}
        if aligner is not None:
            self.stage_ms = dict(aligner.stage_ms or {})
            self.esc_stage_ms = dict(aligner.esc_stage_ms or {})

    def finish(self, ctx, run):
        """After the run: kernel ms from the event pairs, the device
        trace's busy time and breakdown; undo the patches."""
        from fgdp_tpu_torch.ops import kernels as kmod
        self.restore()
        for k in self._kernels:
            ev = kmod.TIMED.pop(k, [])
            self.kernel_ms[k] = sum(s.elapsed_time(e) for s, e in ev)
            self.kernel_launches[k] = kmod.LAUNCHES.get(k, 0) - \
                self._launch0[k]
        if self._prof_path is not None:
            with open(self._prof_path) as f:
                events = json.load(f).get("traceEvents", [])
            os.unlink(self._prof_path)
            self.busy_s, self.window_s, self.breakdown = \
                device_summary(events)

    @property
    def kreads(self) -> float:
        return self.work / 1e3


def merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_summary(events):
    """(busy_s, window_s, breakdown) of a chrome trace: the union of the
    device's activity inside the `pb.window` annotation, the device
    operations that took most time, and the idle time by the innermost
    `pb.` annotation open on the host at each gap's middle."""
    win = [e for e in events if e.get("name") == "pb.window"
           and e.get("cat") == "user_annotation"]
    if not win:
        return None, None, None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_name = [], collections.defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            s = max(float(e["ts"]), w0)
            t = min(float(e["ts"]) + float(e["dur"]), w1)
            if t > s:
                dev.append((s, t))
                by_name[e["name"]] += (t - s) * 1e-6
    busy = merge(dev)
    busy_s = sum(t - s for s, t in busy) * 1e-6
    anns = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["name"][3:]) for e in events
            if e.get("cat") == "user_annotation" and
            e.get("name", "").startswith("pb.") and e["name"] != "pb.window"
            and "dur" in e]
    gaps = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, t in zip(edges[::2], edges[1::2]):
        if t <= s:
            continue
        mid = (s + t) / 2
        open_ = [a for a in anns if a[0] <= mid < a[1]]
        name = min(open_, key=lambda a: a[1] - a[0])[2] if open_ \
            else "host (no span)"
        gaps[name] += (t - s) * 1e-6
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return busy_s, (w1 - w0) * 1e-6, {"device_ops": top(by_name),
                                      "idle_gaps": top(gaps)}

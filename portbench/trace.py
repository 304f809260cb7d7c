"""The profiled sub-window of a ``--trace 1`` run and what is read from it.

A few scenes run under ``torch.profiler`` (CPU and CUDA activity) inside
one ``record_function`` span, whose extent is the traced window.  The
trace is exported to a temporary file, read back and deleted: device
events (kernels, copies, sets), and host events (ops,
spans, runtime calls) to say what the host was doing while the device
idled.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from dataclasses import dataclass

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
WINDOW_SPAN = "portbench.traced_window"


@dataclass
class DeviceEvent:
    name: str
    cat: str
    ts: float      # us, the trace's clock
    dur: float     # us


@dataclass
class Trace:
    device: list[DeviceEvent]
    host: list[tuple[str, float, float]]    # (name, ts, dur) us
    t0: float
    t1: float
    scenes: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def intervals(self):
        """Every device event clipped to the traced window, (start, end)
        us."""
        return [(max(e.ts, self.t0), min(e.ts + e.dur, self.t1))
                for e in self.device if e.ts + e.dur > self.t0
                and e.ts < self.t1]

    @property
    def busy_s(self) -> float:
        return union_us(self.intervals()) / 1e6

    def matching(self, patterns, cat="kernel"):
        """Device events of ``cat`` whose lowercased name holds one of
        ``patterns``."""
        pats = [p.lower() for p in patterns]
        return [e for e in self.device if e.cat == cat
                and any(p in e.name.lower() for p in pats)]


def union_us(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile(run_scenes, scenes: int) -> Trace:
    """Run ``run_scenes()`` (which runs ``scenes`` scenes and
    synchronizes) under the profiler and read its trace."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            run_scenes()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return read_events(events, scenes)


def read_events(events, scenes: int) -> Trace:
    dev, host = [], []
    t0 = t1 = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append(DeviceEvent(e["name"], cat, ts, dur))
        elif cat in HOST_CATS:
            if e["name"] == WINDOW_SPAN and cat == "user_annotation":
                t0, t1 = ts, ts + dur
            else:
                host.append((e["name"], ts, dur))
    if t0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    return Trace(dev, host, t0, t1, scenes)


def idle_gaps(tr: Trace):
    """The traced window's idle gaps, each as (start, end) us."""
    gaps, cur = [], tr.t0
    merged = []
    for s, e in sorted(tr.intervals()):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for s, e in merged:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if tr.t1 > cur:
        gaps.append((cur, tr.t1))
    return gaps


def _host_at(tr: Trace, times):
    """The innermost host event running at each of the ascending
    ``times``."""
    host = sorted(tr.host, key=lambda h: h[1])
    active, out, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][1] <= t:
            name, ts, dur = host[i]
            heapq.heappush(active, (ts + dur, dur, name))
            i += 1
        while active and active[0][0] < t:
            heapq.heappop(active)
        out.append(min(active, key=lambda a: a[1])[2] if active
                   else "(host outside any traced call)")
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    idle time by what the host was doing at each gap's middle, seconds."""
    ops: dict[str, float] = {}
    for e in tr.device:
        key = e.name[:120]
        ops[key] = ops.get(key, 0.0) + e.dur / 1e6
    gaps: dict[str, float] = {}
    spans = idle_gaps(tr)
    for (s, e), name in zip(spans, _host_at(tr, [(s + e) / 2
                                                 for s, e in spans])):
        gaps[name[:120]] = gaps.get(name[:120], 0.0) + (e - s) / 1e6
    return {
        "device_ops": [[k, v] for k, v in sorted(
            ops.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k, v] for k, v in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:top]],
    }

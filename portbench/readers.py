"""Arithmetic the metrics' readers share.  Each returns None where the
run has nothing to read (no trace, no matching event), and the harness
then leaves the metric out of the result."""

from __future__ import annotations

import math


def gpix_s(ctx):
    """Input pixels of every scene completed in the window over the whole
    window, Gpix/s."""
    return ctx.scenes * ctx.pixels_per_scene / ctx.window_s / 1e9


def percentile(values, q: float):
    """Nearest-rank percentile of all ``values``."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def span_ms(ctx, name):
    """A span's ms a scene over the window's scenes."""
    v = ctx.spans.get(name)
    return sum(v) / len(v) if v else None


def device_ms(ctx, patterns):
    """Profiled device ms a scene of the kernels whose names hold one of
    ``patterns``."""
    if ctx.trace is None:
        return None
    evs = ctx.trace.matching(patterns)
    if not evs:
        return None
    return sum(e.dur for e in evs) / 1e3 / ctx.trace.scenes


def roofline_pct(ctx, patterns, bound_ms):
    """The least time of a scene's work (``bound_ms``) over the profiled
    time a scene of the kernels that did it, %."""
    ms = device_ms(ctx, patterns)
    return None if ms is None else 100.0 * bound_ms / ms


def idle_pct(ctx):
    """The traced window's share with no kernel, copy or set on the
    device, %."""
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


"""What the program's own spans and counters say about the traced
sub-window: ``span_report()`` of the port's ``utils/logging``, which keeps
records only while a profiler records (the sub-window is the only such
time in a run).  Each reader returns None where there is nothing to read:
no trace (an untraced or CPU run), or a program without spans."""

from __future__ import annotations

SCENE = "oip.scene"


def report(ctx):
    """The port's span report, or None without a trace or an
    ``oip.scene`` span in it."""
    if ctx.trace is None:
        return None
    try:
        from opticalimageprocessor_tpu_torch.utils.logging import (
            span_report,
        )
    except ImportError:
        return None
    rep = span_report()
    return rep if rep.get(SCENE, {}).get("calls") else None


def ms_a_scene(ctx, name):
    """Span ``name``'s device ms (its CUDA event pairs) a scene."""
    rep = report(ctx)
    if rep is None or "device_ms" not in rep.get(name, {}):
        return None
    return rep[name]["device_ms"] / rep[SCENE]["calls"]


def count_a_scene(ctx, name):
    """Counter ``name``'s sum a scene (0 where it never counted)."""
    rep = report(ctx)
    if rep is None:
        return None
    return rep.get(name, {}).get("count", 0) / rep[SCENE]["calls"]

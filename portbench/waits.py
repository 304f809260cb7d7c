"""What the trace and the port's spans say about the host's waits for the
card: the port's ``oip.sync`` spans (``utils/logging.host_wait``, one
around each read back, upload from pageable memory or op that
synchronizes inside), each a host range on the trace's clock.  Each
reader returns None where there is nothing to read: no trace, or a
program without ``oip.sync`` spans."""

from __future__ import annotations

from portbench.spans import SCENE, report
from portbench.trace import idle_gaps

SYNC = "oip.sync"


def ranges(tr, name):
    """The host events named ``name``, (start, end) us."""
    return [(ts, ts + dur) for n, ts, dur in tr.host if n == name]


def wait_gap_ms(ctx):
    """Device idle ms a scene that the host's waits open: the gaps
    ``host_gap_ms.resident`` counts (middle inside a host ``oip.scene``)
    whose start lies inside an ``oip.sync``.  A gap that opens while the
    host waits belongs to the wait, with the host work the wait made
    serial; one that opens anywhere else is the host behind with its
    launches."""
    tr = ctx.trace
    if tr is None:
        return None
    scenes, waits = ranges(tr, SCENE), ranges(tr, SYNC)
    if not scenes or not waits:
        return None
    idle_us = sum(e - s for s, e in idle_gaps(tr)
                  if any(a <= (s + e) / 2 < b for a, b in scenes)
                  and any(a <= s <= b for a, b in waits))
    return idle_us / 1e3 / len(scenes)


def waits_a_scene(ctx):
    """``oip.sync`` spans a scene over the traced sub-window, from the
    port's span report."""
    rep = report(ctx)
    if rep is None or SYNC not in rep:
        return None
    return rep[SYNC]["calls"] / rep[SCENE]["calls"]

"""host_gap_ms.resident: device idle ms a scene inside the port's forward:
the traced sub-window's idle gaps whose middle falls inside a host
``oip.scene`` span (the harness's own gaps between scenes fall outside)."""

from portbench.spans import SCENE
from portbench.trace import idle_gaps


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    scenes = [(ts, ts + dur) for name, ts, dur in tr.host if name == SCENE]
    if not scenes:
        return None
    idle_us = sum(e - s for s, e in idle_gaps(tr)
                  if any(a <= (s + e) / 2 < b for a, b in scenes))
    return idle_us / 1e3 / len(scenes)

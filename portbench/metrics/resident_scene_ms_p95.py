"""resident_scene_ms_p95: the 95th percentile over every scene of the
window of the time from the call to its outputs being complete, taken by
CUDA events recorded around the call."""

from portbench.readers import percentile


def read(ctx):
    return percentile(ctx.scene_ms, 95)

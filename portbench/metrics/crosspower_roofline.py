"""crosspower_roofline: the least time of the scene's windowed
cross-power work (every tile against every band, its shapes from the
scene) over the profiled time of kernel (b), csrc/crosspower.cu."""

from portbench.readers import roofline_pct
from portbench.roofline import crosspower_bound_ms

PATTERNS = ("crosspower",)


def read(ctx):
    shape = ctx.shapes.get("crosspower")
    if shape is None:
        return None
    return roofline_pct(ctx, PATTERNS, crosspower_bound_ms(*shape))

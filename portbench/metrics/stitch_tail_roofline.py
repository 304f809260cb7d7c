"""stitch_tail_roofline: the least time of the scene's stitch tail
(RRC of both PANs, the prestitch translation, the seam concat) over the
profiled time of kernel (d), csrc/stitch_tail.cu."""

from portbench.readers import roofline_pct
from portbench.roofline import stitch_bound_ms

PATTERNS = ("stitch_tail",)


def read(ctx):
    shape = ctx.shapes.get("stitch_tail")
    if shape is None:
        return None
    return roofline_pct(ctx, PATTERNS, stitch_bound_ms(*shape))

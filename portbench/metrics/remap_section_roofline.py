"""remap_section_roofline: the least time of the parity scene's section
remaps (``roofline_parity.py``, from the scene's shapes and the
reference's section loops at the scene's stt shift) over the profiled
time of kernel (f), csrc/remap_section.cu, %."""

from portbench.readers import roofline_pct
from portbench.roofline_parity import section_bound_ms

PATTERNS = ("remap_section",)


def read(ctx):
    calls = ctx.shapes.get("remap_section")
    if not calls:
        return None
    return roofline_pct(ctx, PATTERNS, section_bound_ms(calls))

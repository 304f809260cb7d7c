"""seam_ms.dual: the two aligned MSS rasters stitched at the seam, the
port's ``oip.seam`` span, device ms a scene over the traced
sub-window."""

from portbench.spans import ms_a_scene


def read(ctx):
    return ms_a_scene(ctx, "oip.seam")

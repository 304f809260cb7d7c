"""reg_correlate_ms.resident: the registration's windowed cross-power
(kernel (b)), the ky contraction and the centroid, the port's
``oip.register.correlate`` span, device ms a scene over the traced
sub-window."""

from portbench.spans import ms_a_scene


def read(ctx):
    return ms_a_scene(ctx, "oip.register.correlate")

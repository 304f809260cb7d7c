"""surface_ms.parity: the full-surface cv::phaseCorrelate of the parity
scene (the pad, the forward transforms, the whitened cross-power, the
inverse, the quadrant swap, the peak), the registration's 200 pairs and
the stt's 10, the port's ``oip.register.surface`` span, device ms a scene
over the traced sub-window."""

from portbench.spans import ms_a_scene


def read(ctx):
    return ms_a_scene(ctx, "oip.register.surface")

"""upsample_ms.parity: the cv::resize x4 INTER_CUBIC of the parity
registration's band tiles, the port's ``oip.upsample`` span, device ms a
scene over the traced sub-window."""

from portbench.spans import ms_a_scene


def read(ctx):
    return ms_a_scene(ctx, "oip.upsample")

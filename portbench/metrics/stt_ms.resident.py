"""stt_ms.resident: the stt estimate on the CMOS overlap strips, the
port's ``oip.stt`` span, device ms a scene over the traced sub-window."""

from portbench.spans import ms_a_scene


def read(ctx):
    return ms_a_scene(ctx, "oip.stt")

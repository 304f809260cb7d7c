"""align2_ms.dual: CMOS2's MSS aligned against the prestitched PAN2 (its
RRC by kernel (a), the second registration, one kernel-(c) launch at row
bound 6), the port's ``oip.align2`` span, device ms a scene over the
traced sub-window."""

from portbench.spans import ms_a_scene


def read(ctx):
    return ms_a_scene(ctx, "oip.align2")

"""reg_tiles_ms.resident: the registration's tile gather (each section's
tiles cut, RRC'd by kernel (a), cast to float32), the port's
``oip.register.tiles`` span, device ms a scene over the traced
sub-window."""

from portbench.spans import ms_a_scene


def read(ctx):
    return ms_a_scene(ctx, "oip.register.tiles")

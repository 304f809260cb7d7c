"""reg_spectra_ms.resident: the registration's spectra (the tiles' cats,
the padded rfft2 of the PAN tiles, the fft2 of the band tiles), the
port's ``oip.register.spectra`` span, device ms a scene over the traced
sub-window."""

from portbench.spans import ms_a_scene


def read(ctx):
    return ms_a_scene(ctx, "oip.register.spectra")

"""sections_ms.parity: every section remap of the parity transform
(PreStitch's sections and rolling-buffer window of PAN2, the alignment's
sections of each band; kernel (f) and the copy of each band's rows into
the interleaved raster), the port's ``oip.remap.sections`` span, device
ms a scene over the traced sub-window."""

from portbench.spans import ms_a_scene


def read(ctx):
    return ms_a_scene(ctx, "oip.remap.sections")

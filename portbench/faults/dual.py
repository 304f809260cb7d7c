"""Faults of the timed path that judge ``dual`` has to catch: judge
``scene``'s, which break the scene's half (and, through the functions the
two halves share, CMOS2's too), and one for each of the numbers judge
``dual`` adds.  Each is planted by monkeypatching the port underneath the
route and returns the name of the number that must then read above its
limit; :func:`unmoved` names those that must still read 0
(``test_portbench_runs.py``)."""

import torch

from opticalimageprocessor_tpu_torch.models import device_pipeline

from . import scene
from ..judges.dual import NUMBERS
# judge scene's faults, found here by name
from .scene import (  # noqa: F401
    _altered_pixel,
    _fit_shifted_with_its_rasters,
    _half_the_tiles,
    _raster_never_written,
    _stt_shifted_with_its_raster,
)


def _prestt_shifted_with_its_raster(monkeypatch):
    # CMOS2's MSS registered against a prestitched PAN2 one row off: its
    # fit is wrong, and its aligned raster follows that fit
    real = device_pipeline.MssAlign.forward

    def shifted(self, pan_c, mss):
        return real(self, torch.roll(pan_c, 1, 0), mss)

    monkeypatch.setattr(device_pipeline.MssAlign, "forward", shifted)
    return "fit2_gap_px"


def _aligned2_pixel_flipped(monkeypatch):
    # a pixel in the columns that the seam folds away, so that only the
    # aligned CMOS2 MSS shows it
    real = device_pipeline.MssAlign.remap

    def altered(self, *a, **kw):
        out = real(self, *a, **kw)
        out[5, 3, 1] = (out[5, 3, 1].to(torch.int32) ^ 1).to(torch.uint16)
        return out

    monkeypatch.setattr(device_pipeline.MssAlign, "remap", altered)
    return "aligned2_dn_gap"


def _seam_one_column_left(monkeypatch):
    # CMOS1's raster cut one column early and CMOS2's one column early:
    # the stitched MSS has its width, every column one to the left
    def shifted(aligned, aligned2, fold_cols):
        fh = device_pipeline.mss_fold_half(fold_cols)
        return torch.cat([aligned[:, :aligned.shape[1] - fh - 1],
                          aligned2[:, fh - 1:]], dim=1)

    monkeypatch.setattr(device_pipeline, "stitch_mss_seam", shifted)
    return "stitched_mss_dn_gap"


# each of this judge's own faults and the one number it moves
OWN = {_prestt_shifted_with_its_raster: "fit2_gap_px",
       _aligned2_pixel_flipped: "aligned2_dn_gap",
       _seam_one_column_left: "stitched_mss_dn_gap"}
FAULTS = scene.FAULTS + list(OWN)


def unmoved(fault) -> tuple[str, ...]:
    """The numbers that read 0 under ``fault``: each of this judge's own
    faults moves its number alone; judge ``scene``'s self-consistent
    faults leave every raster as the program's estimate gives it."""
    if fault in OWN:
        return tuple(k for k in NUMBERS if k != OWN[fault])
    if fault in scene.SELF_CONSISTENT:
        return scene.unmoved(fault) + ("aligned2_dn_gap",
                                       "stitched_mss_dn_gap")
    return ()

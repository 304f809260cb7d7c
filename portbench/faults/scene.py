"""Faults of the timed path that judge ``scene`` has to catch.

Each fault is planted by monkeypatching the port underneath the route
(pytest's ``monkeypatch``) and returns the name of the number that must
then read above its limit.  ``test_portbench_runs.py`` runs every cell
whose configuration names this judge once under each fault in
:data:`FAULTS`, and checks the numbers that :func:`unmoved` names read 0.
"""

import torch

from opticalimageprocessor_tpu_torch.models import device_pipeline


def _altered_pixel(monkeypatch):
    real = device_pipeline.remap_const_stitch_chunked

    def altered(*a, **kw):
        out = real(*a, **kw)
        st = out[0] if isinstance(out, tuple) else out
        st[7, 11] = (st[7, 11].to(torch.int32) ^ 1).to(torch.uint16)
        return out

    monkeypatch.setattr(device_pipeline, "remap_const_stitch_chunked",
                        altered)
    return "stitched_dn_gap"


def _raster_never_written(monkeypatch):
    real = device_pipeline.remap_bands_interleaved

    def unwritten(src, *a, **kw):
        return torch.zeros_like(real(src, *a, **kw))

    monkeypatch.setattr(device_pipeline, "remap_bands_interleaved",
                        unwritten)
    return "aligned_dn_gap"


def _half_the_tiles(monkeypatch):
    real = device_pipeline.fit_tiles

    def half(geom, dx, dy, rs, threshold=0.4):
        rs = rs.clone()
        rs[rs.shape[0] // 2:] = 0.0     # left out; the fit over the rest
        return real(geom, dx, dy, rs, threshold)

    monkeypatch.setattr(device_pipeline, "fit_tiles", half)
    return "fit_gap_px"


def _fit_shifted_with_its_rasters(monkeypatch):
    # a wrong estimate that the transform then follows: the rasters agree
    # with the reference's resample at that estimate, the fit does not
    real = device_pipeline.fit_tiles

    def shifted(*a, **kw):
        coeffs, n_valid = real(*a, **kw)
        return [(cx + torch.tensor([2e-3, 0.0]), cy)
                for cx, cy in coeffs], n_valid

    monkeypatch.setattr(device_pipeline, "fit_tiles", shifted)
    return "fit_gap_px"


def _stt_shifted_with_its_raster(monkeypatch):
    real = device_pipeline.stt_average

    def shifted(*a, **kw):
        dx, dy, rs, n = real(*a, **kw)
        return dx + 0.25, dy, rs, n

    monkeypatch.setattr(device_pipeline, "stt_average", shifted)
    return "stt_gap_px"


FAULTS = [_altered_pixel, _raster_never_written, _half_the_tiles,
          _fit_shifted_with_its_rasters, _stt_shifted_with_its_raster]
SELF_CONSISTENT = (_fit_shifted_with_its_rasters, _stt_shifted_with_its_raster)


def unmoved(fault) -> tuple[str, ...]:
    """The numbers that read 0 under ``fault``: the rasters alone, judged
    at the program's estimate, miss a self-consistent fault."""
    if fault in SELF_CONSISTENT:
        return ("aligned_dn_gap", "stitched_dn_gap")
    return ()

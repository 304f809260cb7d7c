"""Faults of the timed path that judge ``parity`` has to catch.

Each fault is planted by monkeypatching the port underneath the route
(pytest's ``monkeypatch``) and returns the name of the number that must
then read above its limit; :func:`unmoved` names those that must still
read 0.  :data:`FAULTS` show at any size, and ``test_portbench_runs.py``
runs each on every cell judged here at its small size; :data:`SECTIONED`
show only where the strips have what they break -- two or more PreStitch
sections with a bottom cut, a strip longer than one 16000-line
registration block -- and ``test_portbench_parity.py`` runs them, with
:data:`FAULTS`, at such a size.
"""

import torch

from opticalimageprocessor_tpu_torch.models import device_pipeline
from opticalimageprocessor_tpu_torch.ops import phasecorr, resample

from ..judges.parity import NUMBERS

ESTIMATE = ("fit_gap_px", "stt_gap_px")


def _altered_prestt_pixel(monkeypatch):
    real = device_pipeline.ParityScenePipeline.prestitch

    def altered(self, *a, **kw):
        out = real(self, *a, **kw)
        out[7, 11] = (out[7, 11].to(torch.int32) ^ 1).to(torch.uint16)
        return out

    monkeypatch.setattr(device_pipeline.ParityScenePipeline, "prestitch",
                        altered)
    return "prestt_dn_gap"


def _continuous_coordinates(monkeypatch):
    # OpenCV 5.x's continuous coordinates in place of the configuration's
    # 1/32-px grid, for every section remap
    for name in ("plan_for_constant_shift", "plan_for_band_alignment"):
        real = getattr(device_pipeline, name)

        def continuous(*a, _real=real, **kw):
            kw.pop("quantized_coords", None)
            return _real(*a[:3], quantized_coords=False, **kw)

        monkeypatch.setattr(device_pipeline, name, continuous)
    return "prestt_dn_gap"


def _spectral_upsample(monkeypatch):
    # the fast route's circular upsample, taken spectrally, in place of
    # cv::resize's replicated edges: an estimate that the rasters follow
    def spectral(band):
        m, n = band.shape[-2:]
        return torch.fft.irfft2(phasecorr.upsampled_band_spectrum(band),
                                s=(4 * m, 4 * n))

    monkeypatch.setattr(device_pipeline, "upsample4_f32", spectral)
    return "fit_gap_px"


def _stt_shifted_with_its_raster(monkeypatch):
    real = device_pipeline.stt_average_host

    def shifted(*a, **kw):
        dx, dy, r, n = real(*a, **kw)
        return dx + 0.25, dy, r, n

    monkeypatch.setattr(device_pipeline, "stt_average_host", shifted)
    return "stt_gap_px"


def _fresh_tail_bottom_cut(monkeypatch):
    # the last section's own bottom rows in place of the rolling buffer's
    real = resample.sectionary_plan

    def fresh(lines, section_rows, dy):
        sp = real(lines, section_rows, dy)
        if not sp.window:
            return sp
        c = sp.cuts[-1]
        last = resample.SectionCut(c.offset, c.rows, c.first,
                                   c.count + sp.bcut, c.dst)
        return resample.SectionaryPlan(sp.cuts[:-1] + (last,), (), 0,
                                       sp.bcut, sp.end)

    monkeypatch.setattr(device_pipeline, "sectionary_plan", fresh)
    return "prestt_dn_gap"


def _fast_grid(monkeypatch):
    # the fast route's tile grid (row blocks from line 0, rounded to 64
    # lines) in place of the reference's equal gaps
    def fast(self, lines, width):
        return device_pipeline.register_geometry(
            lines, width, self.slices, self.n_sections)

    monkeypatch.setattr(device_pipeline.ParityScenePipeline, "geometry",
                        fast)
    return "fit_gap_px"


FAULTS = [_altered_prestt_pixel, _continuous_coordinates, _spectral_upsample,
          _stt_shifted_with_its_raster]
SECTIONED = [_fresh_tail_bottom_cut, _fast_grid]
# each fault and the numbers it leaves at 0
_UNMOVED = {
    _altered_prestt_pixel: ESTIMATE + ("aligned_dn_gap",),
    _continuous_coordinates: ESTIMATE,
    _spectral_upsample: ("stt_gap_px",) + NUMBERS[2:],
    _stt_shifted_with_its_raster: ("fit_gap_px",) + NUMBERS[2:],
    _fresh_tail_bottom_cut: ESTIMATE + ("aligned_dn_gap",),
    _fast_grid: ("stt_gap_px",) + NUMBERS[2:],
}


def unmoved(fault) -> tuple[str, ...]:
    """The numbers that read 0 under ``fault``: a wrong estimate leaves
    the rasters as the reference resamples them at it; a wrong resample
    leaves the estimate."""
    return _UNMOVED[fault]

"""Judge ``dual``: the whole sample task's estimates and rasters against
the plain reference.

Judge ``scene``'s four numbers on the scene's half (``judges/scene.py``),
and three more on CMOS2's MSS.  The reference's estimate is wholly its
own: its own stt deltas, clamped, give its own prestitched PAN2
(``reference_dual.prestt``), against which it registers CMOS2's MSS
(``reference_dual.register2``).  The kept scenes' rasters are resampled
at the program's own estimate, as judge ``scene`` resamples them: CMOS2's
aligned MSS at the program's second fit, the stitched MSS as the seam of
the reference's two aligned rasters.

The numbers compared, besides judge ``scene``'s, each against its limit
in ``limits/<config>.json``:

* ``fit2_gap_px``: the widest gap, in PAN pixels, between the program's
  and the reference's fitted shifts of CMOS2's bands, the worst scene of
  the window; infinite where a band's count of valid tiles differs;
* ``aligned2_dn_gap``, ``stitched_mss_dn_gap``: the largest DN
  difference of a sampled scene's aligned CMOS2 MSS and stitched MSS from
  the reference's.

A route judged here returns the estimate ``(cx, cy, n_valid, raw_dx,
raw_dy, n_stt, cx2, cy2, n_valid2)`` from ``run`` and the rasters
``(aligned, stitched, aligned2, stitched_mss)`` from ``rasters``.
"""

from __future__ import annotations

import torch

from .. import reference as ref
from .. import reference_dual as dual
from ..judge import dn_gap
from . import scene

NUMBERS = scene.NUMBERS + ("fit2_gap_px", "aligned2_dn_gap",
                           "stitched_mss_dn_gap")
# the numbers of the rasters, in the order of the route's ``rasters``
RASTERS = ("aligned_dn_gap", "stitched_dn_gap", "aligned2_dn_gap",
           "stitched_mss_dn_gap")


def reference_estimate(scene_, tables, cfg, prec=ref.Precision(),
                       responses=None):
    """The reference's (cx, cy, n_valid, dx, dy, n_stt, cx2, cy2,
    n_valid2) of one scene."""
    est = scene.reference_estimate(scene_, tables, cfg, prec, responses)
    dx, dy = ref.clamp_stt(est[3], est[4], cfg["col_halo"],
                           cfg["prestt_row_bound"])
    width = scene_.pan2.shape[1]
    p = dual.prestt(scene_.pan2, tables.pan2, dx, dy,
                    ref.col_block_size(width, cfg["col_block"]),
                    cfg["col_halo"], prec)
    fit2 = dual.register2(p, scene_.mss2, tables.mss2, cfg, prec, responses)
    return (*est, *fit2)


def response_margin(responses, cfg) -> float:
    """The least distance of the responses that :func:`reference_estimate`
    collected (the registration's, the stt's, then the second
    registration's) from their thresholds."""
    thr = (cfg["threshold"], cfg["stt_threshold"], cfg["threshold"])
    return min(float((r - t).abs().min()) for r, t in zip(responses, thr))


def aligned2(scene_, tables, cfg, cx2, cy2, prec=ref.Precision()):
    """The reference's aligned CMOS2 MSS at the fit (``cx2``, ``cy2``)."""
    mss_c = ref.rrc(scene_.mss2, *tables.mss2, prec)
    bw = mss_c.shape[-1]
    return torch.stack([
        ref.remap_band(mss_c[b], cx2[b], cy2[b], cfg["mss2_row_bound"],
                       ref.col_block_size(bw, cfg["col_block"]),
                       cfg["col_halo"], prec)
        for b in range(mss_c.shape[0])], dim=-1)


def reference_rasters(scene_, tables, cfg, est, prec=ref.Precision()):
    """The reference's (aligned, stitched, aligned2, stitched_mss) at the
    estimate ``est``."""
    ra, rs = scene.reference_rasters(scene_, tables, cfg, est[:6], prec)
    ra2 = aligned2(scene_, tables, cfg, est[6], est[7], prec)
    return ra, rs, ra2, dual.seam(ra, ra2, cfg["fold_cols"])


def estimate_gaps(prog, refe, width: int) -> dict:
    """Gaps of one scene's estimate (tensors or host values) from the
    reference's."""
    gaps = scene.estimate_gaps(prog[:6], refe[:6], width)
    # the second fit's gap is judge scene's fit gap of (cx2, cy2, n_valid2)
    # with no stt deltas beside it
    no_stt = (0.0, 0.0, 0)
    gaps["fit2_gap_px"] = scene.estimate_gaps(
        (*prog[6:], *no_stt), (*refe[6:], *no_stt), width)["fit_gap_px"]
    return gaps


def raster_gaps(scene_, tables, cfg, est, rasters,
                prec=ref.Precision()) -> dict:
    """DN gaps of a scene's rasters ``(aligned, stitched, aligned2,
    stitched_mss)`` from the reference's at the scene's own estimate
    ``est``."""
    want = reference_rasters(scene_, tables, cfg, est, prec)
    return {k: dn_gap(got, ref_) for k, got, ref_ in zip(RASTERS, rasters,
                                                          want)}

"""Judge ``parity``: the reference binary's own sample task (the file
commands' parity route, on resident strips) against its plain reference.

Every scene of the window hands back its estimate: the bands' fitted
shift polynomials ``cx`` (4, 2) / ``cy`` (4, 3), float64, with their valid
counts, and the raw averaged stt deltas with theirs (the parity route
does not clamp them).  Each is held against the plain reference's
estimate of the same scene (``reference_parity.py``, on the same RAW
strips and RRC tables).  A sample of the window's scenes, drawn from the
seed, also keeps its rasters: the aligned MSS (L/4 - overlap, W/4, 4), the
prestitched PAN2 (L, W) and the stitched PAN (L, 2 * (W - fold)).  The
reference resamples those at the program's own estimate of that scene
(``cv::remap`` in the configuration's coordinates, in the reference's two
section loops, the rolling-buffer bottom cut included) and they must
agree byte for byte, as judge ``scene``'s rasters must.

The numbers compared, each against its limit in ``limits/<config>.json``:

* ``fit_gap_px``, ``stt_gap_px``: as judge ``scene`` reads them
  (``judges/scene.py``), infinite where a valid count differs;
* ``aligned_dn_gap``, ``prestt_dn_gap``, ``stitched_dn_gap``: the
  largest DN difference of a sampled raster from the reference's.

A route judged here returns the estimate ``(cx, cy, n_valid, raw_dx,
raw_dy, n_stt)`` from ``run`` and the rasters ``(aligned, prestt,
stitched)`` from ``rasters``.
"""

from __future__ import annotations

from .. import reference as ref
from .. import reference_parity as parity
from ..judge import dn_gap
from . import scene

NUMBERS = ("fit_gap_px", "stt_gap_px", "aligned_dn_gap", "prestt_dn_gap",
           "stitched_dn_gap")
# the numbers of the rasters, in the order of the route's ``rasters``
RASTERS = ("aligned_dn_gap", "prestt_dn_gap", "stitched_dn_gap")


def quantized(cfg) -> bool:
    return cfg["coord_mode"] == "quantized"


def reference_estimate(scene_, tables, cfg, prec=ref.Precision(),
                       responses=None):
    """The reference's (cx, cy, n_valid, dx, dy, n_stt) of one scene: the
    registration of the RRC'd PAN1 against the RRC'd bands, then the stt
    on the RAW strips."""
    cx, cy, n_valid = parity.register(
        scene_.pan1, scene_.mss, tables.pan1, tables.mss, cfg["slices"],
        cfg["sections"], cfg["threshold"], prec, responses)
    dx, dy, n_stt = parity.stt_estimate(
        scene_.pan1, scene_.pan2, cfg["stt_sections"], cfg["stt_lines"],
        cfg["fold_cols"], cfg["edge_cols"], cfg["stt_threshold"],
        cfg["stt_max_delta_y"], prec, responses)
    return cx, cy, n_valid, dx, dy, n_stt


def response_margin(responses, cfg) -> float:
    """The least distance of the responses that :func:`reference_estimate`
    collected (the registration's, then the stt's) from their
    thresholds."""
    return scene.response_margin(responses, cfg)


def reference_rasters(scene_, tables, cfg, est, prec=ref.Precision()):
    """The reference's (aligned, prestt, stitched) at the estimate
    ``est``."""
    cx, cy, _n, dx, dy, _ns = est
    q = quantized(cfg)
    aligned = parity.align(scene_.mss, tables.mss, cx, cy,
                           cfg["line_per_section"], cfg["section_overlap"],
                           q, prec)
    prestt = parity.prestitch(scene_.pan2, tables.pan2, float(dx), float(dy),
                              cfg["remap_section_rows"], q, prec)
    stitched = parity.stitch(scene_.pan1, tables.pan1, prestt,
                             cfg["fold_cols"] // 2, prec)
    return aligned, prestt, stitched


estimate_gaps = scene.estimate_gaps


def raster_gaps(scene_, tables, cfg, est, rasters,
                prec=ref.Precision()) -> dict:
    """DN gaps of a scene's rasters ``(aligned, prestt, stitched)`` from
    the reference's at the scene's own estimate ``est``."""
    want = reference_rasters(scene_, tables, cfg, est, prec)
    return {k: dn_gap(got, ref_) for k, got, ref_ in zip(RASTERS, rasters,
                                                          want)}

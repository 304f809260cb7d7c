"""Judge ``scene``: the scene pipeline's estimate and rasters against the
plain reference.

Every scene of the window hands back its estimate: the bands' fitted
shift polynomials ``cx`` (4, 2) / ``cy`` (4, 3) with their valid counts,
and the averaged stt deltas with theirs.  Each is held against the plain
reference's estimate of the same scene (``reference.py``, on the same RAW
strips and RRC tables).  A sample of the window's scenes, drawn from the
seed, also keeps its rasters: the aligned MSS (L/4, W/4, 4) and the
stitched PAN (L, 2*(W - fold)).  The reference resamples those at the
program's own estimate of that scene and they must agree byte for byte:
a sub-ulp difference between two sound fits moves a cubic weight in its
last bit and can flip a pixel's rounding, so rasters at the reference's
own estimate could never be held exactly; the estimate is held by
itself.

The numbers compared, each against its limit in ``limits/<config>.json``:

* ``fit_gap_px``: the widest gap, in PAN pixels, between the program's
  and the reference's fitted shifts (x and y polynomials) over every band
  column, the worst scene of the window; infinite where a band's count of
  valid tiles differs (the fits are then over different tiles);
* ``stt_gap_px``: the widest gap of the raw stt deltas (dx, dy);
  infinite where the count of valid sections differs;
* ``aligned_dn_gap``, ``stitched_dn_gap``: the largest DN difference of
  a sampled raster from the reference's.

A route judged here returns the estimate ``(cx, cy, n_valid, raw_dx,
raw_dy, n_stt)`` from ``run`` and the rasters ``(aligned, stitched)``
from ``rasters``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import reference as ref
from ..judge import dn_gap

NUMBERS = ("fit_gap_px", "stt_gap_px", "aligned_dn_gap", "stitched_dn_gap")


def reference_estimate(scene, tables, cfg, prec=ref.Precision(),
                       responses=None):
    """The reference's (cx, cy, n_valid, dx, dy, n_stt) of one scene."""
    cx, cy, n_valid = ref.register(scene.pan1, scene.mss, tables.pan1,
                                   tables.mss, cfg["slices"],
                                   cfg["sections"], cfg["threshold"], prec,
                                   responses=responses)
    dx, dy, n_stt = ref.stt_estimate(scene.pan1, scene.pan2,
                                     cfg["stt_sections"], cfg["stt_lines"],
                                     cfg["fold_cols"], cfg["stt_threshold"],
                                     prec, responses=responses)
    return cx, cy, n_valid, dx, dy, n_stt


def response_margin(responses, cfg) -> float:
    """The least distance of the responses that :func:`reference_estimate`
    collected (the registration's, then the stt's) from their thresholds:
    how near a valid count came to changing."""
    thr = (cfg["threshold"], cfg["stt_threshold"])
    return min(float((r - t).abs().min()) for r, t in zip(responses, thr))


def reference_rasters(scene, tables, cfg, est, prec=ref.Precision()):
    """The reference's (aligned, stitched) at the estimate ``est``."""
    cx, cy, _n, raw_dx, raw_dy, _ns = est
    mss_c = ref.rrc(scene.mss, *tables.mss, prec)
    width = scene.pan1.shape[1]
    bw = mss_c.shape[-1]
    aligned = torch.stack([
        ref.remap_band(mss_c[b], cx[b], cy[b], cfg["row_bound"],
                       ref.col_block_size(bw, cfg["col_block"]),
                       cfg["col_halo"], prec)
        for b in range(mss_c.shape[0])], dim=-1)
    del mss_c
    dx, dy = ref.clamp_stt(raw_dx, raw_dy, cfg["col_halo"],
                           cfg["prestt_row_bound"])
    stitched = ref.stitch(scene.pan1, scene.pan2, tables.pan1, tables.pan2,
                          dx, dy, cfg["fold_cols"] // 2,
                          ref.col_block_size(width, cfg["col_block"]),
                          cfg["col_halo"], prec)
    return aligned, stitched


def _host(est):
    cx, cy, n_valid, dx, dy, n_stt = est
    return (np.asarray(cx.detach().cpu(), np.float64),
            np.asarray(cy.detach().cpu(), np.float64),
            np.asarray(n_valid.detach().cpu(), np.int64),
            float(dx), float(dy), int(n_stt))


def estimate_gaps(prog, refe, width: int) -> dict:
    """Gaps of one scene's estimate (tensors or host values) from the
    reference's."""
    pcx, pcy, pn, pdx, pdy, pns = _host(prog)
    rcx, rcy, rn, rdx, rdy, rns = _host(refe)
    xx = 4.0 * np.arange(width // 4, dtype=np.float64)
    sx = (pcx[:, 1:2] - rcx[:, 1:2]) * xx + (pcx[:, 0:1] - rcx[:, 0:1])
    sy = ((pcy[:, 2:3] - rcy[:, 2:3]) * xx * xx
          + (pcy[:, 1:2] - rcy[:, 1:2]) * xx + (pcy[:, 0:1] - rcy[:, 0:1]))
    fit = float(np.max(np.abs(np.concatenate([sx, sy]))))
    stt = float(np.max(np.abs([pdx - rdx, pdy - rdy])))
    # a NaN (a singular fit) or another set of valid tiles or sections
    # reads as infinitely far
    if not math.isfinite(fit) or not np.array_equal(pn, rn):
        fit = math.inf
    if not math.isfinite(stt) or pns != rns:
        stt = math.inf
    return {"fit_gap_px": fit, "stt_gap_px": stt}


def raster_gaps(scene, tables, cfg, est, rasters,
                prec=ref.Precision()) -> dict:
    """DN gaps of a scene's rasters ``(aligned, stitched)`` from the
    reference's at the scene's own estimate ``est``."""
    aligned, stitched = rasters
    ra, rs = reference_rasters(scene, tables, cfg, est, prec)
    return {"aligned_dn_gap": dn_gap(aligned, ra),
            "stitched_dn_gap": dn_gap(stitched, rs)}

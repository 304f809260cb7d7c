"""Least-squares polynomial fitting of inter-band shift samples.

Copied verbatim from ``opticalimageprocessor_tpu/ops/polyfit.py`` (a numpy
module, but importing it through ``opticalimageprocessor_tpu.ops`` would
load jax); only the constants import names the port's copy.

Reproduces the reference's NumCpp fits (preproc.h:514-550): for each MSS
band, fit ``dx = c1*cx + c0`` (degree 1) and ``dy = c2*cx^2 + c1*cx + c0``
(degree 2) over the valid (response >= threshold) phase-correlation samples,
with coefficients returned in ascending order like ``Poly1d::coefficients``.

The sample counts are tiny (slices x sections <= O(100)), so the solve runs
on the host in float64 — this is deliberately NOT a device op; the gathered
(dx, dy, response) statistics are the only thing that crosses back from the
device (see models/align.py), matching the reference's data flow where the
fit consumes the logged shift table.
"""

from __future__ import annotations

import numpy as np


def polyfit_ascending(x: np.ndarray, y: np.ndarray, deg: int) -> np.ndarray:
    """Least-squares Vandermonde fit; coefficients ascending [c0, c1, ...]."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.size < deg + 1:
        raise ValueError(f"need at least {deg + 1} samples, got {x.size}")
    v = np.vander(x, deg + 1, increasing=True)
    coeffs, *_ = np.linalg.lstsq(v, y, rcond=None)
    return coeffs


def fit_shift_models(
    cx: np.ndarray, dx: np.ndarray, dy: np.ndarray, valid: np.ndarray
):
    """Fit the per-band shift polynomials from correlation samples.

    ``cx``: slice-center x positions; ``dx``/``dy``: measured shifts;
    ``valid``: boolean mask (response-thresholded).  Returns
    (coeff_x[2] ascending, coeff_y[3] ascending).
    """
    cxv = np.asarray(cx, np.float64)[valid]
    cx_coeffs = polyfit_ascending(cxv, np.asarray(dx, np.float64)[valid], 1)
    cy_coeffs = polyfit_ascending(cxv, np.asarray(dy, np.float64)[valid], 2)
    return cx_coeffs, cy_coeffs


def fit_shift_models_filtered(
    cx: np.ndarray,
    dx: np.ndarray,
    dy: np.ndarray,
    rs: np.ndarray,
    threshold: float,
    band_no: int,
):
    """Response-filter + fit one band (FilterInterBandShiftValues +
    DoCorrelationPolynomialFitting, preproc.h:492-550): samples with
    ``rs < threshold`` are excluded, and fewer than ``IBCV_MIN_COUNT``
    survivors is the reference's hard error (preproc.h:505-510).

    Single source of truth for both the host ``PreProcessor`` and the
    sharded multi-chip align step, so their coefficients agree exactly.
    """
    from ..constants import IBCV_MIN_COUNT

    valid = np.asarray(rs, np.float64) >= threshold
    n_valid = int(valid.sum())
    if n_valid < IBCV_MIN_COUNT:
        raise RuntimeError(
            f"Not enough valid correlation values for band#{band_no}: "
            f"{n_valid} valid values found, {IBCV_MIN_COUNT} expected at "
            "least"
        )
    return fit_shift_models(cx, dx, dy, valid)

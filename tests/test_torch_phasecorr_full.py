"""Full-surface cv::phaseCorrelate (ops/phasecorr.phase_correlate*) and
the copied numpy helpers (get_optimal_dft_size, ops/polyfit) against the
JAX package."""

import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu.ops import cv_exact
from opticalimageprocessor_tpu.ops import phasecorr as jpc
from opticalimageprocessor_tpu.ops import polyfit as jpolyfit
from opticalimageprocessor_tpu_torch.ops import phasecorr, polyfit

torch.set_num_threads(2)


def _rolled_pairs(rng, t, h, w, noise=50.0):
    """Noise tiles and the same tiles rolled by known (dy, dx), plus noise."""
    a = (rng.random((t, h, w)) * 1000).astype(np.float32)
    shifts = [(int(rng.integers(-5, 6)), int(rng.integers(-7, 8)))
              for _ in range(t)]
    b = np.stack([np.roll(a[i], s, (0, 1)) for i, s in enumerate(shifts)])
    b = (b + rng.random(b.shape) * noise).astype(np.float32)
    return a, b, shifts


@pytest.mark.parametrize("shape", [(4, 250, 60), (3, 96, 200), (2, 61, 47)])
def test_phase_correlate_batch_matches_jax(rng, shape):
    """dx, dy within 1e-4 px and the response within 1e-4 of JAX on rolled
    noise tiles, padded to the optimal DFT size (250 x 60 pads to 250 x
    60, 61 x 47 to 64 x 48); and the rolls come back."""
    a, b, shifts = _rolled_pairs(rng, *shape)
    want = [np.asarray(x) for x in jpc.phase_correlate_batch(a, b)]
    got = [x.numpy() for x in phasecorr.phase_correlate_batch(
        torch.from_numpy(a), torch.from_numpy(b))]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (shape[0],)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    # zero padding (61 x 47 -> 64 x 48) breaks the circular roll: the
    # centroid then reads ~0.15 px off it, in both packages
    tol = 0.05 if phasecorr.get_optimal_dft_size(shape[1]) == shape[1] \
        and phasecorr.get_optimal_dft_size(shape[2]) == shape[2] else 0.2
    np.testing.assert_allclose(got[0], [s[1] for s in shifts], atol=tol)
    np.testing.assert_allclose(got[1], [s[0] for s in shifts], atol=tol)


def test_phase_correlate_single_matches_jax(rng):
    a, b, _ = _rolled_pairs(rng, 1, 120, 90)
    want = jpc.phase_correlate(a[0], b[0])
    got = phasecorr.phase_correlate(torch.from_numpy(a[0]),
                                    torch.from_numpy(b[0]))
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_phase_correlate_batch_groups_agree(rng, monkeypatch):
    """Transforming the tiles in groups (bounded device memory) gives the
    same numbers as one batch."""
    a, b, _ = _rolled_pairs(rng, 5, 64, 40)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    whole = phasecorr.phase_correlate_batch(ta, tb)
    monkeypatch.setattr(phasecorr, "_BATCH_BYTES", 2 * 4 * 64 * 40)
    grouped = phasecorr.phase_correlate_batch(ta, tb)
    for g, w in zip(grouped, whole):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("where", ["corner", "edge_row", "edge_col"])
def test_peak_centroid_clips_at_the_surface_edge(where):
    """A peak within 2 samples of the surface's edge: the 5x5 centroid
    window is clipped like cv::phaseCorrelate's weightedCentroid, in both
    packages."""
    corr = np.full((16, 20), 0.01, np.float32)
    py, px = {"corner": (0, 19), "edge_row": (15, 7),
              "edge_col": (6, 1)}[where]
    corr[py, px] = 1.0
    corr[min(py + 1, 15), px] = 0.5
    corr[py, max(px - 1, 0)] = 0.25
    want = [float(v) for v in jpc._peak_and_centroid(corr, 16, 20)]
    got = [float(v) for v in phasecorr._peak_and_centroid(
        torch.from_numpy(corr)[None])]
    # float32 sums of 25 terms in another order: a few ulp of 7
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_optimal_dft_size_matches_cv_exact():
    got = [phasecorr.get_optimal_dft_size(n) for n in range(0, 2100)]
    want = [cv_exact.get_optimal_dft_size(n) for n in range(0, 2100)]
    assert got == want
    assert phasecorr.get_optimal_dft_size(1228) == 1250
    assert phasecorr.get_optimal_dft_size(16000) == 16000


@pytest.mark.parametrize("n_valid", [12, 5])
def test_polyfit_matches_jax(rng, n_valid):
    cx = np.sort(rng.random(12) * 12288)
    dx = 0.3 + 1e-5 * cx + rng.normal(0, 0.01, 12)
    dy = -0.2 + 3e-5 * cx - 1e-9 * cx**2 + rng.normal(0, 0.01, 12)
    rs = np.where(np.arange(12) < n_valid, 0.9, 0.1)
    want = jpolyfit.fit_shift_models_filtered(cx, dx, dy, rs, 0.4, 1)
    got = polyfit.fit_shift_models_filtered(cx, dx, dy, rs, 0.4, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_polyfit_too_few_valid_raises_like_jax(rng):
    cx = np.arange(8.0)
    rs = np.where(np.arange(8) < 4, 0.9, 0.1)
    for mod in (jpolyfit, polyfit):
        with pytest.raises(RuntimeError, match="4 valid values found"):
            mod.fit_shift_models_filtered(cx, cx, cx, rs, 0.4, 2)

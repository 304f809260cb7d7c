"""Port phase correlation (ops/phasecorr, ops/phasecorr_cuda's plain
cross-power) against the JAX package's fast registration pieces."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu.ops import phasecorr as jpc
from opticalimageprocessor_tpu.ops import resample as jres
from opticalimageprocessor_tpu.ops.phasecorr_pallas import (
    windowed_crosspower_fused_tiles as jax_fused_tiles,
)
from opticalimageprocessor_tpu_torch.ops import phasecorr
from opticalimageprocessor_tpu_torch.ops import phasecorr_cuda as pcc
from opticalimageprocessor_tpu_torch.ops.phasecorr_cuda import (
    windowed_crosspower_fused_tiles,
)

torch.set_num_threads(2)

PAD = (992, 256)      # tests/test_phasecorr.py:101-107
M_SMALL, N_SMALL = 248, 64
WIN = 16


def _tiles(rng, n_tiles=2):
    """PAN tiles = x4 upsampled noise rolled by (+4, -2) px; band b =
    the noise rolled by (b mod 2, b - 1) band px."""
    pans, bands = [], []
    for _ in range(n_tiles):
        base = (rng.random((M_SMALL, N_SMALL)) * 1000).astype(np.float32)
        up = np.asarray(jres.upsample4_f32(jnp.asarray(base)))
        pans.append(np.roll(np.roll(up, 4, axis=0), -2, axis=1))
        bands.append(
            np.stack([np.roll(base, (b % 2, b - 1), (0, 1)) for b in range(4)])
        )
    return np.stack(pans), np.stack(bands)


def test_rfft2_padded_matches_jax(rng):
    x = (rng.random((2, 200, 240)) * 1000).astype(np.float32)
    fr, fi = jpc.rfft2_padded(jnp.asarray(x), PAD, True)
    got = phasecorr.rfft2_padded(torch.from_numpy(x), PAD).numpy()
    scale = np.abs(got).max()
    assert np.abs(got.real - np.asarray(fr)).max() <= 1e-4 * scale
    assert np.abs(got.imag - np.asarray(fi)).max() <= 1e-4 * scale


def _numpy_spectra(pans, bands):
    fpan = np.fft.rfft2(pans.astype(np.float64)).astype(np.complex64)
    fband = np.fft.fft2(bands.astype(np.float64)).astype(np.complex64)
    return fpan, fband


def test_crosspower_plain_matches_jax_fused_kernel(rng):
    """Same numpy spectra into both: the port's plain cross-power vs the
    Pallas kernel in interpret mode.  Both round Cn and the evaluation
    matrices to bfloat16 and sum in float32, so they differ only where an
    ulp of Cn flips a bf16 rounding and in the order of summation: over 5
    seeds at most 2.7e-5 px in dx, 1.1e-5 px in dy and 6.7e-6 in response
    (the float32 plain version read 6.7e-5 / 2.9e-5 / 2.7e-4).  Gate
    1e-4."""
    pans, bands = _tiles(rng)
    fpan, fband = _numpy_spectra(pans, bands)
    want = jax_fused_tiles(
        jnp.asarray(fpan.real), jnp.asarray(fpan.imag),
        jnp.asarray(fband.real), jnp.asarray(fband.imag),
        PAD, M_SMALL, WIN, WIN, True,
    )
    got = windowed_crosspower_fused_tiles(
        torch.from_numpy(fpan), torch.from_numpy(fband), PAD, M_SMALL, WIN,
        WIN,
    )
    for g, w in zip(got, want):
        assert g.shape == (2, 4)
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4


def test_crosspower_plain_matches_jax_unfused(rng):
    """Against the JAX unfused spectral path (upsampled_band_spectrum +
    peak_from_spectra_windowed, float32 throughout): <= 1e-3."""
    pans, bands = _tiles(rng)
    fpan, fband = _numpy_spectra(pans, bands)
    got = windowed_crosspower_fused_tiles(
        torch.from_numpy(fpan), torch.from_numpy(fband), PAD, M_SMALL, WIN,
        WIN,
    )
    for t in range(2):
        far = jnp.asarray(fpan[t].real)
        fai = jnp.asarray(fpan[t].imag)
        for b in range(4):
            fbr, fbi = jpc.upsampled_band_spectrum(jnp.asarray(bands[t, b]))
            want = jpc.peak_from_spectra_windowed(
                far, fai, fbr, fbi, PAD, WIN, WIN
            )
            for k in range(3):
                assert abs(float(got[k][t, b]) - float(want[k])) <= 1e-3, (
                    t, b, k)
    # band b = the base rolled by (b mod 2, b - 1) band px; the PAN sits
    # at (+4, -2) px from the upsampled base, so (cv::phaseCorrelate sign)
    # dx = 2 + 4(b - 1) and dy = -4 + 4(b mod 2)
    for b in range(4):
        assert abs(float(got[0][0, b]) - (2 + 4 * (b - 1))) < 0.1
        assert abs(float(got[1][0, b]) - (-4 + 4 * (b % 2))) < 0.1


def _unpack_rows(packed, keep, wx):
    """The dense (2*Kp, N_PAD) B_re and B_im that the kernel's wgmma
    descriptors read from ``packed``, in the kernel's K order (chunk by
    chunk: KX_CHUNK Cr rows, then KX_CHUNK Ci rows)."""
    chunks, parts, slabs, n_pad, eight = packed.shape
    assert (parts, slabs, n_pad, eight) == (2, 2 * pcc.KX_CHUNK // 8,
                                            pcc.N_PAD, 8)
    # element (q = 8 j + e, n) of chunk c, part p sits at [c, p, j, n, e]
    dense = packed.permute(1, 0, 2, 4, 3).reshape(2, chunks * 2 *
                                                  pcc.KX_CHUNK, pcc.N_PAD)
    return dense[0].to(torch.float32), dense[1].to(torch.float32)


@pytest.mark.parametrize("keep,win", [(129, 16), (615, 64), (40, 3)])
def test_packed_eval_operands_reproduce_the_plain_version(rng, keep, win):
    """The host half of kernel (b)'s layout: the wrapper's packed B (its
    padding, signs and K order), multiplied in float32 by A = [Cr | Ci]
    built chunk by chunk in the kernel's order, gives _crosspower_plain's
    output (same bf16 operands, another order of summation)."""
    M, m, n = 64, 16, 7 if keep == 40 else keep // 2 + 1
    n_pad = (keep - 1) * 2
    fpan = torch.from_numpy((rng.standard_normal((1, M, keep))
                             + 1j * rng.standard_normal((1, M, keep)))
                            .astype(np.complex64))
    fpan[0, 3, 5] = 0          # |C| == 0 divides by 1
    fband = torch.from_numpy((rng.standard_normal((1, 2, m, n))
                              + 1j * rng.standard_normal((1, 2, m, n)))
                             .astype(np.complex64))
    hr = phasecorr.filter_response(m, M // m, torch.device("cpu"))
    hc = phasecorr.filter_response(n, 4, torch.device("cpu"))[:keep]
    if hc.shape[0] < keep:
        hc = torch.cat([hc] * (-(-keep // hc.shape[0])))[:keep]
    ex_c, ex_s = phasecorr.eval_consts(n_pad, keep, win, False,
                                       torch.device("cpu"))
    wx = 2 * win + 1
    want_re, want_im = pcc._crosspower_plain(fpan, fband, hr, hc, ex_c, ex_s)

    packed = pcc.pack_eval_operands(ex_c, ex_s)
    chunks = -(-keep // pcc.KX_CHUNK)
    assert packed.shape == (chunks, 2, 2 * pcc.KX_CHUNK // 8, pcc.N_PAD, 8)
    assert packed.dtype == torch.bfloat16
    b_re, b_im = _unpack_rows(packed, keep, wx)
    kp = chunks * pcc.KX_CHUNK
    for b in range(2):
        cr = torch.zeros((M, kp))
        ci = torch.zeros((M, kp))
        cr[:, :keep], ci[:, :keep] = pcc.whitened_bf16(fpan[0], fband[0, b],
                                                       hr, hc)
        a = torch.cat([cr.reshape(M, chunks, pcc.KX_CHUNK),
                       ci.reshape(M, chunks, pcc.KX_CHUNK)], dim=2)
        a = a.reshape(M, 2 * kp)
        got_re = torch.matmul(a, b_re)
        got_im = torch.matmul(a, b_im)
        scale = float(want_re[0, b].abs().max())
        assert float((got_re[:, :wx] - want_re[0, b]).abs().max()) <= 1e-5 * scale
        assert float((got_im[:, :wx] - want_im[0, b]).abs().max()) <= 1e-5 * scale
        # the padded window columns stay 0
        assert float(got_re[:, wx:].abs().max()) == 0.0
        assert float(got_im[:, wx:].abs().max()) == 0.0


def test_crosspower_plain_rounds_like_the_tpu_kernel(rng):
    """The plain version's GEMM operands are bfloat16 values: replacing
    Ec by its bf16 rounding changes nothing, while the float32 product
    differs (the rounding is really applied)."""
    M, m, n, keep, win = 32, 8, 9, 17, 4
    fpan = torch.from_numpy((rng.standard_normal((1, M, keep))
                             + 1j * rng.standard_normal((1, M, keep)))
                            .astype(np.complex64))
    fband = torch.from_numpy((rng.standard_normal((1, 1, m, n))
                              + 1j * rng.standard_normal((1, 1, m, n)))
                             .astype(np.complex64))
    hr = torch.ones(M, dtype=torch.complex64)
    hc = torch.ones(keep, dtype=torch.complex64)
    ex_c, ex_s = phasecorr.eval_consts(32, keep, win, False,
                                       torch.device("cpu"))
    a = pcc._crosspower_plain(fpan, fband, hr, hc, ex_c, ex_s)
    b = pcc._crosspower_plain(fpan, fband, hr, hc, pcc._bf16(ex_c),
                              pcc._bf16(ex_s))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    ky = torch.arange(M) % m
    kx = torch.arange(keep) % n
    c = phasecorr.whitened_crosspower(fpan[0], fband[0, 0][ky][:, kx])
    f32 = torch.matmul(c.real, ex_c) - torch.matmul(c.imag, ex_s)
    assert float((f32 - a[0][0, 0]).abs().max()) > 1e-4


def test_upsampled_band_spectrum_matches_jax(rng):
    band = (rng.random((M_SMALL, N_SMALL)) * 1000).astype(np.float32)
    fr, fi = jpc.upsampled_band_spectrum(jnp.asarray(band))
    got = phasecorr.upsampled_band_spectrum(torch.from_numpy(band)).numpy()
    assert got.shape == np.asarray(fr).shape
    scale = np.abs(got).max()
    assert np.abs(got.real - np.asarray(fr)).max() <= 1e-4 * scale
    assert np.abs(got.imag - np.asarray(fi)).max() <= 1e-4 * scale


def test_peak_from_spectra_windowed_matches_jax(rng):
    pans, _ = _tiles(rng, 1)
    a = pans[0]
    b = np.roll(np.roll(a, 3, 0), -5, 1)
    fa, fb = (np.fft.rfft2(x.astype(np.float64)).astype(np.complex64)
              for x in (a, b))
    want = jpc.peak_from_spectra_windowed(
        jnp.asarray(fa.real), jnp.asarray(fa.imag), jnp.asarray(fb.real),
        jnp.asarray(fb.imag), PAD, WIN, WIN,
    )
    got = phasecorr.peak_from_spectra_windowed(
        torch.from_numpy(fa), torch.from_numpy(fb), PAD, WIN, WIN
    )
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-3


@pytest.mark.parametrize("peak", [(0, 0), (5, 32), (32, 32), (16, 7)])
def test_centroid_on_window_matches_jax(rng, peak):
    """First-maximum arg-max and the edge-clipped 5x5 centroid, including
    a tie (two equal maxima) and peaks at the window border."""
    corr = rng.random((33, 33)).astype(np.float32) * 0.1
    corr[peak] = 1.0
    corr[32 - peak[0], 32 - peak[1]] = 1.0     # a tie: first one wins
    want = jpc._centroid_on_window(jnp.asarray(corr), 16, 16)
    got = phasecorr._centroid_on_window(torch.from_numpy(corr), 16, 16)
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-5


def test_clamp_win_matches_jax():
    for win, pad in (((64, 64), (16000, 1228)), ((64, 64), (100, 40)),
                     ((8, 8), (15, 16))):
        assert phasecorr.clamp_win(win, pad) == jpc.clamp_win(win, pad)


def test_eval_consts_and_filter_response_match_jax():
    for args in ((1228, 615, 64, False), (16000, 16000, 64, True)):
        for g, w in zip(phasecorr._eval_consts(*args),
                        jpc._eval_consts(*args)):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(phasecorr._upsample_filter_response(307),
                    jpc._upsample_filter_response(307)):
        np.testing.assert_array_equal(g, w)

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


def test_crosspower_plain_matches_jax_fused_kernel_ragged(rng):
    """As above at 3 tiles of 3 bands: the stacked layout's columns of
    pair tile * NB + band hold the right (tile, band) where NB is below
    the kernel's 4 bands an item.  Gate 1e-4."""
    pans, bands = _tiles(rng, 3)
    fpan, fband = _numpy_spectra(pans, bands[:, :3])
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
        assert g.shape == (3, 3)
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4


def _stack(dr, di):
    """``D`` of (T, NB, M, wx) real and imaginary parts, built pair by
    pair as kernel (b)'s wrapper documents it."""
    tiles, n_bands, M, wx = dr.shape
    d = torch.full((2 * M, tiles * n_bands * wx), float("nan"))
    for t in range(tiles):
        for b in range(n_bands):
            cols = pcc.stacked_columns(t * n_bands + b, wx)
            d[:M, cols] = dr[t, b]
            d[M:, cols] = di[t, b]
    return d


@pytest.mark.parametrize("tiles,n_bands,M,win_y,wx", [
    (2, 4, 992, 16, 33), (5, 4, 992, 16, 33), (3, 3, 256, 64, 129),
    (7, 1, 64, 3, 7), (1, 2, 6400, 64, 9)])
def test_contract_rows_stacked_matches_contract_rows(rng, tiles, n_bands, M,
                                                      win_y, wx):
    """The one-GEMM ky contraction over ``D`` equals ``contract_rows``
    pair by pair on the same (dr, di), up to the order of the float32
    sums (K = 2M terms: within 1e-5 of the window's largest magnitude;
    random surfaces read 3e-7 to 6e-7), at T = 2 and at ragged T with NB = 4
    and NB < 4; its (T, NB, 2*win_y+1, wx) result is in pair order."""
    N = 256
    dr = torch.from_numpy(rng.standard_normal((tiles, n_bands, M, wx))
                          .astype(np.float32))
    di = torch.from_numpy(rng.standard_normal((tiles, n_bands, M, wx))
                          .astype(np.float32))
    want = phasecorr.contract_rows(dr, di, M, N, win_y)
    got = pcc.contract_rows_stacked(_stack(dr, di), M, N, win_y, tiles,
                                    n_bands)
    assert got.shape == want.shape == (tiles, n_bands, 2 * win_y + 1, wx)
    assert got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("n_tiles,n_bands", [(2, 4), (3, 3)])
def test_stacked_contraction_meets_the_jax_gates(rng, n_tiles, n_bands):
    """The card's route on the CPU: ``_crosspower_plain``'s ``D`` through
    ``contract_rows_stacked`` (one GEMM, another order of float32 sums
    than the CPU route's ``_contract_rows_plain``) and the centroid, held
    to the gates of the tests above: <= 1e-4 against the Pallas kernel in
    interpret mode, <= 1e-3 against the JAX unfused float32 path."""
    pans, bands = _tiles(rng, n_tiles)
    fpan, fband = _numpy_spectra(pans, bands[:, :n_bands])
    M, N = PAD
    keep = fpan.shape[-1]
    cpu = torch.device("cpu")
    ex_c, ex_s = phasecorr.eval_consts(N, keep, WIN, False, cpu)
    d = pcc._crosspower_plain(
        torch.from_numpy(fpan), torch.from_numpy(fband),
        phasecorr.filter_response(M_SMALL, M // M_SMALL, cpu),
        phasecorr.filter_response(N_SMALL, N // N_SMALL, cpu)[:keep],
        ex_c, ex_s)
    got = phasecorr._centroid_on_window(
        pcc.contract_rows_stacked(d, M, N, WIN, n_tiles, n_bands), WIN, WIN)
    want = jax_fused_tiles(
        jnp.asarray(fpan.real), jnp.asarray(fpan.imag),
        jnp.asarray(fband.real), jnp.asarray(fband.imag),
        PAD, M_SMALL, WIN, WIN, True,
    )
    for g, w in zip(got, want):
        assert g.shape == (n_tiles, n_bands)
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4
    for t in range(n_tiles):
        for b in range(n_bands):
            fbr, fbi = jpc.upsampled_band_spectrum(jnp.asarray(bands[t, b]))
            unfused = jpc.peak_from_spectra_windowed(
                jnp.asarray(fpan[t].real), jnp.asarray(fpan[t].imag), fbr,
                fbi, PAD, WIN, WIN)
            for k in range(3):
                assert abs(float(got[k][t, b]) - float(unfused[k])) <= 1e-3


@pytest.mark.parametrize("M,win", [(16000, 64), (4004, 64), (992, 16),
                                   (256, 64), (64, 3)])
def test_eval_consts_are_even_and_odd_in_the_shift(M, win):
    """Kernel (g) sums each window row pair +-s once: the rows' evaluation
    matrices are even (cos) and odd (sin) in the shift to the bit, and the
    shift 0 weighs every row by exactly 1 and 0."""
    c, s = phasecorr._eval_consts(M, M, win, True)
    np.testing.assert_array_equal(c[:, :win][:, ::-1], c[:, win + 1:])
    np.testing.assert_array_equal(-s[:, :win][:, ::-1], s[:, win + 1:])
    assert (c[:, win] == 1).all() and (s[:, win] == 0).all()


@pytest.mark.parametrize("M", [1, 7, 8, 9, 992, 3200, 3201, 6400, 16000,
                               16001])
def test_ky_slices_cover_each_half_once_in_order(M):
    """Kernel (g)'s slices of a half's M rows run in order, end to end, on
    its 8-row stages, and their count follows M alone (5 at the scene's
    M)."""
    slices = pcc._ky_slices(M)
    assert len(slices) == pcc.ky_gemm_splits(M)
    assert slices[0][0] == 0 and slices[-1][1] == M
    for (a0, a1), (b0, b1) in zip(slices, slices[1:]):
        assert a1 == b0
    assert all(k0 % pcc.KY_STAGE == 0 for k0, _ in slices)
    if M == 16000:
        assert len(slices) == 5


def test_crosspower_plain_stacked_layout(rng):
    """``_crosspower_plain``'s ``D``: (2M, T*NB*wx) float32; the columns
    of pair tile * NB + band are what a call on that (tile, band) alone
    gives, the real part ``Re sum_kx Cn (Ec + i Es)`` in rows 0..M-1 and
    the imaginary part in rows M..2M-1 (checked in float64 from the same
    bf16 operands)."""
    M, m, n, keep, win, tiles, n_bands = 48, 12, 7, 9, 5, 3, 3
    fpan = torch.from_numpy((rng.standard_normal((tiles, M, keep))
                             + 1j * rng.standard_normal((tiles, M, keep)))
                            .astype(np.complex64))
    fband = torch.from_numpy(
        (rng.standard_normal((tiles, n_bands, m, n))
         + 1j * rng.standard_normal((tiles, n_bands, m, n)))
        .astype(np.complex64))
    hr = phasecorr.filter_response(m, M // m, torch.device("cpu"))
    hc = phasecorr.filter_response(n, 4, torch.device("cpu"))[:keep]
    ex_c, ex_s = phasecorr.eval_consts(16, keep, win, False,
                                       torch.device("cpu"))
    wx = 2 * win + 1
    d = pcc._crosspower_plain(fpan, fband, hr, hc, ex_c, ex_s)
    assert d.shape == (2 * M, tiles * n_bands * wx)
    assert d.dtype == torch.float32 and d.is_contiguous()
    ec, es = pcc._bf16(ex_c).double(), pcc._bf16(ex_s).double()
    for t in range(tiles):
        for b in range(n_bands):
            cols = pcc.stacked_columns(t * n_bands + b, wx)
            alone = pcc._crosspower_plain(fpan[t:t + 1], fband[t:t + 1, b:b + 1],
                                          hr, hc, ex_c, ex_s)
            assert torch.equal(d[:, cols], alone)
            cr, ci = (x.double() for x in pcc.whitened_bf16(fpan[t],
                                                            fband[t, b], hr, hc))
            want = torch.cat((cr @ ec - ci @ es, ci @ ec + cr @ es))
            scale = float(want.abs().max())
            assert float((d[:, cols].double() - want).abs().max()) <= 1e-5 * scale


def _unpack_rows(packed):
    """The dense (2*Kp, N_PAD) B that the kernel's wgmma descriptors read
    from ``packed``, in the kernel's K order (k16 step by step), and the kx
    and part (0: Ec, 1: Es) of each K row."""
    steps, halves, n_pad, eight = packed.shape
    assert (halves, n_pad, eight) == (2, pcc.N_PAD, 8)
    # element (k = 8 h + e, w) of step s sits at [s, h, w, e]
    dense = packed.permute(0, 1, 3, 2).reshape(steps * 16, pcc.N_PAD)
    s, h, e = torch.meshgrid(torch.arange(steps), torch.arange(2),
                             torch.arange(8), indexing="ij")
    kx = (pcc.KX_STEP * s + 2 * (e // 2) + h).reshape(-1)
    return dense.to(torch.float32), kx, (e % 2).reshape(-1)


@pytest.mark.parametrize("keep,win", [(129, 16), (615, 64), (40, 3)])
def test_packed_eval_operands_reproduce_the_plain_version(rng, keep, win):
    """The host half of kernel (b)'s layout: the wrapper's packed B (its
    padding, interleaving and K order), multiplied in float32 by A_re =
    [Cr, -Ci] and A_im = [Ci, Cr] built step by step in the kernel's order,
    gives _crosspower_plain's output (same bf16 operands, another order of
    summation)."""
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
    want = pcc._crosspower_plain(fpan, fband, hr, hc, ex_c, ex_s)

    packed = pcc.pack_eval_operands(ex_c, ex_s)
    steps = -(-keep // pcc.KX_STEP)
    assert packed.shape == (steps, 2, pcc.N_PAD, 8)
    assert packed.dtype == torch.bfloat16
    b, kx, es = _unpack_rows(packed)
    kp = steps * pcc.KX_STEP
    # every kx once, the padding's rows of B zero
    assert sorted(kx[es == 0].tolist()) == list(range(kp))
    assert bool((b[kx >= keep] == 0).all())
    for band in range(2):
        cr = torch.zeros((M, kp))
        ci = torch.zeros((M, kp))
        cr[:, :keep], ci[:, :keep] = pcc.whitened_bf16(fpan[0], fband[0, band],
                                                       hr, hc)
        a_re = torch.where(es == 1, -ci[:, kx], cr[:, kx])
        a_im = torch.where(es == 1, cr[:, kx], ci[:, kx])
        got_re = torch.matmul(a_re, b)
        got_im = torch.matmul(a_im, b)
        cols = pcc.stacked_columns(band, wx)
        want_re, want_im = want[:M, cols], want[M:, cols]
        scale = float(want_re.abs().max())
        assert float((got_re[:, :wx] - want_re).abs().max()) <= 1e-5 * scale
        assert float((got_im[:, :wx] - want_im).abs().max()) <= 1e-5 * scale
        # the padded window columns stay 0
        assert float(got_re[:, wx:].abs().max()) == 0.0
        assert float(got_im[:, wx:].abs().max()) == 0.0


@pytest.mark.parametrize("tiles", [1, 2, 5, 50])
@pytest.mark.parametrize("n_bands,M,m", [(4, 16000, 4000), (4, 4004, 1001),
                                         (5, 70, 32), (3, 4 * 250 + 3, 250)])
def test_crosspower_schedule_covers_every_row_once(tiles, n_bands, M, m):
    """Kernel (b)'s persistent schedule: the items that the grid's blocks
    take in turn (block b: items b, b + grid, ...) cover every (tile, band,
    ky) exactly once, also where m is no multiple of the item's band rows,
    M no multiple of m, the repeats no multiple of the item's, and the
    bands no multiple of the item's; an item's rows read its own band
    rows; and a few tiles still give every SM of the card an item."""
    sms = 132
    grid, items, rep_groups, row_blocks = pcc.crosspower_schedule(
        tiles, n_bands, M, m, sms)
    assert grid == min(items, sms)
    if tiles * n_bands * M >= 4 * sms * pcc.ITEM_ROWS * pcc.ITEM_REPS:
        assert grid == sms
    seen = np.zeros((tiles, n_bands, M), dtype=np.int32)
    for b in range(grid):
        for i in range(b, items, grid):
            tile, band0, rows = pcc.crosspower_item(
                i, n_bands, M, m, rep_groups, row_blocks)
            assert len(rows) <= pcc.ITEM_ROWS * pcc.ITEM_REPS
            # at most ITEM_ROWS distinct band rows, each at most ITEM_REPS times
            assert len({ky % m for ky in rows}) <= pcc.ITEM_ROWS
            seen[tile, band0:band0 + pcc.ITEM_BANDS, rows] += 1
    assert (seen == 1).all()


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
    assert torch.equal(a, b)
    ky = torch.arange(M) % m
    kx = torch.arange(keep) % n
    c = phasecorr.whitened_crosspower(fpan[0], fband[0, 0][ky][:, kx])
    f32 = torch.matmul(c.real, ex_c) - torch.matmul(c.imag, ex_s)
    assert float((f32 - a[:M, :2 * win + 1]).abs().max()) > 1e-4


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

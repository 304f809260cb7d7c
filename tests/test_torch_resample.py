"""Port resampling (ops/resample) against the JAX package: the x4
upsample, the band alignment remap (kernel (c)'s plain version, one band
and the 4-band interleaved entry) and the stitch tail (kernel (d)'s plain
version), with pinned coefficients."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu.ops import cv_exact
from opticalimageprocessor_tpu.ops import resample as jres
from opticalimageprocessor_tpu.ops import rrc as jrrc
from opticalimageprocessor_tpu_torch import _build
from opticalimageprocessor_tpu_torch.models import device_pipeline as dp
from opticalimageprocessor_tpu_torch.ops import resample, rrc

torch.set_num_threads(2)


def test_upsample4_matches_oracle_and_jax(rng):
    """Bit-exact to the float32 cv::resize oracle (cv_exact); the JAX
    function on XLA:CPU sits a few ulp off that oracle (its multiply-adds
    contract into FMAs), so against JAX the gate is 4 ulp at the largest
    magnitude."""
    band = rng.integers(2000, 42000, (62, 40)).astype(np.float32)
    got = resample.upsample4_f32(torch.from_numpy(band)).numpy()
    np.testing.assert_array_equal(
        got, cv_exact.resize_cubic_f32_exact(band, 248, 160)
    )
    want = np.asarray(jres.upsample4_f32(jnp.asarray(band)))
    ulp = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got - want).max() <= 4 * ulp


def test_x4_weights_match_jax():
    np.testing.assert_array_equal(resample._X4_W, jres._X4_W)
    assert resample._X4_BASE == jres._X4_BASE
    t = np.linspace(0, 1, 97, dtype=np.float32)
    got = torch.stack(resample._cubic_weights_f32(torch.from_numpy(t)), -1)
    np.testing.assert_array_equal(got.numpy(), cv_exact.interpolate_cubic_f32(t))


_COEFFS = {
    # non-trivial slope + curvature, per-column floor(G) changes
    "interior": ([3.7, -2.1e-4], [-1.9, 6.5e-4, -3.0e-7]),
    # horizontal shift crossing col_halo (16) mid-strip: taps dropped
    "past_col_halo": ([40.0, 5.0e-3], [1.2, 0.0, 0.0]),
    # G beyond row_bound (4): vertical taps dropped
    "past_row_bound": ([-2.5, 0.0], [22.0, 0.0, 0.0]),
}


def _jax_remap(src, cx, cy, pallas):
    kw = dict(chunk_rows=128, row_bound=4, col_block=128, col_halo=16)
    if not pallas:
        return np.asarray(
            jres.remap_band_fast_chunked(jnp.asarray(src), cx, cy, **kw)
        )
    try:
        jres.set_fused_remap_pallas(True, interpret=True)
        return np.asarray(
            jres.remap_band_fast_chunked(jnp.asarray(src), cx, cy, **kw)
        )
    finally:
        jres.set_fused_remap_pallas(False)


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(_COEFFS))
def test_remap_band_matches_jax(rng, case, pallas):
    src = rng.integers(0, 65536, (300, 768), dtype=np.uint16)
    cx = np.asarray(_COEFFS[case][0], np.float32)
    cy = np.asarray(_COEFFS[case][1], np.float32)
    want = _jax_remap(src, cx, cy, pallas)
    got = resample.remap_band_fast_chunked(
        torch.from_numpy(src), cx, cy, row_bound=4, col_block=128,
        col_halo=16,
    ).numpy()
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, (case, d.max())
    assert (d > 0).mean() <= 0.01, (case, (d > 0).mean())


# kernel (c)'s interleaved entry: 4 bands, each its own variant of a case
# (band b shifted by 1.3 b px / 4 in x and b px in G, so the bands' dropped
# taps differ); 300 rows is no multiple of any row tile or JAX chunk
_BLOCKS = {"128_16": (128, 16), "512_32": (512, 32)}


def _band_coeffs(case):
    cx0, cy0 = _COEFFS[case]
    cx = np.array([[cx0[0] + 1.3 * b, cx0[1]] for b in range(4)], np.float32)
    cy = np.array([[cy0[0] + 4.0 * b, cy0[1], cy0[2]] for b in range(4)],
                  np.float32)
    return cx, cy


def _remap_bands_inputs(rng, case):
    src = rng.integers(0, 65536, (4, 300, 1024), dtype=np.uint16)
    return (src, *_band_coeffs(case))


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("blk", sorted(_BLOCKS))
@pytest.mark.parametrize("row_bound", [3, 4, 6])
@pytest.mark.parametrize("case", sorted(_COEFFS))
def test_remap_bands_interleaved_matches_jax(rng, case, row_bound, blk,
                                             pallas):
    """The 4-band interleaved remap's plain version against JAX's
    remap_band_fast_chunked per band, stacked on the last axis (its XLA
    route and its Pallas kernel in interpret mode): within 1 DN on <= 1% of
    pixels, the envelope of test_remap_band_matches_jax."""
    src, cx, cy = _remap_bands_inputs(rng, case)
    block, halo = _BLOCKS[blk]
    kw = dict(chunk_rows=128, row_bound=row_bound, col_block=block,
              col_halo=halo)
    try:
        jres.set_fused_remap_pallas(pallas, interpret=True)
        want = np.stack([np.asarray(jres.remap_band_fast_chunked(
            jnp.asarray(src[b]), cx[b], cy[b], **kw)) for b in range(4)],
            axis=-1)
    finally:
        jres.set_fused_remap_pallas(False)
    got = resample.remap_bands_interleaved(
        torch.from_numpy(src), cx, cy, row_bound=row_bound, col_block=block,
        col_halo=halo).numpy()
    assert got.shape == (300, 1024, 4) and got.dtype == np.uint16
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, (case, d.max())
    assert (d > 0).mean() <= 0.01, (case, (d > 0).mean())


@pytest.mark.parametrize("blk", sorted(_BLOCKS))
@pytest.mark.parametrize("row_bound", [3, 4, 6, 10])
@pytest.mark.parametrize("case", sorted(_COEFFS))
def test_remap_bands_interleaved_equals_per_band_route(rng, case, row_bound,
                                                       blk):
    """Band i of the interleaved raster is remap_band_fast_chunked of band i
    at 0 DN (row_bound 10: the staged route band by band)."""
    src, cx, cy = _remap_bands_inputs(rng, case)
    block, halo = _BLOCKS[blk]
    kw = dict(row_bound=row_bound, col_block=block, col_halo=halo)
    got = resample.remap_bands_interleaved(torch.from_numpy(src), cx, cy,
                                           **kw).numpy()
    for b in range(4):
        want = resample.remap_band_fast_chunked(
            torch.from_numpy(src[b]), cx[b], cy[b], **kw).numpy()
        np.testing.assert_array_equal(got[..., b], want)


@pytest.mark.parametrize(
    "bands,rows,width,block,halo,n_sm,want",
    [
        (4, 8192, 3072, 128, 16, 132, (128, 256)),     # the scene's bands
        (1, 16384, 12288, 512, 32, 132, (512, 256)),   # prestitch PAN2
        (1, 4096, 3072, 512, 32, 132, (512, 64)),      # file align band
        (1, 300, 1024, 128, 16, 132, (512, 64)),
        (1, 300, 1000, 100, 5, 4, (500, 64)),
        (4, 300, 768, 384, 32, 132, (384, 64)),
    ],
)
def test_remap_geometry(bands, rows, width, block, halo, n_sm, want):
    """Kernel (c)'s blocks own whole column blocks and whole threads (4 /
    bands columns each), near 128 threads; row tiles shrink from 256 to 64
    rows while the grid has fewer than 2 blocks an SM; a thread stages at
    most one chunk of 8 source columns a row."""
    seg, tile = resample.remap_geometry(bands, rows, width, block, halo,
                                        n_sm)
    assert (seg, tile) == want
    assert seg % block == 0 and seg % (4 // bands) == 0
    threads = seg // (4 // bands)
    assert threads <= 512
    assert bands * ((seg + 2 * halo + 14) // 8) <= threads


@pytest.mark.parametrize("block,halo", [(1024, 16), (128, 300)])
def test_remap_geometry_refuses_too_many_threads_or_chunks(block, halo):
    with pytest.raises(ValueError, match="threads"):
        resample.remap_geometry(4, 300, 1024, block, halo, 132)


@pytest.mark.parametrize("bad", ["bands2", "bands3", "coeff_shape",
                                 "width", "row_bound7"])
def test_kernel_c_bands_refuses_bad_arguments(bad):
    """The interleaved entry refuses, before it looks at the device, what
    the kernel does not take: 2 or 3 bands, coefficients of another band
    count, a width that is no multiple of 8, row_bound above 6."""
    before = dict(_build.LAUNCHES)
    nb = {"bands2": 2, "bands3": 3}.get(bad, 4)
    src = torch.zeros((nb, 32, 100 if bad == "width" else 128),
                      dtype=torch.uint16)
    cx = torch.zeros((nb, 2) if bad != "coeff_shape" else (nb, 3))
    cy = torch.zeros((nb, 3))
    rb = 7 if bad == "row_bound7" else 3
    with pytest.raises(ValueError, match="got"):
        resample._remap_bands_cuda(src, cx, cy, rb, 128, 16)
    assert _build.LAUNCHES == before


def test_scene_transform_aligned_equals_band_by_band(rng):
    """ScenePipeline.transform on the CPU gives the aligned raster it gave
    before the interleaved entry: the RRC'd bands remapped one by one with
    remap_band_fast_chunked and stacked on the last axis."""
    lines, width = 512, 1024
    pan1 = rng.integers(0, 65536, (lines, width), dtype=np.uint16)
    pan2 = rng.integers(0, 65536, (lines, width), dtype=np.uint16)
    mss = rng.integers(0, 65536, (4, lines // 4, width // 4), dtype=np.uint16)
    params = [(0.98 + 0.04 * rng.random(width), rng.normal(0, 20, width))
              for _ in range(2)]
    mk = 0.98 + 0.04 * rng.random((4, width // 4))
    mb = rng.normal(0, 20, (4, width // 4))
    pipe = dp.ScenePipeline(*params, (mk, mb), fold=100, col_block=128,
                            col_halo=16, row_bound=3)
    cx, cy = (torch.from_numpy(x) for x in _band_coeffs("interior"))
    aligned, _ = pipe.transform(
        *(torch.from_numpy(x) for x in (pan1, pan2, mss)), cx, cy,
        torch.tensor(-1.5), torch.tensor(0.7))
    mss_c = rrc._rrc_plain(torch.from_numpy(mss), torch.from_numpy(mk),
                           torch.from_numpy(mb))
    want = torch.stack([resample.remap_band_fast_chunked(
        mss_c[b], cx[b], cy[b], row_bound=3, col_block=128, col_halo=16)
        for b in range(4)], dim=-1)
    assert aligned.shape == (lines // 4, width // 4, 4)
    np.testing.assert_array_equal(aligned.numpy(), want.numpy())


def test_col_block_size_matches_jax_matrix():
    for width, block in ((768, 128), (640, 128), (100, 512), (96, 64)):
        m = jres._col_interp_matrix(
            jnp.asarray([0.0, 0.0], jnp.float32), width, block, 16
        )
        assert resample.col_block_size(width, block) == m.shape[2]


def _stitch_inputs(rng, rows=300, width=768):
    pan1 = rng.integers(0, 65535, (rows, width), np.uint16)
    pan2 = rng.integers(0, 65535, (rows, width), np.uint16)
    k1, k2 = (0.98 + 0.04 * rng.random(width) for _ in range(2))
    b1, b2 = (rng.normal(0, 20, width) for _ in range(2))
    return pan1, pan2, k1, b1, k2, b2


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("dy", [-6.0, -2.9, 0.0, 2.4, 6.0])
def test_stitch_tail_matches_jax(rng, dy, pallas):
    """Clamp edges (|dy| = prestt_row_bound - 2 = 6) and interior shifts,
    against JAX's default path and its Pallas tail (interpret mode): the
    left half is RRC(PAN1) byte for byte, the right half (and the
    prestitched PAN2) within 1 DN on <= 1% of pixels."""
    pan1, pan2, k1, b1, k2, b2 = _stitch_inputs(rng)
    dx, fold = -3.2 if dy <= 0 else 1.7, 100
    try:
        jres.set_fused_remap_pallas(pallas, interpret=True)
        want, want_p = jres.remap_const_stitch_chunked(
            jnp.asarray(pan1), jnp.asarray(pan2),
            jnp.asarray(jrrc.split_rrc_params(k1, b1)),
            jnp.asarray(jrrc.split_rrc_params(k2, b2)),
            jnp.float32(dx), jnp.float32(dy), fold, chunk_rows=128,
            row_bound=8, col_block=128, col_halo=16, want_prestt=True,
        )
    finally:
        jres.set_fused_remap_pallas(False)
    got, got_p = resample.remap_const_stitch_chunked(
        *(torch.from_numpy(x) for x in (pan1, pan2, k1, b1, k2, b2)),
        dx, dy, fold, row_bound=8, col_block=128, col_halo=16,
        want_prestt=True,
    )
    want, want_p, got, got_p = (
        np.asarray(x).astype(np.int32) for x in (want, want_p, got, got_p)
    )
    left = 768 - fold
    assert got.shape == (300, 2 * left)
    np.testing.assert_array_equal(got[:, :left], want[:, :left])
    np.testing.assert_array_equal(
        got[:, :left], cv_exact.rrc_exact(pan1, k1, b1)[:, :left]
    )
    for g, w in ((got[:, left:], want[:, left:]), (got_p, want_p)):
        d = np.abs(g - w)
        assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), dy)


def test_stitch_tail_rejects_dy_beyond_row_bound(rng):
    pan1, pan2, k1, b1, k2, b2 = _stitch_inputs(rng, rows=64, width=256)
    with pytest.raises(ValueError, match="row bound"):
        resample.remap_const_stitch_chunked(
            *(torch.from_numpy(x) for x in (pan1, pan2, k1, b1, k2, b2)),
            0.0, 6.5, 32, row_bound=8, col_block=128, col_halo=16,
        )


@pytest.mark.parametrize("row_bound,staged", [(6, False), (10, True)])
def test_router_sends_wide_bounds_to_the_staged_remap(rng, monkeypatch,
                                                      row_bound, staged):
    """Like the JAX function, remap_band_fast_chunked takes kernel (c)'s
    route for row_bound <= 6 and the staged remap_band_fast above it."""
    calls = []
    real = resample.remap_band_fast

    def spy(*args, **kwargs):
        calls.append(kwargs.get("chunk_rows"))
        return real(*args, **kwargs)

    monkeypatch.setattr(resample, "remap_band_fast", spy)
    src = torch.from_numpy(rng.integers(0, 65536, (64, 256), np.uint16))
    resample.remap_band_fast_chunked(src, np.zeros(2, np.float32),
                                     np.zeros(3, np.float32), row_bound)
    assert calls == ([resample.STAGED_CHUNK_ROWS] if staged else [])


def test_kernel_c_refuses_row_bound_above_6():
    """_remap_band_cuda refuses row_bound 7 before it looks at the device
    (kernel (c)'s gate, as the TPU kernel's)."""
    with pytest.raises(ValueError, match="row_bound <= 6"):
        resample._remap_band_cuda(
            torch.zeros((32, 128), dtype=torch.uint16), torch.zeros(2),
            torch.zeros(3), 7, 128, 16,
        )


def test_remap_band_row_bound_10_matches_jax(rng):
    """The staged route at row_bound 10 against JAX's chunked remap
    (128-row chunks), with a dy polynomial whose floor(G) runs 7..9 across
    the columns: within 1 DN on < 1% of pixels (XLA:CPU contracts
    multiply-adds, ROADMAP Queue 3)."""
    src = rng.integers(0, 65536, (300, 768), dtype=np.uint16)
    cx = np.asarray([3.7, -2.1e-4], np.float32)
    cy = np.asarray([36.0, 2.0e-3, -1.5e-6], np.float32)
    g = np.asarray(jres._band_g(cy, 768))
    assert set(np.floor(g).astype(int)) == {7, 8, 9}
    want = np.asarray(jres.remap_band_fast_chunked(
        jnp.asarray(src), cx, cy, chunk_rows=128, row_bound=10))
    got = resample.remap_band_fast_chunked(
        torch.from_numpy(src), cx, cy, row_bound=10).numpy()
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("shape", [(62, 40, 250, 161), (64, 48, 40, 30)])
def test_resize_cubic_matches_oracle_and_jax(rng, shape):
    """General-size cv::resize (the registration's upsample when slices
    give no exact x4 tiles): bit-exact to the float32 oracle, within 4 ulp
    of JAX on XLA:CPU (as upsample4_f32)."""
    h, w, dh, dw = shape
    band = rng.integers(2000, 42000, (h, w)).astype(np.float32)
    got = resample.resize_cubic_f32(torch.from_numpy(band), dh, dw).numpy()
    np.testing.assert_array_equal(
        got, cv_exact.resize_cubic_f32_exact(band, dh, dw))
    want = np.asarray(jres.resize_cubic_f32(jnp.asarray(band), dh, dw))
    ulp = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got - want).max() <= 4 * ulp

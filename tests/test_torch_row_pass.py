"""Kernel (e)'s plain version (ops/resample._fast_row_pass_plain) and the
staged remap (remap_band_fast) against the JAX package's vertical pass:
its Pallas kernel in interpret mode and its XLA form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu.ops import resample as jres
from opticalimageprocessor_tpu_torch import _build
from opticalimageprocessor_tpu_torch.ops import resample

torch.set_num_threads(2)


def _g(width, row_bound):
    """A per-column G whose floor runs over several values of the bound's
    range (a curved dy polynomial, as a mounting tilt gives)."""
    x = np.arange(width, dtype=np.float32)
    mid = np.float32(row_bound - 2.5)
    return (mid + 1.7 * np.sin(x / (width / 7.0))).astype(np.float32)


@pytest.mark.parametrize("row_bound", [3, 6, 10, 19, 30])
def test_row_pass_plain_matches_jax(rng, row_bound):
    """The plain version against JAX's Pallas kernel (interpret mode) and
    its XLA form on [0, 1) inputs: atol 1e-5, the bar JAX holds its own
    kernel to (tests/test_resample.py:133-138)."""
    width, rows = 256, 200
    g = _g(width, row_bound)
    cu_j = jres._row_pass_coeffs(jnp.asarray(g), width, row_bound)
    cu = resample._row_pass_coeffs(torch.from_numpy(g), row_bound)
    np.testing.assert_array_equal(cu.numpy(), np.asarray(cu_j))
    U = 2 * row_bound + 4
    padded = rng.random((rows + U - 1, width), dtype=np.float32)
    got = resample._fast_row_pass_plain(torch.from_numpy(padded), cu,
                                        rows).numpy()
    pallas = np.asarray(jres._fast_row_pass_pallas(
        jnp.asarray(padded), cu_j, rows, row_bound, interpret=True))
    xla = np.asarray(jres._fast_row_pass_from_cu(jnp.asarray(padded), cu_j,
                                                 rows))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)


def test_row_pass_plain_is_the_v_ordered_sum(rng):
    """Exactly the sum the kernel computes: from 0, in v order, each
    product and each sum rounded to float32 on its own."""
    rows, width, U = 40, 96, 7
    padded = rng.random((rows + U - 1, width), dtype=np.float32) * 65535
    cu = rng.normal(0, 1, (U, width)).astype(np.float32)
    want = np.zeros((rows, width), np.float32)
    for v in range(U):
        want = (want + (padded[v:v + rows] * cu[v]).astype(np.float32)
                ).astype(np.float32)
    got = resample.fast_row_pass(torch.from_numpy(padded),
                                 torch.from_numpy(cu), rows).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("row_bound", [4, 10])
def test_remap_band_fast_matches_jax_pallas_row_pass(rng, row_bound):
    """The staged remap against JAX's with its Pallas vertical pass
    (interpret mode): within 1 DN on < 1% of pixels (XLA:CPU contracts the
    column matmul's multiply-adds, ROADMAP Queue 3)."""
    src = rng.integers(0, 65536, (300, 512), dtype=np.uint16)
    cx = np.asarray([2.3, -1.1e-4], np.float32)
    cy = np.asarray([4.0 * (row_bound - 2.4), 6.0e-3, -1.2e-5], np.float32)
    try:
        jres.set_row_pass_pallas(True, interpret=True)
        want = np.asarray(jres.remap_band_fast(
            jnp.asarray(src), cx, cy, row_bound, col_block=128, col_halo=16))
    finally:
        jres.set_row_pass_pallas(False)
    got = resample.remap_band_fast(
        torch.from_numpy(src), cx, cy, row_bound, col_block=128, col_halo=16,
    ).numpy()
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("chunk_rows", [1, 37, 128, 299])
def test_remap_band_fast_chunks_equal_whole_strip(rng, chunk_rows):
    """Each chunk's column cubic covers the real rows its vertical taps
    reach, so any chunking is bit-identical to the whole strip, and to
    the whole-strip plain band remap (the plain route the card's smoke run
    holds the staged route to)."""
    src = torch.from_numpy(rng.integers(0, 65536, (300, 384),
                                        dtype=np.uint16))
    cx = np.asarray([-1.4, 3.0e-4], np.float32)
    cy = np.asarray([30.5, -2.0e-3, 1.0e-6], np.float32)
    whole = resample.remap_band_fast(src, cx, cy, 10).numpy()
    got = resample.remap_band_fast(src, cx, cy, 10,
                                   chunk_rows=chunk_rows).numpy()
    np.testing.assert_array_equal(got, whole)
    plain = resample._remap_band_plain(
        src, torch.from_numpy(cx), torch.from_numpy(cy), 10,
        resample.col_block_size(384, None), resample.COL_HALO).numpy()
    np.testing.assert_array_equal(whole, plain)


def test_remap_band_fast_g_override(rng):
    """``g_override`` replaces the G(x) of ``coeff_y`` (the JAX
    signature's hook)."""
    src = torch.from_numpy(rng.integers(0, 65536, (64, 128),
                                        dtype=np.uint16))
    cx = np.asarray([0.7, 0.0], np.float32)
    cy = np.asarray([13.0, 2.0e-3, 0.0], np.float32)
    g = resample._band_g(torch.from_numpy(cy), 128)
    want = resample.remap_band_fast(src, cx, cy, 7).numpy()
    got = resample.remap_band_fast(src, cx, np.zeros(3, np.float32), 7,
                                   g_override=g).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows, width, n_taps, vec_ok, want", [
    # the staged remap's chunk at the camera width, U 24: 2 columns a
    # thread, 256-row tiles, every tap's weights staged at once
    (8192, 12288, 24, True, (2, 256, 24)),
    (8189, 12288, 36, True, (2, 256, 48)),   # no K or tile divides 8189
    (8192, 3072, 64, True, (2, 256, 72)),    # a band's width, U 64
    (8192, 1000, 24, True, (2, 64, 24)),     # 8 column blocks: least tile
    (8192, 1001, 24, True, (1, 128, 24)),    # odd width: 1 column a thread
    (8192, 12288, 24, False, (1, 256, 24)),  # pointers not 8-byte aligned
    (64, 12288, 5000, True, (2, 64, 96)),    # U past 48 KB: chunks of taps
    (1, 1, 1, True, (1, 64, 24)),
])
def test_row_pass_geometry(rows, width, n_taps, vec_ok, want):
    """The launch geometry the kernel's entry accepts: a tile that is a
    multiple of K, 256 rows halved down to 64 while the grid has fewer
    than 4 blocks an SM (132 SMs); a weight chunk of whole ring-length
    unrolled blocks within 48 KB of shared memory."""
    vec, threads, tile, chunk = resample.row_pass_geometry(
        rows, width, n_taps, 132, vec_ok)
    assert (vec, tile, chunk) == want
    assert tile % resample.ROW_PASS_K == 0
    assert threads % 32 == 0 and 32 <= threads <= 256 and width % vec == 0
    assert chunk % resample.ROW_PASS_RING == 0
    assert 4 * chunk * threads * vec <= 48 * 1024
    n_col = -(-width // (threads * vec))
    assert tile == 64 or n_col * -(-rows // tile) >= 4 * 132
    assert tile == 256 or n_col * -(-rows // (2 * tile)) < 4 * 132


def test_row_pass_on_cpu_launches_nothing(rng):
    before = dict(_build.LAUNCHES)
    padded = torch.from_numpy(rng.random((30, 64), dtype=np.float32))
    resample.fast_row_pass(padded, torch.ones((11, 64)), 20)
    assert _build.LAUNCHES == before

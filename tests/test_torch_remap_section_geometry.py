"""Kernel (f)'s launch geometry (ops/resample.remap_section_geometry) and
its quantized row-weight table, on the CPU: every tap of every pixel that
is not 0 lies inside its column block's staged window, the windows fit in
shared memory (a plan that does not fit takes fewer rows a band, never a
refusal), and the table is bit for bit the plain version's weights and the
JAX package's ``cv_exact.interpolate_cubic_f32``."""

import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu.ops import cv_exact
from opticalimageprocessor_tpu_torch.ops import resample

MODES = pytest.mark.parametrize("quantized", [False, True],
                                ids=["continuous", "quantized"])
# chip_smoke.py's fitted-size band polynomial, and a steep one whose G
# spans 46 rows across 3072 px
PARITY_POLY = ((4.3, -2.1e-5), (3.6, 6.5e-5, -3.0e-9))
STEEP_POLY = ((4.3, -2.1e-5), (3.6, 1.5e-2, -3.0e-8))
# G spans ~307 rows across 3072 px: ~26 rows a column block, too many for
# 32 rows a band in the shared-memory budget
SPLIT_POLY = ((0.0, 0.0), (0.0, 1.0e-1, 0.0))
# G jumps by thousands of rows inside a column block: no band fits
DIRECT_POLY = ((0.0, 0.0), (0.0, 0.0, 6.0e-5))


def plan_of(kind, params, width, quantized):
    if kind == "shift":
        return resample.plan_for_constant_shift(*params, width, quantized)
    return resample.plan_for_band_alignment(*params, width, quantized)


def row_offsets(plan, g, y_map):
    """iy - Y of map rows ``y_map`` (n,) in columns of offset ``g`` (k,),
    as the plain version computes them: -> (n, k) int64."""
    v = (y_map.astype(np.float64)[:, None] + g[None, :]).astype(np.float32)
    if plan.quantized:
        s = np.rint(v * np.float32(32.0)).astype(np.int64)
        iy = np.clip(s >> 5, -32768, 32767)
    else:
        iy = np.floor(v).astype(np.int64)
    return iy - y_map[:, None]


def check_windows(plan, rows, first, count, origin, step=2048):
    """Every pixel whose row offset lies in ``plan.row_offsets``: its row
    offset inside its column block's [lo, hi] (so its taps [iy - 1, iy + 2]
    lie in the band's window [y0 + lo - 1, y1 + hi + 2)) and its column
    taps [tap0, tap0 + 3] inside [cw0, cw0 + pitch).  Row offsets depend on
    a column only through g, so they are computed once a distinct g.  ->
    the geometry."""
    geo = resample.remap_section_geometry(plan, rows, first, count, origin)
    width = plan.width
    blk = np.arange(width) // resample.SECTION_COLS
    assert geo.table.shape == (geo.grid[0], 5)
    assert geo.grid[0] == -(-width // resample.SECTION_COLS)
    cw0, pitch, lo, hi = (geo.table[blk, i].astype(np.int64)
                          for i in range(4))
    assert (cw0 % 8 == 0).all() and (pitch % 8 == 0).all()
    tap0 = plan.col_tap0.astype(np.int64)
    assert (tap0 >= cw0).all() and (tap0 + 3 < cw0 + pitch).all()
    r_lo, r_hi = plan.row_offsets[0], plan.row_offsets[-1]
    assert (lo >= r_lo).all() and (hi <= r_hi).all()
    g, inv = np.unique(plan.g, return_inverse=True)
    least = np.full(len(g), np.iinfo(np.int64).max)
    most = np.full(len(g), np.iinfo(np.int64).min)
    for k0 in range(0, count, step):
        y_map = np.arange(first + k0, first + min(count, k0 + step),
                          dtype=np.int64) + origin
        r = row_offsets(plan, g, y_map)
        live = (r >= r_lo) & (r <= r_hi)
        least = np.minimum(least, np.where(live, r, least).min(axis=0))
        most = np.maximum(most, np.where(live, r, most).max(axis=0))
    seen = most >= least
    assert (least[inv] >= lo)[seen[inv]].all()
    assert (most[inv] <= hi)[seen[inv]].all()
    return geo


SHIFTS = [(-3.3, dy) for dy in (0.4, -0.4, 3.4, -9.7)]


@MODES
@pytest.mark.parametrize("shift", SHIFTS,
                         ids=[f"dy{s[1]}" for s in SHIFTS])
def test_windows_hold_taps_constant_shift(shift, quantized):
    check_windows(plan_of("shift", shift, 1000, quantized), 2000, 0, 2000, 0)


@MODES
@pytest.mark.parametrize("poly", [PARITY_POLY, STEEP_POLY],
                         ids=["parity_poly", "steep_poly"])
def test_windows_hold_taps_band_polynomial(poly, quantized):
    plan = plan_of("band", poly, 3072, quantized)
    if poly is STEEP_POLY:
        assert np.ptp(plan.g) >= 40
    geo = check_windows(plan, 2000, 0, 2000, 0)
    assert (geo.table[:, 4] == 32).all() and geo.narrow


@MODES
def test_windows_hold_taps_saturated_section(quantized):
    """The 32800 x 3072 section at (0.4, +1.3): quantized rows past 32767
    saturate, so every block takes the plan's whole range of offsets."""
    plan = plan_of("shift", (0.4, 1.3), 3072, quantized)
    geo = check_windows(plan, 32800, 0, 32800, 0, step=4096)
    if quantized:
        assert (geo.table[:, 2] == plan.row_offsets[0]).all()
        assert (geo.table[:, 3] == plan.row_offsets[-1]).all()


@MODES
@pytest.mark.parametrize("kind,params", [("band", PARITY_POLY),
                                         ("band", STEEP_POLY),
                                         ("shift", (-3.3, 3.4))],
                         ids=["parity_poly", "steep_poly", "shift"])
def test_windows_hold_taps_mesh_call(kind, params, quantized):
    """A line mesh's call: a 5000-row window, first 7, count 4986, origin
    20000."""
    check_windows(plan_of(kind, params, 3072, quantized), 5000, 7, 4986,
                  20000)


@MODES
@pytest.mark.parametrize("width", [1000, 1001, 3071, 3072, 12288])
def test_windows_hold_taps_widths(width, quantized):
    geo = check_windows(plan_of("shift", (-3.3, 3.4), width, quantized), 64,
                        0, 64, 0)
    assert geo.stage16 == (width % 8 == 0)


@MODES
@pytest.mark.parametrize("first,count", [(0, 1), (40, 1), (3, 5), (0, 31)])
def test_windows_hold_taps_short_calls(first, count, quantized):
    """One output row, and fewer rows than a band."""
    plan = plan_of("band", STEEP_POLY, 3072, quantized)
    geo = check_windows(plan, 64, first, count, 11)
    assert geo.grid[1] == 1


@MODES
def test_windows_hold_taps_far_origin(quantized):
    """Map rows past the float bit tricks' range (2^22 continuous, 2^17
    quantized) take the generic coordinates and the plan's whole range."""
    plan = plan_of("band", PARITY_POLY, 1000, quantized)
    origin = (1 << 22) + 5
    geo = check_windows(plan, 300, 0, 300, origin)
    assert not geo.narrow
    assert (geo.table[:, 2] == plan.row_offsets[0]).all()
    near = resample.remap_section_geometry(plan, 300, 0, 300, 1000)
    assert near.narrow


@MODES
@pytest.mark.parametrize("kind,params,rows", [
    ("shift", (-3.3, 3.4), 30000), ("band", PARITY_POLY, 20000),
    ("band", STEEP_POLY, 20000), ("band", SPLIT_POLY, 2000),
    ("band", DIRECT_POLY, 2000)],
    ids=["section", "band_section", "steep", "split", "direct"])
def test_shared_memory_within_budget(kind, params, rows, quantized):
    """Each staged block's two windows fit in SECTION_SMEM bytes (within
    the 227 KB a block can have); a block takes the most rows a band that
    fit, and a block that fits at none reads its taps from device memory
    (band 0): no plan is refused."""
    width = 12288 if kind == "shift" else 3072
    plan = plan_of(kind, params, width, quantized)
    geo = check_windows(plan, rows, 0, rows, 0)
    band = geo.table[:, 4]
    need = 2 * (band + geo.table[:, 3] - geo.table[:, 2] + 3) * 2 * \
        geo.table[:, 1]
    staged = band > 0
    assert (need[staged] <= resample.SECTION_SMEM).all()
    assert geo.smem == (need[staged].max() if staged.any() else 0)
    assert geo.smem <= 227 * 1024   # a block's most on Hopper
    assert set(band) <= {0, *resample.SECTION_BAND_ROWS}
    for b in np.flatnonzero(band < 32):
        # the next larger choice does not fit; for a block that reads
        # device memory, the least
        tried = 2 * band[b] if band[b] else resample.SECTION_BAND_ROWS[-1]
        span = geo.table[b, 3] - geo.table[b, 2]
        assert 2 * (tried + span + 3) * 2 * geo.table[b, 1] > \
            resample.SECTION_SMEM
    if kind == "band" and params is SPLIT_POLY:
        assert 0 < band.min() < 32 and (band > 0).all()
    elif kind == "band" and params is DIRECT_POLY:
        assert (band == 0).any() and (band > 0).any()
    else:
        assert (band == 32).all()


@MODES
def test_wide_offsets_past_2_31_elements(quantized):
    """A section of 2^31 elements or more takes 64-bit element offsets."""
    plan = plan_of("shift", (-3.3, 3.4), 12288, quantized)
    rows = -(-(1 << 31) // 12288)
    assert resample.remap_section_geometry(
        plan, rows, rows - 300, 300, 0).wide_offsets
    assert not resample.remap_section_geometry(
        plan, rows - 1, 0, 300, 0).wide_offsets


def test_chunk_rows_fill_the_card():
    """256 rows a block, halved down to 64 while the grid has fewer than
    8 blocks an SM; the grid's rows capped at 65535 (the kernel strides)."""
    plan = plan_of("shift", (-3.3, 3.4), 12288, False)
    assert resample.remap_section_geometry(plan, 30000, 0, 30000, 0).chunk \
        == 256
    band = plan_of("band", PARITY_POLY, 3072, False)
    assert resample.remap_section_geometry(band, 20000, 0, 20000, 0).chunk \
        == 128
    assert resample.remap_section_geometry(band, 5200, 0, 5200, 0).chunk \
        == 64
    narrow = plan_of("shift", (-3.3, 3.4), 8, False)
    geo = resample.remap_section_geometry(narrow, 20_000_000, 0, 20_000_000,
                                          0)
    assert geo.chunk == 256 and geo.grid == (1, 65535)


def test_quantized_row_weights_bit_equal():
    """The 32-entry table equals _cubic_weights_f32(k / 32), the plain
    version's weights of s & 31 = k, and the JAX package's
    cv_exact.interpolate_cubic_f32, bit for bit."""
    table = resample.quantized_row_weights()
    assert table.shape == (32, 4) and table.dtype == np.float32
    k = torch.arange(32, dtype=torch.int64)
    fy = (k & 31).to(torch.float32) * (1.0 / 32.0)
    plain = torch.stack(resample._cubic_weights_f32(fy), dim=1).numpy()
    jax_w = cv_exact.interpolate_cubic_f32(
        np.arange(32, dtype=np.float32) * np.float32(1.0 / 32.0))
    assert np.array_equal(table.view(np.uint32), plain.view(np.uint32))
    assert np.array_equal(table.view(np.uint32),
                          np.asarray(jax_w, np.float32).view(np.uint32))


def exact_coordinates(g, y_map, quantized):
    """The plain version's (iy - Y, fy key) of map rows ``y_map`` in a
    column of offset ``g``: fy's float bits, quantized ``s & 31``."""
    v = (y_map.astype(np.float64) + g).astype(np.float32)
    if quantized:
        s = np.rint(v * np.float32(32.0)).astype(np.int64)
        return np.clip(s >> 5, -32768, 32767) - y_map, s & 31, v
    fl = np.floor(v)
    return fl.astype(np.int64) - y_map, (v - fl).view(np.int32), v


def kept_rows(v, y_map, quantized):
    """How many rows after each row kernel (f) reuses its coordinates for
    (csrc/remap_section.cu, settle()), in float32 as the kernel computes
    it: the margin to the edge of |v|'s binade, 0 at powers of two, below
    1 and (quantized) where iy saturates."""
    av = np.abs(v)
    bits = av.view(np.int32)
    pw = (bits & 0x7F800000).view(np.float32)
    d = np.where(v > 0, (pw + pw) - av, av - pw).astype(np.float32)
    keep = np.where((av >= 1) & ((bits & 0x7FFFFF) != 0),
                    np.maximum(d.astype(np.int32) - 1, 0), 0)
    if quantized:
        iy = np.rint(v * np.float32(32.0)).astype(np.int64) >> 5
        sat = np.where((iy >= -32768) & (iy <= 32767), 32767 - iy, 0)
        keep = np.minimum(keep, sat)
    return keep


@MODES
def test_reused_coordinates_equal_exact(quantized):
    """Kernel (f) computes a row's coordinates only where they may change:
    for every map row from -40000 to 70000 (across zero, every binade up
    to 2^16 and quantized saturation) and offsets g of either sign, near
    and on integers, the rows it reuses a row's coordinates for have that
    row's row offset and fy exactly."""
    rng = np.random.default_rng(7)
    gs = np.concatenate([[0.0, 3.4, -9.7, 1.3, 0.5, -0.5, 2.0, -3.0,
                          1e-9, -1e-9, 0.999999999, 45.9999999],
                         rng.uniform(-60.0, 60.0, 24)])
    n = 110001
    # exact coordinates past the rows checked, as far as a count can reach
    y_map = np.arange(-40000, 70001 + (1 << 17), dtype=np.int64)
    for g in gs:
        roff, key, v = exact_coordinates(g, y_map, quantized)
        change = np.flatnonzero((np.diff(roff) != 0) | (np.diff(key) != 0))
        # the last row of the run each row belongs to
        ends = np.append(change, len(y_map) - 1)
        run_end = ends[np.searchsorted(ends, np.arange(n))]
        keep = kept_rows(v[:n], y_map[:n], quantized)
        bad = np.arange(n) + keep > run_end
        assert not bad.any(), (g, y_map[:n][bad][:5], keep[bad][:5])
        assert keep.max() > 1000   # the rule does reuse rows

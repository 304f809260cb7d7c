"""Cubic resampling in PyTorch: the fast scene path and the parity remap.

Counterpart of ``opticalimageprocessor_tpu/ops/resample.py``:

* :func:`upsample4_f32` -- the exact x4 ``cv::resize`` INTER_CUBIC float
  path (registration tiles, scene synthesis and tests), and
  :func:`resize_cubic_f32` for any other size;
* :func:`remap_band_fast_chunked` -- the per-band alignment resample,
  ``mapx = (cx1*xx + cx0 + xx)/4``, ``mapy = y + G(x)``,
  ``G = (cy2*xx^2 + cy1*xx + cy0)/4``, xx = 4x: kernel (c) on CUDA for
  ``row_bound <= 6``, else the staged :func:`remap_band_fast` (column
  cubic in PyTorch, then the vertical pass, kernel (e) on CUDA);
  :func:`remap_bands_interleaved` remaps a stack of bands into the
  pixel-interleaved raster, one kernel-(c) launch for all of them;
* :func:`remap_const_stitch_chunked` -- RRC of both PANs, the prestitch
  translation of PAN2 and the seam concat: kernel (d) on CUDA;
* :func:`remap_section_u16` (with :func:`remap_polynomial_u16` and
  :func:`remap_constant_shift_u16`) -- the parity route's ``cv::remap``
  INTER_CUBIC of one section with the reference's section-local maps, in
  either coordinate convention, bit for bit the numpy oracle
  ``cv_exact.remap_cubic_u16_exact`` of the JAX package (apart from its
  rows past int16's saturation, which give 0 as in the JAX package):
  kernel (f) on CUDA, where the JAX package runs XLA, not a TPU kernel;
  :func:`sectionary_plan` and :func:`ibpa_plan` are the reference's two
  section loops (the prestitch's SectionaryRemap with its rolling-buffer
  bottom cut, the alignment's overlapping sections) as lists of calls.

The fast path's column cubic keeps the semantics of the JAX package's
banded column matrix (``_col_interp_matrix``): taps outside the image, or
outside their ``col_block`` block's ``col_halo`` window, are dropped.  All
weight and coordinate arithmetic is float32 in the reference's expression
order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..constants import IBPA_MIN_PROCESSLINES
from .rrc import _rrc_plain

ROW_OFF_BOUND_FAST = 6
COL_BLOCK = 512
COL_HALO = 32


def interpolate_cubic_f32(x: np.ndarray) -> np.ndarray:
    """OpenCV ``interpolateCubic`` (A = -0.75) in float32, reference
    expression order; returns ``x.shape + (4,)``.  Copied from
    ``opticalimageprocessor_tpu/ops/cv_exact.py::interpolate_cubic_f32``
    (importing it would load jax)."""
    x = np.asarray(x, dtype=np.float32)
    A = np.float32(-0.75)
    f1, f5, f8, f4 = (np.float32(v) for v in (1.0, 5.0, 8.0, 4.0))
    f2, f3 = np.float32(2.0), np.float32(3.0)
    xp1 = x + f1
    c0 = ((A * xp1 - f5 * A) * xp1 + f8 * A) * xp1 - f4 * A
    c1 = ((A + f2) * x - (A + f3)) * x * x + f1
    omx = f1 - x
    c2 = ((A + f2) * omx - (A + f3)) * omx * omx + f1
    c3 = f1 - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1)


def _phase_weights_x4() -> np.ndarray:
    """Weights (4 phases, 4 taps) of a x4 cubic upsample: output 4k + r
    samples source (4k + r + 0.5)/4 - 0.5 (from
    ``opticalimageprocessor_tpu/ops/resample.py::_phase_weights_x4``)."""
    fr = np.array([0.625, 0.875, 0.125, 0.375], dtype=np.float32)
    return interpolate_cubic_f32(fr)


_X4_W = _phase_weights_x4()
_X4_BASE = (-2, -2, -1, -1)  # first-tap offset per phase


def _upsample4_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x4 along ``axis`` with replicate-clamped taps, grouped order: every
    tap is a view of one copy of ``x`` with its edges repeated twice, and
    each phase's sum is written into its stride of the output."""
    ax = axis % x.dim()
    n = x.shape[ax]
    edged = x.index_select(ax, torch.clamp(
        torch.arange(-2, n + 2, device=x.device), 0, n - 1))
    phased = list(x.shape)
    phased.insert(ax + 1, 4)                 # output 4k + r at [k, r]
    out = torch.empty(phased, dtype=x.dtype, device=x.device)
    for r in range(4):
        g = [edged.narrow(ax, _X4_BASE[r] + c + 2, n) for c in range(4)]
        w = [float(v) for v in _X4_W[r]]
        torch.add((g[0] * w[0] + g[1] * w[1]) + g[2] * w[2], g[3] * w[3],
                  out=out.select(ax + 1, r))
    shape = list(x.shape)
    shape[ax] = 4 * n
    return out.reshape(shape)


def upsample4_f32(x: torch.Tensor) -> torch.Tensor:
    """``cv::resize(src, 4x, INTER_CUBIC)`` float32 path: horizontal pass
    then vertical, on (..., H, W) -> (..., 4H, 4W)."""
    x = x.to(torch.float32)
    x = _upsample4_axis(x, x.dim() - 1)
    return _upsample4_axis(x, x.dim() - 2)


def _resize_axis(x: torch.Tensor, axis: int, dn: int) -> torch.Tensor:
    """``cv::resize`` INTER_CUBIC along one axis to ``dn`` samples: taps
    and weights computed on the host (float64 coordinates, float32
    weights), replicate-clamped, grouped accumulation order."""
    sn = x.shape[axis]
    fxx = (np.arange(dn, dtype=np.float64) + 0.5) * (sn / dn) - 0.5
    sx = np.floor(fxx).astype(np.int64)
    w = interpolate_cubic_f32((fxx - sx).astype(np.float32))     # (dn, 4)
    taps = np.clip(sx[:, None] + np.arange(-1, 3)[None, :], 0, sn - 1)
    shape = [1] * x.dim()
    shape[axis % x.dim()] = dn

    def term(j):
        idx = torch.from_numpy(taps[:, j]).to(x.device)
        wj = torch.from_numpy(np.ascontiguousarray(w[:, j])).to(x.device)
        return x.index_select(axis, idx) * wj.reshape(shape)

    return ((term(0) + term(1)) + term(2)) + term(3)


def resize_cubic_f32(x: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """``cv::resize(src, (dst_w, dst_h), INTER_CUBIC)`` float32 path on
    (..., H, W), horizontal then vertical (counterpart of the JAX
    package's ``resize_cubic_f32``)."""
    x = x.to(torch.float32)
    x = _resize_axis(x, x.dim() - 1, dst_w)
    return _resize_axis(x, x.dim() - 2, dst_h)


def _cubic_weights_f32(t: torch.Tensor):
    """float32 cubic weights, reference expression order (one op at a
    time: PyTorch never fuses them into FMAs)."""
    A = -0.75
    tp1 = t + 1.0
    w0 = ((A * tp1 - 5.0 * A) * tp1 + 8.0 * A) * tp1 - 4.0 * A
    w1 = ((A + 2.0) * t - (A + 3.0)) * t * t + 1.0
    omt = 1.0 - t
    w2 = ((A + 2.0) * omt - (A + 3.0)) * omt * omt + 1.0
    w3 = 1.0 - w0 - w1 - w2
    return w0, w1, w2, w3


def col_block_size(width: int, block: int | None) -> int:
    """The column block of the banded column matrix: ``block`` capped at
    the width, or the width's largest divisor below it."""
    block = min(block or COL_BLOCK, width)
    return next(b for b in range(block, 0, -1) if width % b == 0)


def _col_taps(coeff_x: torch.Tensor, width: int, block: int, halo: int):
    """Column taps of every output column: (first tap (W,) int64, weights
    (4, W) float32) with the weight of every dropped tap zeroed -- taps
    outside the image, and taps outside the block window
    ``[start - halo, start + block + halo)`` (the construction of
    ``_col_interp_matrix``)."""
    f32 = torch.float32
    dev = coeff_x.device
    x = torch.arange(width, dtype=f32, device=dev)
    xx = x * 4.0
    mapx = (coeff_x[1] * xx + coeff_x[0] + xx) / 4.0
    fl = torch.floor(mapx)
    w = torch.stack(_cubic_weights_f32(mapx - fl))
    tap0 = fl.to(torch.int64) - 1
    blk_start = (torch.arange(width, device=dev) // block) * block
    loc0 = tap0 - (blk_start - halo)
    b = torch.arange(4, device=dev)[:, None]
    ok = (
        (tap0 + b >= 0) & (tap0 + b < width)
        & (loc0 + b >= 0) & (loc0 + b < block + 2 * halo)
    )
    return tap0, torch.where(ok, w, torch.zeros_like(w))


def _col_interp(src_f32: torch.Tensor, tap0, w) -> torch.Tensor:
    """Column cubic ``sum_b w[b] * src[:, tap0 + b]`` in tap order."""
    width = src_f32.shape[-1]
    acc = torch.zeros_like(src_f32)
    for b in range(4):
        idx = torch.clamp(tap0 + b, 0, width - 1)
        acc = acc + src_f32[..., idx] * w[b]
    return acc


def _band_g(coeff_y: torch.Tensor, width: int) -> torch.Tensor:
    """Per-column vertical offset G(x) from the fitted dy polynomial."""
    x = torch.arange(width, dtype=torch.float32, device=coeff_y.device)
    xx = x * 4.0
    return (coeff_y[2] * xx * xx + coeff_y[1] * xx + coeff_y[0]) / 4.0


def _row_pass_coeffs(g: torch.Tensor, row_bound: int):
    """Per-column vertical weights as one (U, W) stack, U = 2*rb + 4:
    ``cu[v, x] = sum_a wys[a, x] * [floor(G[x]) + a - 1 == v - rb - 1]``
    (taps beyond the bound get no row, i.e. are dropped)."""
    fl = torch.floor(g)
    iy0 = fl.to(torch.int64)
    wys = _cubic_weights_f32(g - fl)
    rows = []
    for u in range(-row_bound - 1, row_bound + 3):
        cu = torch.zeros_like(g)
        for a in range(4):
            cu = cu + torch.where(iy0 + a - 1 == u, wys[a],
                                  torch.zeros_like(g))
        rows.append(cu)
    return torch.stack(rows)


def _round_u16(acc: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(acc), 0.0, 65535.0).to(torch.int32).to(
        torch.uint16)


def _remap_band_plain(src, coeff_x, coeff_y, row_bound, block, halo):
    """Plain PyTorch band remap: column cubic, then the U per-column
    vertical multiply-adds over the zero-bordered strip."""
    rows, width = src.shape
    tap0, w = _col_taps(coeff_x, width, block, halo)
    colg = _col_interp(src.to(torch.float32), tap0, w)
    cu = _row_pass_coeffs(_band_g(coeff_y, width), row_bound)
    padded = F.pad(colg, (0, 0, row_bound + 1, row_bound + 2))
    return _round_u16(_fast_row_pass_plain(padded, cu, rows))


def _remap_bands_plain(src, coeff_x, coeff_y, row_bound, block, halo):
    """Plain PyTorch remap of a (bands, rows, W) stack into the interleaved
    (rows, W, bands) raster: :func:`_remap_band_plain` per band, stacked on
    the last axis."""
    return torch.stack(
        [_remap_band_plain(src[i], coeff_x[i], coeff_y[i], row_bound, block,
                           halo) for i in range(src.shape[0])], dim=-1)


REMAP_BANDS = (1, 4)       # band counts kernel (c) interleaves
_REMAP_PAIRS = 4           # (column, band) outputs a kernel-(c) thread owns
_REMAP_THREADS = 128       # target threads a block
_REMAP_MAX_THREADS = 512
_REMAP_TILE_ROWS = (256, 64)   # rows a block: preferred, least


def remap_geometry(bands: int, rows: int, width: int, block: int, halo: int,
                   n_sm: int) -> tuple[int, int]:
    """Kernel (c)'s launch geometry: ``(seg, tile)``, the output columns
    and rows a block owns.  ``seg`` is a whole number of column blocks (so
    every tap that is not dropped lies within ``col_halo`` of the segment)
    and of a thread's 4 / ``bands`` columns, near 128 threads a block, and
    wide enough that each thread stages at most one 16-byte chunk of a
    source row's ``seg + 2 * halo`` columns (rounded out to whole chunks);
    ``tile`` is 256 rows, halved down to 64 while the grid has fewer than 2
    blocks an SM."""
    cols = _REMAP_PAIRS // bands
    unit = math.lcm(block, cols)
    seg = unit * max(1, _REMAP_THREADS * cols // unit)
    while bands * 8 * ((seg + 2 * halo + 14) // 8) > 8 * (seg // cols):
        seg += unit
    if seg // cols > _REMAP_MAX_THREADS:
        raise ValueError(
            f"kernel (c): col_block {block} / col_halo {halo} need "
            f"{seg // cols} threads a block for {bands} band(s), more than "
            f"{_REMAP_MAX_THREADS}")
    n_seg = -(-width // seg)
    tile, least = _REMAP_TILE_ROWS
    while tile > least and n_seg * -(-rows // tile) < 2 * n_sm:
        tile //= 2
    return seg, tile


def _remap_bands_cuda(src, coeff_x, coeff_y, row_bound, block, halo):
    """Kernel (c) on a (bands, rows, W) uint16 stack with (bands, 2) /
    (bands, 3) float32 coefficients: one launch writes the (rows, W, bands)
    raster."""
    name = "remap_band_fast_chunked"
    if row_bound > ROW_OFF_BOUND_FAST:
        # the gate of the TPU kernel (c): its window covers 2*rb + 4 <= 16
        # tap rows
        raise ValueError(
            f"{name}: kernel (c) takes row_bound <= {ROW_OFF_BOUND_FAST}, "
            f"got {row_bound} (the staged remap_band_fast takes larger "
            "bounds)"
        )
    if src.dim() != 3 or src.shape[0] not in REMAP_BANDS or \
            src.shape[2] % 8 or coeff_x.shape != (src.shape[0], 2) or \
            coeff_y.shape != (src.shape[0], 3):
        # the kernel stages 8 columns (16 bytes) a copy
        raise ValueError(
            f"{name}: src must be (bands, rows, W) with bands in "
            f"{REMAP_BANDS} and W % 8 == 0, coeff_x (bands, 2) and coeff_y "
            f"(bands, 3); got {tuple(src.shape)}, {tuple(coeff_x.shape)}, "
            f"{tuple(coeff_y.shape)}"
        )
    _build.require_cuda(name, src, coeff_x, coeff_y)
    if src.dtype != torch.uint16:
        raise ValueError(f"{name}: src must be uint16")
    if coeff_x.dtype != torch.float32 or coeff_y.dtype != torch.float32:
        raise ValueError(f"{name}: coefficients must be float32")
    src = src.contiguous()
    bands, rows, width = src.shape
    out = torch.empty((rows, width, bands), dtype=torch.uint16,
                      device=src.device)
    n_sm = torch.cuda.get_device_properties(src.device).multi_processor_count
    seg, tile = remap_geometry(bands, rows, width, block, halo, n_sm)
    _build.launch(
        "remap_band", "oip_remap_bands", src.data_ptr(), out.data_ptr(),
        bands, rows, width, block, halo, row_bound,
        coeff_x.contiguous().data_ptr(), coeff_y.contiguous().data_ptr(),
        seg, tile, _build.stream_of(src), device=src.device,
    )
    return out


def _remap_band_cuda(src, coeff_x, coeff_y, row_bound, block, halo):
    """Kernel (c) on one (rows, W) band: the band count 1."""
    if src.dim() != 2 or coeff_x.shape != (2,) or coeff_y.shape != (3,):
        raise ValueError(
            "remap_band_fast_chunked: src must be 2-D, coeff_x (2,) and "
            f"coeff_y (3,); got {tuple(src.shape)}, "
            f"{tuple(coeff_x.shape)}, {tuple(coeff_y.shape)}"
        )
    return _remap_bands_cuda(src[None], coeff_x[None], coeff_y[None],
                             row_bound, block, halo)[..., 0]


def _fast_row_pass_plain(padded: torch.Tensor, cu: torch.Tensor,
                         rows: int) -> torch.Tensor:
    """Plain PyTorch vertical pass: ``out[y, x] = sum_v cu[v, x] *
    padded[y + v, x]`` from 0, in v order, each product and sum rounded
    on its own (never a fused multiply-add)."""
    acc = torch.zeros((rows, padded.shape[1]), dtype=torch.float32,
                      device=padded.device)
    for v in range(cu.shape[0]):
        acc = acc + padded[v:v + rows] * cu[v]
    return acc


# kernel (e)'s K output rows a thread and R-slot input ring (csrc/row_pass.cu)
ROW_PASS_K, ROW_PASS_RING = 16, 24
_ROW_PASS_THREADS = 64     # threads a block
_ROW_PASS_TILE_ROWS = (256, 64)   # rows a block: preferred, least
_ROW_PASS_SMEM = 48 * 1024        # bytes of weights a block stages


def row_pass_geometry(rows: int, width: int, n_taps: int, n_sm: int,
                      vec_ok: bool = True) -> tuple[int, int, int, int]:
    """Kernel (e)'s launch geometry: ``(vec, threads, tile, chunk)``.  A
    thread owns ``vec`` adjacent columns (2 where the width is even and
    ``vec_ok`` says the pointers are 8-byte aligned, else 1); a block owns
    ``threads * vec`` columns and a ``tile`` of rows (a multiple of K): 256
    rows, halved down to 64 while the grid has fewer than 4 blocks an SM.
    It stages the weights of ``chunk`` taps in shared memory at once: all of
    them, rounded up to whole R-tap unrolled blocks, where they fit in 48
    KB, else as many whole blocks as fit."""
    vec = 2 if vec_ok and width % 2 == 0 else 1
    cols = _ROW_PASS_THREADS * vec
    n_col = -(-width // cols)
    tile, least = _ROW_PASS_TILE_ROWS
    while tile > least and n_col * -(-rows // tile) < 4 * n_sm:
        tile //= 2
    ring = ROW_PASS_RING
    chunk = min(-(-n_taps // ring), _ROW_PASS_SMEM // (4 * cols * ring))
    return vec, _ROW_PASS_THREADS, tile, ring * chunk


def _fast_row_pass_cuda(padded: torch.Tensor, cu: torch.Tensor,
                        rows: int) -> torch.Tensor:
    if padded.dim() != 2 or cu.dim() != 2 or cu.shape[1] != padded.shape[1] \
            or padded.shape[0] != rows + cu.shape[0] - 1:
        raise ValueError(
            "fast_row_pass: padded must be (rows + U - 1, W) and cu (U, W); "
            f"got {tuple(padded.shape)}, {tuple(cu.shape)}, rows {rows}"
        )
    _build.require_cuda("fast_row_pass", padded, cu)
    if padded.dtype != torch.float32 or cu.dtype != torch.float32:
        raise ValueError("fast_row_pass: padded and cu must be float32")
    padded, cu = padded.contiguous(), cu.contiguous()
    width = padded.shape[1]
    out = torch.empty((rows, width), dtype=torch.float32,
                      device=padded.device)
    n_sm = torch.cuda.get_device_properties(
        padded.device).multi_processor_count
    vec_ok = all(t.data_ptr() % 8 == 0 for t in (padded, cu, out))
    geometry = row_pass_geometry(rows, width, cu.shape[0], n_sm, vec_ok)
    _build.launch(
        "row_pass", "oip_row_pass", padded.data_ptr(), cu.data_ptr(),
        out.data_ptr(), rows, width, cu.shape[0], *geometry,
        _build.stream_of(padded), device=padded.device,
    )
    return out


def fast_row_pass(padded: torch.Tensor, cu: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """The staged remap's vertical pass (the contract of the JAX package's
    ``_fast_row_pass_pallas``): ``padded`` (rows + U - 1, W) float32,
    ``cu`` (U, W) float32 from :func:`_row_pass_coeffs`; returns (rows, W)
    float32.  Kernel (e) on CUDA tensors, the plain version on CPU ones."""
    if padded.device.type == "cpu":
        return _fast_row_pass_plain(padded, cu, rows)
    return _fast_row_pass_cuda(padded, cu, rows)


def remap_band_fast(
    src: torch.Tensor,
    coeff_x,
    coeff_y,
    row_bound: int = ROW_OFF_BOUND_FAST,
    g_override: torch.Tensor | None = None,
    col_block: int | None = None,
    col_halo: int | None = None,
    chunk_rows: int | None = None,
) -> torch.Tensor:
    """Staged fast remap of a (rows, W) uint16 band: the column cubic
    (plain PyTorch), the per-column vertical weights (U = 2*row_bound + 4
    rows, taps beyond the bound dropped), the vertical pass
    (:func:`fast_row_pass`), then rint/clip to uint16.  Rows outside the
    strip read 0.  ``g_override`` replaces the per-column G(x) of
    ``coeff_y``.

    ``chunk_rows`` bounds the float32 working set: each chunk's column
    cubic covers its rows plus the row_bound + 1 real rows above and
    row_bound + 2 below that its vertical taps reach, so any chunking gives
    the same result as the whole strip."""
    rows, width = src.shape
    block = col_block_size(width, col_block)
    halo = COL_HALO if col_halo is None else col_halo
    cx = torch.as_tensor(coeff_x, dtype=torch.float32, device=src.device)
    tap0, w = _col_taps(cx, width, block, halo)
    if g_override is None:
        cy = torch.as_tensor(coeff_y, dtype=torch.float32, device=src.device)
        g_override = _band_g(cy, width)
    cu = _row_pass_coeffs(g_override, row_bound)
    chunk = chunk_rows or max(rows, 1)
    out = torch.empty_like(src)
    for a in range(0, rows, chunk):
        b = min(a + chunk, rows)
        lo, hi = a - row_bound - 1, b + row_bound + 2
        colg = _col_interp(src[max(lo, 0):min(hi, rows)].to(torch.float32),
                           tap0, w)
        padded = F.pad(colg, (0, 0, max(0, -lo), max(0, hi - rows)))
        out[a:b] = _round_u16(fast_row_pass(padded, cu, b - a))
    return out


STAGED_CHUNK_ROWS = 8192   # rows per staged-remap chunk (the JAX prestitch's)


def remap_band_fast_chunked(
    src: torch.Tensor,
    coeff_x,
    coeff_y,
    row_bound: int = ROW_OFF_BOUND_FAST,
    col_block: int | None = None,
    col_halo: int | None = None,
) -> torch.Tensor:
    """Band alignment remap of a (rows, W) uint16 band by the fitted
    polynomials ``coeff_x`` (2,) and ``coeff_y`` (3,) (float32).

    ``row_bound`` bounds |G| (vertical taps beyond it are dropped),
    ``col_block``/``col_halo`` shape the column taps' windows (shifts
    beyond the halo are dropped).  Like the JAX function, ``row_bound <=
    6`` takes the fused kernel (c), one launch over the band, and larger
    bounds the staged :func:`remap_band_fast` in
    :data:`STAGED_CHUNK_ROWS`-row chunks."""
    if row_bound > ROW_OFF_BOUND_FAST:
        return remap_band_fast(src, coeff_x, coeff_y, row_bound,
                               col_block=col_block, col_halo=col_halo,
                               chunk_rows=STAGED_CHUNK_ROWS)
    width = src.shape[-1]
    block = col_block_size(width, col_block)
    halo = COL_HALO if col_halo is None else col_halo
    cx = torch.as_tensor(coeff_x, dtype=torch.float32, device=src.device)
    cy = torch.as_tensor(coeff_y, dtype=torch.float32, device=src.device)
    if src.device.type == "cpu":
        return _remap_band_plain(src, cx, cy, row_bound, block, halo)
    return _remap_band_cuda(src, cx, cy, row_bound, block, halo)


def remap_bands_interleaved(
    src: torch.Tensor,
    coeff_x,
    coeff_y,
    row_bound: int = ROW_OFF_BOUND_FAST,
    col_block: int | None = None,
    col_halo: int | None = None,
) -> torch.Tensor:
    """Alignment remap of a (bands, rows, W) uint16 stack by per-band
    polynomials ``coeff_x`` (bands, 2) and ``coeff_y`` (bands, 3) into the
    pixel-interleaved (rows, W, bands) raster: band i of the result is
    :func:`remap_band_fast_chunked` of ``src[i]``.  For ``row_bound <= 6``
    one kernel-(c) launch covers every band (1 or 4 of them) on CUDA;
    larger bounds take the staged route band by band."""
    if row_bound > ROW_OFF_BOUND_FAST:
        return torch.stack(
            [remap_band_fast_chunked(src[i], coeff_x[i], coeff_y[i],
                                     row_bound, col_block, col_halo)
             for i in range(src.shape[0])], dim=-1)
    width = src.shape[-1]
    block = col_block_size(width, col_block)
    halo = COL_HALO if col_halo is None else col_halo
    cx = torch.as_tensor(coeff_x, dtype=torch.float32, device=src.device)
    cy = torch.as_tensor(coeff_y, dtype=torch.float32, device=src.device)
    if src.device.type == "cpu":
        return _remap_bands_plain(src, cx, cy, row_bound, block, halo)
    return _remap_bands_cuda(src, cx, cy, row_bound, block, halo)


def _stitch_tail_plain(pan1, pan2, k1, b1, k2, b2, dx, dy, fold, block, halo,
                       want_prestt):
    """Plain PyTorch stitch tail: RRC(PAN1) left half ++ the prestitch
    translation of RRC(PAN2) right half."""
    rows, width = pan1.shape
    f32 = torch.float32
    p1c = _rrc_plain(pan1, k1, b1)
    p2c = _rrc_plain(pan2, k2, b2).to(f32)
    dx_t = torch.tensor(dx, dtype=f32, device=pan1.device)
    dy_t = torch.tensor(dy, dtype=f32, device=pan1.device)
    tap0, w = _col_taps(torch.stack([4.0 * dx_t, torch.zeros_like(dx_t)]),
                        width, block, halo)
    colg = _col_interp(p2c, tap0, w)
    fl = torch.floor(dy_t)
    iy0 = int(fl)
    wys = _cubic_weights_f32(dy_t - fl)
    # strip rows outside [0, rows) read 0 after the RRC
    pad = abs(iy0) + 2
    padded = F.pad(colg, (0, 0, pad, pad))
    acc = torch.zeros_like(colg)
    for a in range(4):
        s = pad + iy0 + a - 1
        acc = acc + padded[s:s + rows] * wys[a]
    prestt = _round_u16(acc)
    stitched = torch.empty((rows, 2 * (width - fold)), dtype=torch.uint16,
                           device=pan1.device)
    stitched[:, :width - fold].copy_(p1c[:, :width - fold])
    stitched[:, width - fold:].copy_(prestt[:, fold:])
    return (stitched, prestt) if want_prestt else stitched


def _stitch_tail_cuda(pan1, pan2, k1, b1, k2, b2, dx, dy, fold, block, halo,
                      want_prestt):
    if pan1.dim() != 2 or pan2.shape != pan1.shape or any(
        t.shape != pan1.shape[1:] for t in (k1, b1, k2, b2)
    ):
        raise ValueError(
            "remap_const_stitch_chunked: PANs must be one (rows, W) shape "
            f"and k, b (W,); got {tuple(pan1.shape)}, {tuple(pan2.shape)}, "
            f"{[tuple(t.shape) for t in (k1, b1, k2, b2)]}"
        )
    _build.require_cuda("remap_const_stitch_chunked", pan1, pan2, k1, b1,
                        k2, b2)
    if pan1.dtype != torch.uint16 or pan2.dtype != torch.uint16:
        raise ValueError("remap_const_stitch_chunked: PANs must be uint16")
    if pan1.shape[1] % 8 or not abs(dx) < 120.0:
        # the kernel moves 8 columns a thread and stages dx's column reach
        raise ValueError(
            "remap_const_stitch_chunked: kernel (d) takes widths that are "
            f"multiples of 8 and |dx| < 120; got {pan1.shape[1]}, {dx}")
    if any(t.dtype != torch.float64 for t in (k1, b1, k2, b2)):
        raise ValueError("remap_const_stitch_chunked: k, b must be float64")
    pan1, pan2 = pan1.contiguous(), pan2.contiguous()
    if pan1.data_ptr() % 16 or pan2.data_ptr() % 16:
        # the kernel copies and loads the PANs 16 bytes at a time
        raise ValueError("remap_const_stitch_chunked: kernel (d) takes PANs "
                         "that start on a 16-byte boundary")
    rows, width = pan1.shape
    dev = pan1.device
    stitched = torch.empty((rows, 2 * (width - fold)), dtype=torch.uint16,
                           device=dev)
    prestt = (torch.empty_like(pan2) if want_prestt else None)
    _build.launch(
        "stitch_tail", "oip_stitch_tail", pan1.data_ptr(), pan2.data_ptr(),
        k1.contiguous().data_ptr(), b1.contiguous().data_ptr(),
        k2.contiguous().data_ptr(), b2.contiguous().data_ptr(),
        stitched.data_ptr(), prestt.data_ptr() if want_prestt else None,
        rows, width, fold, block, halo, dx, dy, _build.stream_of(pan1),
        device=dev,
    )
    return (stitched, prestt) if want_prestt else stitched


def remap_const_stitch_chunked(
    pan1: torch.Tensor,
    pan2: torch.Tensor,
    pan1_k: torch.Tensor,
    pan1_b: torch.Tensor,
    pan2_k: torch.Tensor,
    pan2_b: torch.Tensor,
    dx: float,
    dy: float,
    fold: int,
    row_bound: int = ROW_OFF_BOUND_FAST,
    col_block: int | None = None,
    col_halo: int | None = None,
    want_prestt: bool = False,
):
    """Fused RRC + constant-shift prestitch remap + seam concat.

    ``pan1``/``pan2``: (rows, W) uint16 RAW strips; ``pan*_k``/``pan*_b``:
    (W,) float64 RRC parameters; ``dx``/``dy``: the translation, with
    |dy| <= row_bound - 2 (the JAX package's halo contract).  Returns the
    stitched (rows, 2*(W - fold)) uint16 raster; with ``want_prestt`` also
    the prestitched PAN2 (rows, W)."""
    dx = float(np.float32(dx))
    dy = float(np.float32(dy))
    if abs(dy) > row_bound - 2:
        raise ValueError(
            f"|dy| = {abs(dy)} beyond the supported row bound "
            f"{row_bound} - 2"
        )
    width = pan1.shape[1]
    if not 0 <= fold < width:
        raise ValueError(f"fold {fold} outside [0, {width})")
    block = col_block_size(width, col_block)
    halo = COL_HALO if col_halo is None else col_halo
    args = (pan1, pan2, pan1_k, pan1_b, pan2_k, pan2_b, dx, dy, fold, block,
            halo, want_prestt)
    if pan1.device.type == "cpu":
        return _stitch_tail_plain(*args)
    return _stitch_tail_cuda(*args)



# ---------------------------------------------------------------------------
# The parity remap: cv::remap INTER_CUBIC / BORDER_CONSTANT(0) on uint16
# with float32 maps, mapx per column and mapy(y, x) = float32(y + g[x])
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RemapPlan:
    """Per-column map data of a remap, built on the host in float64 as the
    reference builds its maps (preproc.h:443-450, stitcher.h:93-99).

    The JAX package's ``RemapPlan`` with ``g`` kept in float64 in place of
    its float32 ``g_hi``/``g_lo`` pair (the TPU has no float64)."""

    width: int
    col_tap0: np.ndarray          # (W,) int32 first column tap (may be < 0)
    wx: np.ndarray                # (4, W) float32 column weights
    g: np.ndarray                 # (W,) float64: mapy(y, x) = f32(y + g[x])
    col_shifts: tuple[int, ...]   # range of col_tap0[x] - x
    row_offsets: tuple[int, ...]  # range of floor(mapy(y, x)) - y
    quantized: bool
    # kernel (f)'s device copies of the plan (by device) and launch
    # geometries (by call), made at first use
    cuda_cache: dict = field(default_factory=dict, compare=False,
                             repr=False)

    @property
    def halo_top(self) -> int:
        """Rows above an output row that its taps may read."""
        return max(0, -(self.row_offsets[0] - 1))

    @property
    def halo_bottom(self) -> int:
        """Rows below an output row that its taps may read."""
        return max(0, self.row_offsets[-1] + 2)


def build_remap_plan(mapx_cols: np.ndarray, g: np.ndarray,
                     quantized_coords: bool = False) -> RemapPlan:
    """A plan from ``mapx_cols`` (W,) float64, the mapx of each column,
    and ``g`` (W,) float64 (from the JAX package's ``build_remap_plan``).

    Column coordinates as ``cv::remap`` takes them from the float32 map:
    quantized (OpenCV <= 4.x) ``s = rint(32 m)``, tap ``(s >> 5) - 1``,
    fraction ``(s & 31) / 32``; continuous (OpenCV 5.x) tap ``floor(m) -
    1``, fraction ``m - floor(m)``."""
    mapx_cols = np.asarray(mapx_cols, np.float64)
    g = np.asarray(g, np.float64)
    w = mapx_cols.shape[0]
    mx32 = mapx_cols.astype(np.float32)
    if quantized_coords:
        sx = np.rint(mx32 * np.float32(32.0)).astype(np.int64)
        ix = np.clip(sx >> 5, -32768, 32767).astype(np.int32)
        fx = (sx & 31).astype(np.float32) * np.float32(1.0 / 32.0)
    else:
        ix = np.floor(mx32).astype(np.int32)
        fx = (mx32 - ix).astype(np.float32)
    wx = interpolate_cubic_f32(fx).T.astype(np.float32)
    col_tap0 = (ix - 1).astype(np.int32)
    d = col_tap0 - np.arange(w, dtype=np.int32)
    r_lo = int(np.floor(g.min())) - 1
    # float32(y + g) may round up to the next integer; quantized, so may the
    # 1/32 grid
    r_hi = int(np.floor(g.max())) + 1 + int(quantized_coords)
    return RemapPlan(
        width=w, col_tap0=col_tap0, wx=wx, g=g,
        col_shifts=tuple(range(int(d.min()), int(d.max()) + 1)),
        row_offsets=tuple(range(r_lo, r_hi + 1)),
        quantized=quantized_coords,
    )


def plan_for_band_alignment(coeff_x, coeff_y, width: int,
                            quantized_coords: bool = False) -> RemapPlan:
    """Alignment maps from the fitted shift polynomials (preproc.h:443-450):
    mapx = (cX1*xx + cX0 + xx)/4, G = (cY2*xx^2 + cY1*xx + cY0)/4, xx = 4x."""
    xx = np.arange(width, dtype=np.float64) * 4.0
    mapx = (float(coeff_x[1]) * xx + float(coeff_x[0]) + xx) / 4.0
    g = (float(coeff_y[2]) * xx * xx + float(coeff_y[1]) * xx
         + float(coeff_y[0])) / 4.0
    return build_remap_plan(mapx, g, quantized_coords)


def plan_for_constant_shift(dx: float, dy: float, width: int,
                            quantized_coords: bool = False) -> RemapPlan:
    """Prestitch translation maps (stitcher.h:93-99): mapx = x + dx,
    mapy = y + dy, summed in double and stored as float32."""
    x = np.arange(width, dtype=np.float64) + float(dx)
    return build_remap_plan(x, np.full(width, float(dy), np.float64),
                            quantized_coords)


PARITY_CHUNK_ROWS = 2048   # output rows a step of the plain version


def _remap_rows(src: torch.Tensor, plan: RemapPlan, wx: torch.Tensor,
                col_idx: torch.Tensor, col_ok: torch.Tensor,
                g: torch.Tensor, y0: int, y1: int,
                origin: int = 0) -> torch.Tensor:
    """Output rows [y0, y1) of the section ``src``, whose row 0 is map row
    ``origin``: float32 (y1 - y0, W) before rounding.  Every float
    operation is one rounded IEEE operation in the oracle's order (no
    multiply-add is fused)."""
    rows, width = src.shape
    f32 = torch.float32
    # source rows [b0, b1), zeros beyond the section: every tap of a pixel
    # whose row offset lies in the plan's range falls inside
    b0, b1 = y0 - plan.halo_top, y1 + plan.halo_bottom
    buf = torch.zeros((b1 - b0, width), dtype=f32, device=src.device)
    lo, hi = max(b0, 0), min(b1, rows)
    if hi > lo:
        buf[lo - b0:hi - b0].copy_(src[lo:hi])
    # the 4 column taps of every pixel, 0 outside the width
    colg = buf.index_select(1, col_idx).view(-1, width, 4)
    colg.masked_fill_(~col_ok, 0.0)
    colg = colg.view(-1, 4)

    y = torch.arange(y0 + origin, y1 + origin, dtype=torch.int64,
                     device=src.device)
    v = (y.to(torch.float64)[:, None] + g[None, :]).to(f32)   # the map
    if plan.quantized:
        s = torch.round(v * 32.0).to(torch.int64)
        iy = torch.clamp(s >> 5, -32768, 32767)
        fy = (s & 31).to(f32) * (1.0 / 32.0)
    else:
        fl = torch.floor(v)
        iy = fl.to(torch.int64)
        fy = v - fl
    del v
    wy = _cubic_weights_f32(fy)
    del fy
    # the JAX package's rule, per pixel: a row offset outside the plan's
    # range (quantized rows past int16's saturation) gives 0
    r_off = iy - y[:, None]
    inside = (r_off >= plan.row_offsets[0]) & (r_off <= plan.row_offsets[-1])
    del r_off
    # buffer row of tap a = 0: source row iy - 1 sits at iy - 1 - b0
    base = iy - (b0 + origin + 1)
    del iy
    x = torch.arange(width, device=src.device)
    acc = None
    for a in range(4):
        r = torch.clamp(base + a, 0, buf.shape[0] - 1)
        taps = colg.index_select(0, (r * width + x).view(-1)).view(
            y1 - y0, width, 4)
        # W[a, b] = float32(wy[a] * wx[b]); each tap row summed in b order
        p = taps * (wy[a][..., None] * wx)
        t = ((p[..., 0] + p[..., 1]) + p[..., 2]) + p[..., 3]
        acc = t if acc is None else acc + t
    return acc.masked_fill_(~inside, 0.0)


def _remap_section_plain(src: torch.Tensor, plan: RemapPlan, first: int,
                         count: int, origin: int,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of kernel (f): :data:`PARITY_CHUNK_ROWS` output
    rows at a time (read at call time), each chunk with its halo rows."""
    width = src.shape[1]
    dev = src.device
    wx = torch.from_numpy(np.ascontiguousarray(plan.wx.T)).to(dev)
    cols = torch.from_numpy(plan.col_tap0.astype(np.int64))[:, None] + \
        torch.arange(4)
    col_ok = ((cols >= 0) & (cols < width)).to(dev)
    col_idx = torch.clamp(cols, 0, width - 1).view(-1).to(dev)
    g = torch.from_numpy(plan.g).to(dev)
    chunk = PARITY_CHUNK_ROWS
    if out is None:
        out = torch.empty((count, width), dtype=torch.uint16, device=dev)
    for y0 in range(first, first + count, chunk):
        y1 = min(y0 + chunk, first + count)
        out[y0 - first:y1 - first] = _round_u16(
            _remap_rows(src, plan, wx, col_idx, col_ok, g, y0, y1, origin))
    return out


def _check_section_args(src: torch.Tensor, plan: RemapPlan, first: int,
                        count: int, out=None) -> torch.Tensor:
    """The checked arguments' output: ``out``, or a new (count, W) uint16
    raster on ``src``'s device."""
    if src.dim() != 2 or src.dtype != torch.uint16:
        raise ValueError(
            "remap_section_u16: the section must be (rows, W) uint16; got "
            f"{tuple(src.shape)} {src.dtype}")
    rows, width = src.shape
    if width != plan.width or plan.col_tap0.shape != (width,) \
            or plan.wx.shape != (4, width) or plan.g.shape != (width,):
        raise ValueError(
            f"remap_section_u16: section width {width} does not match the "
            f"plan (width {plan.width})")
    if first < 0 or count < 0 or first + count > rows:
        raise ValueError(
            f"remap_section_u16: output rows [{first}, {first + count}) "
            f"outside the section's {rows}")
    if out is None:
        return torch.empty((count, width), dtype=torch.uint16,
                           device=src.device)
    if (tuple(out.shape) != (count, width) or out.dtype != torch.uint16
            or out.device != src.device or not out.is_contiguous()):
        raise ValueError(
            f"remap_section_u16: out must be a contiguous ({count}, "
            f"{width}) uint16 raster on {src.device}; got "
            f"{tuple(out.shape)} {out.dtype} on {out.device}")
    return out


# kernel (f)'s block (csrc/remap_section.cu): threads, each owning 2
# adjacent output columns; output rows a band of the staged source window
# (preferred first) and a block's row chunk (preferred, least)
SECTION_THREADS = 128
SECTION_COLS = 2 * SECTION_THREADS
SECTION_BAND_ROWS = (32, 16, 8, 4)
_SECTION_CHUNK_ROWS = (256, 64)
SECTION_SMEM = 48 * 1024   # bytes of double-buffered window a block
_MAX_GRID_Y = 65535
# |mapy| below which the kernel's float bit tricks take the coordinate:
# floor for continuous maps (|v| < 2^22), rint(32 v) for quantized ones
_NARROW = {False: 1 << 22, True: 1 << 17}


@dataclass(frozen=True)
class SectionGeometry:
    """Kernel (f)'s launch geometry (:func:`remap_section_geometry`)."""

    chunk: int                 # output rows a block walks
    grid: tuple[int, int]      # (column blocks, row chunks, <= 65535)
    table: np.ndarray          # (column blocks, 5) int32, see below
    smem: int                  # bytes of dynamic shared memory a block
    narrow: bool               # coordinates within the float bit tricks
    wide_offsets: bool         # element offsets need 64 bits
    stage16: bool              # 16-byte cp.async copies of the window


def remap_section_geometry(plan: RemapPlan, rows: int, first: int,
                           count: int, origin: int, n_sm: int = 132,
                           aligned: bool = True) -> SectionGeometry:
    """Kernel (f)'s launch geometry for output rows ``[first, first +
    count)`` of a (rows, W) section whose row 0 is map row ``origin``.

    A block owns :data:`SECTION_COLS` output columns and a chunk of output
    rows (256, halved down to 64 while the grid has fewer than 8 blocks an
    SM), which it walks in bands.  For each band it stages the source
    window its pixels read in shared memory, double-buffered.  Row ``b`` of
    ``table`` describes column block ``b``: the window's first column
    (a multiple of 8) and its pitch in elements (a multiple of 8, from the
    block's least ``col_tap0`` to its greatest plus 4), the least and
    greatest row offset ``iy - Y`` its window holds (``lo``, ``hi``: the
    band of output rows ``[y0, y1)`` reads source rows ``[y0 + lo - 1, y1
    + hi + 2)``), and its rows a band: the largest of
    :data:`SECTION_BAND_ROWS` whose two windows fit in
    :data:`SECTION_SMEM` bytes, or 0 where none does (the block then reads
    its taps from device memory).

    The row offsets of a block are ``floor(g) - 1`` to ``floor(g) + 1``
    (+1 quantized) over its columns, as :func:`build_remap_plan` reckons
    the plan's, where the coordinates are narrow enough for that to hold
    (below ``2^22`` continuous, ``2^17`` quantized) and no quantized row
    can saturate at int16; else the plan's whole range, which holds the
    taps of every pixel that is not 0.  ``stage16`` needs a width that is
    a multiple of 8 and a 16-byte aligned section (``aligned``)."""
    width = plan.width
    q = bool(plan.quantized)
    r_lo, r_hi = plan.row_offsets[0], plan.row_offsets[-1]
    y_lo, y_hi = first + origin, first + max(count, 1) - 1 + origin
    g_lo, g_hi = float(plan.g.min()), float(plan.g.max())
    narrow = max(abs(y_lo + g_lo), abs(y_lo + g_hi), abs(y_hi + g_lo),
                 abs(y_hi + g_hi)) + 2 < _NARROW[q]
    saturates = q and not (-32768 <= y_lo + math.floor(g_lo) - 1
                           and y_hi + math.floor(g_hi) + 2 <= 32767)
    n_cb = -(-width // SECTION_COLS)
    starts = np.arange(n_cb) * SECTION_COLS
    tap0 = plan.col_tap0.astype(np.int64)
    cw0 = np.minimum.reduceat(tap0, starts) // 8 * 8
    cw1 = -(-(np.maximum.reduceat(tap0, starts) + 4) // 8) * 8
    if narrow and not saturates:
        g_floor = np.floor(plan.g)
        lo = np.maximum(np.minimum.reduceat(g_floor, starts) - 1, r_lo)
        hi = np.minimum(np.maximum.reduceat(g_floor, starts) + 1 + q, r_hi)
    else:
        lo, hi = np.full(n_cb, r_lo), np.full(n_cb, r_hi)
    # bytes of a block's two windows at each choice of rows a band
    bands = np.array(SECTION_BAND_ROWS)
    need = 2 * (bands[:, None] + hi - lo + 3) * 2 * (cw1 - cw0)
    fits = need <= SECTION_SMEM
    pick = fits.argmax(axis=0)
    staged = fits.any(axis=0)
    band = np.where(staged, bands[pick], 0)
    smem = int(need[pick, np.arange(n_cb)][staged].max(initial=0))
    table = np.stack([cw0, cw1 - cw0, lo, hi, band], axis=1)
    chunk, least = _SECTION_CHUNK_ROWS
    while chunk > least and n_cb * -(-count // chunk) < 8 * n_sm:
        chunk //= 2
    n_chunks = max(1, -(-count // chunk))
    return SectionGeometry(
        chunk=chunk, grid=(n_cb, min(n_chunks, _MAX_GRID_Y)),
        table=table.astype(np.int32), smem=smem, narrow=bool(narrow),
        wide_offsets=rows * width >= 1 << 31,
        stage16=aligned and width % 8 == 0)


def quantized_row_weights() -> np.ndarray:
    """(32, 4) float32: the row weights of quantized coordinates, the
    plain version's ``_cubic_weights_f32((s & 31) / 32)`` for each of the
    32 fractions (kernel (f) looks them up)."""
    fy = torch.arange(32, dtype=torch.float32) * (1.0 / 32.0)
    return torch.stack(_cubic_weights_f32(fy), dim=1).numpy()


def _section_device_args(src: torch.Tensor, plan: RemapPlan, first: int,
                         count: int, origin: int):
    """Kernel (f)'s device copies of ``plan`` and its launch geometry for
    one call on the CUDA section ``src``, made at first use and kept in
    ``plan.cuda_cache``: -> (tap0, wx, g, wy, geometry, table)."""
    dev = src.device
    cache = plan.cuda_cache

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if dev not in cache:
        cache[dev] = (up(plan.col_tap0.astype(np.int32)),
                      up(plan.wx.astype(np.float32)),
                      up(plan.g.astype(np.float64)),
                      up(quantized_row_weights()))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    key = (dev, src.shape[0], first, count, origin, n_sm,
           src.data_ptr() % 16 == 0)
    if key not in cache:
        geo = remap_section_geometry(plan, *key[1:])
        cache[key] = (geo, up(geo.table))
    return (*cache[dev], *cache[key])


def prepare_remap_section(src: torch.Tensor, plan: RemapPlan, first: int = 0,
                          count: int | None = None, origin: int = 0) -> None:
    """Make the device copies and the launch geometry of a coming
    :func:`remap_section_u16` call on the CUDA section ``src`` now (nothing
    on the CPU).  Each is an upload from pageable memory, which waits for
    the stream to drain: a loop of calls prepared first launches them back
    to back."""
    if src.device.type == "cpu":
        return
    count = src.shape[0] - first if count is None else count
    _section_device_args(src.contiguous(), plan, first, count, origin)


def _remap_section_cuda(src: torch.Tensor, plan: RemapPlan, first: int,
                        count: int, origin: int,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel (f), ``csrc/remap_section.cu``: one launch a call."""
    out = _check_section_args(src, plan, first, count, out)
    _build.require_cuda("remap_section_u16", src)
    src = src.contiguous()
    rows, width = src.shape
    dev = src.device
    if not out.numel():
        return out
    tap0, wx, g, wy, geo, table = _section_device_args(src, plan, first,
                                                       count, origin)
    _build.launch(
        "remap_section", "oip_remap_section", src.data_ptr(),
        tap0.data_ptr(), wx.data_ptr(), g.data_ptr(), wy.data_ptr(),
        table.data_ptr(), out.data_ptr(), rows, width, first, count, origin,
        int(plan.quantized), plan.row_offsets[0], plan.row_offsets[-1],
        geo.chunk, *geo.grid, geo.smem, int(geo.narrow),
        int(geo.wide_offsets), int(geo.stage16), _build.stream_of(src),
        device=dev,
    )
    return out


def remap_section_u16(src: torch.Tensor, plan: RemapPlan, first: int = 0,
                      count: int | None = None, origin: int = 0,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """``cv::remap(section, mapx, mapy, INTER_CUBIC, BORDER_CONSTANT, 0)``
    of a (rows, W) uint16 section with the section-local maps of ``plan``:
    rows and columns outside the section read 0, a pixel whose whole 4x4
    support lies outside is 0, the sum is rounded half to even and clamped
    to [0, 65535].  Returns (count, W) uint16 on ``src``'s device: kernel
    (f) on CUDA tensors, the plain version on CPU ones.

    ``first`` / ``count`` select output rows ``[first, first + count)`` of
    the section (default: from ``first`` to the end), and ``origin`` is the
    map row of the section's row 0: the line mesh remaps a shard with its
    halo rows under whole-image maps (``mapy = float32(y + G)``, ``y`` the
    strip's row).

    A pixel whose row offset ``iy - (y + origin)`` lies outside
    ``plan.row_offsets`` is 0, as in the JAX package's
    ``_remap_section_math``: that happens only where quantized coordinates
    saturate at int16 (map rows past 32767), where ``cv::remap`` would
    repeat the saturated row.  The result does not depend on the plain
    version's chunking.  ``out``, a contiguous (count, W) uint16 raster
    on ``src``'s device (a row range of a larger one), takes the rows in
    place of a new raster."""
    count = src.shape[0] - first if count is None else count
    if src.device.type != "cpu":
        return _remap_section_cuda(src, plan, first, count, origin, out)
    out = _check_section_args(src, plan, first, count, out)
    return _remap_section_plain(src, plan, first, count, origin, out)


def remap_polynomial_u16(src: torch.Tensor, coeff_x, coeff_y,
                         quantized_coords: bool = False) -> torch.Tensor:
    """Band-alignment remap of one section with fitted polynomials."""
    return remap_section_u16(src, plan_for_band_alignment(
        coeff_x, coeff_y, src.shape[1], quantized_coords))


def remap_constant_shift_u16(src: torch.Tensor, dx: float, dy: float,
                             quantized_coords: bool = False) -> torch.Tensor:
    """Prestitch constant-translation remap of one section."""
    return remap_section_u16(src, plan_for_constant_shift(
        dx, dy, src.shape[1], quantized_coords))


# ---------------------------------------------------------------------------
# The reference's section loops, as plans of remap calls
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SectionCut:
    """One remap call of a section loop: strip rows ``[offset, offset +
    rows)`` remapped as one section (its map rows from 0), of whose output
    rows ``[first, first + count)`` go to rows ``[dst, dst + count)`` of
    the product."""

    offset: int
    rows: int
    first: int
    count: int
    dst: int


def sectionary_cuts(dy: float) -> tuple[int, int]:
    """SectionaryRemap's upper and bottom cuts ``(ucut, bcut)`` for the
    vertical shift ``dy`` (stitcher.h:83-139): the rows a section's shifted
    support leaves it by, at its top for dy < 0, at its bottom for
    dy >= 0."""
    ucut = 0 if dy >= 0.0 else int(-dy) + 1
    bcut = int(dy) + 1 if dy >= 0.0 else 0
    return ucut, bcut


@dataclass(frozen=True)
class SectionaryPlan:
    """The prestitch's section loop (:func:`sectionary_plan`): ``cuts`` in
    write order, then, where the bottom cut comes from the reference's
    rolling buffer, ``window``: the (strip row, rows) pieces of the
    rebuilt buffer rows, top to bottom, remapped as one section of their
    own, whose output rows ``[window_first, window_first + bcut)`` follow
    the cuts' rows.  ``end`` is SectionaryRemap's return, the final row
    offset."""

    cuts: tuple[SectionCut, ...]
    window: tuple[tuple[int, int], ...]
    window_first: int
    bcut: int
    end: int

    @property
    def window_dst(self) -> int:
        """The first product row of the window's rows: the cuts' rows."""
        return sum(c.count for c in self.cuts)

    @property
    def rows(self) -> int:
        """The product's rows."""
        return self.window_dst + (self.bcut if self.window else 0)


def sectionary_plan(lines: int, section_rows: int,
                    dy: float) -> SectionaryPlan:
    """PreStitch's SectionaryRemap of a ``lines``-row strip (the JAX
    package's ``pre_stitch``): sections of ``section_rows`` rows advancing
    by the rows they keep, each keeping its rows between the upper and
    bottom cuts (:func:`sectionary_cuts`), the first section also its
    leading ``ucut`` rows.  The bottom cut of a strip of 2 or more
    sections is the reference's rolling ``section_rows``-row buffer's last
    ``bcut`` rows, whose rows beyond the final section's fresh read still
    hold the previous section's (PreStitch reuses the buffer without
    clearing it): the plan rebuilds the buffer's last ``2 * bcut + 8``
    rows and remaps them as a section of their own, rows past it reading
    0 like the Mat's edge -- the JAX package's window, whose ``y`` starts
    at 0 where the reference's runs to ``section_rows - 1`` (float32(y +
    dy) rounds alike on the quantized 1/32-px grid, and up to 2^-11 px
    apart in continuous coordinates).  A single-section strip keeps its
    fresh tail (the reference refuses such strips, REMAP_ROW_GUARD)."""
    ucut, bcut = sectionary_cuts(dy)
    total_cut = ucut + bcut
    cuts = []
    row_offset = prev_offset = final_offset = dst = 0
    while True:
        rows = min(section_rows, lines - row_offset)
        if rows <= total_cut:
            break
        first = ucut if cuts else 0
        cuts.append(SectionCut(row_offset, rows, first,
                               rows - bcut - first, dst))
        dst += rows - bcut - first
        prev_offset, final_offset = final_offset, row_offset
        row_offset += rows - total_cut
    window, window_first = (), 0
    if bcut > 0 and len(cuts) == 1:
        c = cuts[0]
        cuts[0] = SectionCut(c.offset, c.rows, c.first, c.count + bcut, c.dst)
    elif bcut > 0 and cuts:
        w0 = max(0, section_rows - 2 * bcut - 8)
        fresh_hi = min(lines - final_offset, section_rows)
        pieces = []
        if fresh_hi > w0:
            pieces.append((final_offset + w0, fresh_hi - w0))
        if section_rows > fresh_hi:
            j0 = max(w0, fresh_hi)
            pieces.append((prev_offset + j0, section_rows - j0))
        window, window_first = tuple(pieces), section_rows - bcut - w0
    return SectionaryPlan(tuple(cuts), window, window_first, bcut,
                          row_offset)


def ibpa_plan(lines: int, line_per_section: int, line_offset: int,
              section_overlap: int,
              keep_leading_lines: bool = False) -> tuple[SectionCut, ...]:
    """DoInterBandAlignment's sections of a ``lines``-line band strip
    (preproc.h:351-425): ``line_per_section`` lines from ``line_offset``,
    advancing by ``line_per_section - section_overlap`` while at least
    IBPA_MIN_PROCESSLINES lines are left, each keeping the rows after its
    first ``section_overlap`` (the first section all of them with
    ``keep_leading_lines``), written one after another from row 0; rows
    of the product past the last section stay 0, as in the reference."""
    cuts = []
    offset = line_offset
    dst = 0
    while True:
        rows = min(lines - offset, line_per_section)
        if lines < offset or rows < IBPA_MIN_PROCESSLINES:
            break
        first = 0 if not cuts and keep_leading_lines else section_overlap
        cuts.append(SectionCut(offset, rows, first, rows - first, dst))
        dst += rows - first
        offset += line_per_section - section_overlap
    return tuple(cuts)

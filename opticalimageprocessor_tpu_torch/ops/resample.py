"""Cubic resampling of the fast scene path, in PyTorch.

Counterpart of ``opticalimageprocessor_tpu/ops/resample.py``'s fast path:

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
  translation of PAN2 and the seam concat: kernel (d) on CUDA.

The column cubic keeps the semantics of the JAX package's banded column
matrix (``_col_interp_matrix``): taps outside the image, or outside their
``col_block`` block's ``col_halo`` window, are dropped.  All weight and
coordinate arithmetic is float32 in the reference's expression order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
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
    """x4 along ``axis`` with replicate-clamped taps, grouped order."""
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    phases = []
    for r in range(4):
        g = [
            x.index_select(axis, torch.clamp(idx + _X4_BASE[r] + c, 0, n - 1))
            for c in range(4)
        ]
        w = [float(v) for v in _X4_W[r]]
        phases.append(((g[0] * w[0] + g[1] * w[1]) + g[2] * w[2]) + g[3] * w[3])
    ax = axis % x.dim()
    shape = list(x.shape)
    shape[ax] = 4 * n
    return torch.stack(phases, dim=ax + 1).reshape(shape)


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
        seg, tile, _build.stream_of(src),
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
        _build.stream_of(padded),
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


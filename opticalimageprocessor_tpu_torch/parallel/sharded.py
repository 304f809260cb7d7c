"""Sharded steps of the file commands over the line mesh: the default
action's registration + alignment and the prestitch.

Counterpart of ``opticalimageprocessor_tpu/parallel/sharded.py``.  The
strip's line axis is split over a :class:`~.mesh.LineMesh` and the
reference's serial pipeline (preproc.h:224-468) maps onto it in three
stages:

1. RRC + correlate: kernel (a) on every shard; the reference's sections x
   slices tiles (CalcInterBandCorrelation, preproc.h:245-259) cut from the
   shards and spread over the devices in contiguous blocks of tiles, each
   block phase-correlated on its device as the host ``PreProcessor`` does
   (x4 upsample, optimal-DFT padding: ``ops/phasecorr``, no kernel);
2. fit: the (dx, dy, response) table goes to the host and through the
   float64 filter + fit of ``ops/polyfit`` (the 0.4 response threshold,
   the >= 5-samples error), so the coefficients are the host route's;
3. remap: each shard with its neighbours' halo rows through the staged
   fast remap (the column cubic, then kernel (e) at ``ROW_OFF_BOUND``),
   or with ``quantized`` the parity remap under whole-image maps.

Semantics, as in JAX: the resample sees true neighbour rows at shard seams
and border 0 at the strip ends -- the unsectioned result; the reference's
section-seam artifacts (preproc.h:428-457) are the parity route's.
Shards may be uneven: no row is padding, so no pad row is ever masked.

On a mesh spanning processes each process ingests and computes its own
shards and its own blocks of tiles; the tile rows and halos come through
``LineSharded.fetch`` and the per-tile statistics are all-gathered in tile
order (``distributed.all_gather_list``), so every process fits the same
coefficients from the same bytes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import (
    CORRELATION_LINES,
    IBCV_DEF_SECTIONS,
    IBCV_DEF_SLICES,
    IBCV_DEF_THRESHOLD,
    MSS_BANDS,
)
from ..models.device_pipeline import tile_blocks, tile_runs
from ..ops import phasecorr, polyfit, resample
from ..ops.rrc import rrc_apply
from .distributed import all_gather_list
from .halo import clipped_halo
from .mesh import LineMesh, LineSharded, pad_to_multiple

# conservative static bound on |floor(G)| for the dynamic remap's vertical
# shifts; real band misregistrations are a few pixels
ROW_OFF_BOUND = 6


def shard_bounds(rows: int, n: int, unit: int = 1) -> list[tuple[int, int]]:
    """Row ranges of ``n`` shards of a ``rows``-line strip: each a multiple
    of ``unit`` long, ``unit * ceil(rows / (n * unit))`` rows, the last
    ones shorter or empty -- JAX's padded layout without its padding.  A
    PAN split with ``unit`` 4 and its MSS split with ``unit`` 1 line up:
    MSS shard ``i`` is PAN shard ``i``'s rows / 4."""
    per = pad_to_multiple(-(-rows // n), unit)
    return [(min(i * per, rows), min((i + 1) * per, rows)) for i in range(n)]


def ingest_line_sharded(mesh: LineMesh, view, rows_axis: int = 0,
                        unit: int = 1) -> LineSharded:
    """Shard-by-shard ingest of a host array view (a memory map) or a
    tensor onto the mesh: each shard's rows (:func:`shard_bounds`) are
    read and copied to its device in turn, so the host holds one shard at
    a time.  Only this process's shards are read."""
    rows = view.shape[rows_axis]
    bounds = shard_bounds(rows, len(mesh), unit)
    shards = []
    for (a, b), dev in zip(bounds, mesh.devices):
        if dev is None:
            shards.append(None)
            continue
        if isinstance(view, torch.Tensor):
            shards.append(view.narrow(rows_axis, a, b - a).to(dev))
            continue
        idx = [slice(None)] * view.ndim
        idx[rows_axis] = slice(a, b)
        # a copy: a memory map's rows are read-only and stay mapped
        shards.append(torch.from_numpy(np.array(view[tuple(idx)])).to(dev))
    return LineSharded(mesh, shards, rows_axis,
                       [a for a, _ in bounds] + [rows])


def as_line_sharded(mesh: LineMesh, x, rows_axis: int = 0,
                    unit: int = 1) -> LineSharded:
    """``x`` line-sharded over ``mesh`` (ingested when it is a host array
    or a tensor)."""
    if isinstance(x, LineSharded):
        if x.mesh is not mesh and x.mesh.devices != mesh.devices:
            raise ValueError(f"a raster sharded over {x.mesh}, not {mesh}")
        return x
    return ingest_line_sharded(mesh, x, rows_axis, unit)


def rrc_sharded(x: LineSharded, k, b) -> LineSharded:
    """RRC (kernel (a)) of every shard with float64 ``(k, b)``: (cols,)
    for a (rows, cols) raster, (bands, cols) for (bands, rows, cols)."""
    params = {dev: [torch.as_tensor(v, dtype=torch.float64).to(dev)
                    for v in (k, b)] for dev in x.mesh.distinct()}
    return x.map(lambda t, dev: rrc_apply(t, *params[dev]))


def interleave(bands: list[LineSharded]) -> LineSharded:
    """(rows, W) line-sharded bands -> one (rows, W, bands) raster, shard
    by shard on each shard's device."""
    def stack(i, dev):
        t0 = bands[0].shards[i]
        if t0 is None:
            return None
        out = torch.empty((*t0.shape, len(bands)), dtype=t0.dtype,
                          device=dev)
        for k, band in enumerate(bands):
            out[..., k].copy_(band.shards[i])
        return out

    mesh = bands[0].mesh
    return LineSharded(mesh, [stack(i, dev)
                              for i, dev in enumerate(mesh.devices)], 0,
                       bands[0].edges)


def remap_band_dynamic(band: LineSharded, coeff_x, coeff_y,
                       row_bound: int = ROW_OFF_BOUND) -> LineSharded:
    """Alignment remap of a line-sharded (rows, W) uint16 band with fitted
    coefficients ``coeff_x`` (2,) / ``coeff_y`` (3,): every shard with
    ``row_bound + 1`` halo rows above and ``row_bound + 2`` below from its
    neighbours (none beyond the strip ends) through the staged fast remap
    (``ops/resample.remap_band_fast``: the column cubic, then kernel (e),
    U = 2 * row_bound + 4), and its own rows kept.  Equal to the
    whole-strip remap: every output row reads true rows, or 0 past a strip
    end."""
    out = []
    for (win, top), (a, b) in zip(
        clipped_halo(band, row_bound + 1, row_bound + 2),
        map(band.bounds, range(len(band.shards))),
    ):
        if win is None or a == b:
            out.append(win)
            continue
        res = resample.remap_band_fast(
            win, coeff_x, coeff_y, row_bound,
            chunk_rows=resample.STAGED_CHUNK_ROWS)
        out.append(res[top:top + b - a])
    return LineSharded(band.mesh, out, 0, band.edges)


def auto_sections(lines_pan: int) -> int:
    """Largest reference-legal section count <= the default 5."""
    return max(1, min(IBCV_DEF_SECTIONS, lines_pan // CORRELATION_LINES))


def _correlate_file_tiles(pan_c: LineSharded, mss_c: LineSharded, r0s, br0s,
                          base_rows, band_rows, cols, band_cols, slices):
    """The sections x slices tiles of the corrected strips, a contiguous
    block of them on each device, phase-correlated there as the host
    ``PreProcessor`` correlates them, one tile (its 4 bands) a batch: an
    FFT's last bits may depend on its batch, and this way they do not
    depend on the mesh.  -> numpy (dx, dy, rs), each (T * 4,) tile-major
    then band (the host table's order), on every process."""
    from ..models.preprocessor import _correlate_tiles

    mesh = pan_c.mesh
    runs = tile_runs(tile_blocks(len(r0s) * slices, len(mesh)), slices)
    pan_blks = pan_c.fetch([(d, r0s[sec], r0s[sec] + base_rows,
                             (i0 * cols, i1 * cols))
                            for d, sec, i0, i1 in runs])
    band_blks = mss_c.fetch([(d, br0s[sec], br0s[sec] + band_rows,
                              (i0 * band_cols, i1 * band_cols))
                             for d, sec, i0, i1 in runs])
    stats = []
    for (d, sec, i0, i1), pan_blk, band_blk in zip(runs, pan_blks,
                                                    band_blks):
        if pan_blk is None:
            continue
        for i in range(i1 - i0):
            stats.append(_correlate_tiles(
                pan_blk[None, :, i * cols:(i + 1) * cols],
                band_blk[:, :, i * band_cols:(i + 1) * band_cols],
                MSS_BANDS))
    stats = all_gather_list(mesh, stats)
    return tuple(np.concatenate([s[k] for s in stats]) for k in range(3))


def plan_remap_sharded(mss_c: LineSharded, coeff_x, coeff_y,
                       quantized: bool) -> LineSharded:
    """The parity-grade 4-band alignment resample of line-sharded (4,
    rows, W) bands: host float64 plans (``ops/resample.
    plan_for_band_alignment``, the cv::remap reproduction with its float32
    map storage and, with ``quantized``, OpenCV <= 4.x's 1/32-px grid), and
    every shard with its halo rows remapped under whole-image maps -- its
    first row's map row is its row in the strip, as JAX's ``y0`` is the
    shard's absolute first row.  -> (rows, W, 4)."""
    width = mss_c.shape[-1]
    plans = [resample.plan_for_band_alignment(coeff_x[b], coeff_y[b], width,
                                              quantized)
             for b in range(MSS_BANDS)]
    top = max(p.halo_top for p in plans)
    bottom = max(p.halo_bottom for p in plans)
    out = []
    for i, (win, t) in enumerate(clipped_halo(mss_c, top, bottom)):
        if win is None:
            out.append(None)
            continue
        a, b = mss_c.bounds(i)
        res = torch.empty((b - a, width, MSS_BANDS), dtype=torch.uint16,
                          device=win.device)
        for k in range(MSS_BANDS if b > a else 0):
            res[..., k].copy_(resample.remap_section_u16(
                win[k], plans[k], first=t, count=b - a, origin=a - t))
        out.append(res)
    return LineSharded(mss_c.mesh, out, 0, mss_c.edges)


def make_align_step(
    mesh: LineMesh,
    slices: int = IBCV_DEF_SLICES,
    sections: int | None = None,
    threshold: float = IBCV_DEF_THRESHOLD,
    quantized: bool = False,
    want_pan_c: bool = False,
):
    """The default action's sharded step over ``mesh``.

    ``step(pan, mss, pan_params, mss_params, line_offset=0,
    real_lines_pan=None)``: ``pan`` (L, W) and ``mss`` (4, L/4, W/4)
    uint16 (line-sharded, or host arrays / tensors to ingest), the float64
    RRC ``(k, b)`` pairs ((W,) and (4, W/4)) -> (aligned (L/4 -
    line_offset, W/4, 4) line-sharded, coeff_x (4, 2), coeff_y (4, 3)
    float64[, the corrected PAN line-sharded with ``want_pan_c``]).

    The coefficients come from the host float64 fit of the tile table, so
    they are the host ``PreProcessor``'s; fewer than 5 samples at response
    >= ``threshold`` in a band raise the reference's "Not enough valid
    correlation values".  ``line_offset``: first MSS line to align (the
    rows above it are outside the remapped strip; correlation samples the
    whole strip).  ``quantized`` remaps through
    :func:`plan_remap_sharded`; otherwise each band goes through
    :func:`remap_band_dynamic` (kernel (e)).
    """

    from ..models.preprocessor import ibc_geometry

    def step(pan, mss, pan_params, mss_params, line_offset: int = 0,
             real_lines_pan: int | None = None):
        pan = as_line_sharded(mesh, pan, 0, unit=MSS_BANDS)
        mss = as_line_sharded(mesh, mss, 1)
        width = pan.shape[1]
        real_pan = real_lines_pan or pan.rows
        nsec = sections if sections is not None else auto_sections(real_pan)
        r0s, br0s, base_rows, band_rows, cols, band_cols, centers = \
            ibc_geometry(real_pan, width, slices, nsec)
        pan_c = rrc_sharded(pan, *pan_params)
        mss_c = rrc_sharded(mss, *mss_params)
        dx, dy, rs = (np.asarray(v, np.float64).reshape(-1, MSS_BANDS)
                      for v in _correlate_file_tiles(
                          pan_c, mss_c, r0s, br0s, base_rows, band_rows,
                          cols, band_cols, slices))
        cx = np.asarray(centers, np.float64)
        coeff_x = np.zeros((MSS_BANDS, 2))
        coeff_y = np.zeros((MSS_BANDS, 3))
        for b in range(MSS_BANDS):
            coeff_x[b], coeff_y[b] = polyfit.fit_shift_models_filtered(
                cx, dx[:, b], dy[:, b], rs[:, b], threshold, b + 1
            )
        src = mss_c.drop_rows(line_offset) if line_offset else mss_c
        if quantized:
            aligned = plan_remap_sharded(src, coeff_x, coeff_y, True)
        else:
            aligned = interleave([
                remap_band_dynamic(src.band(b), coeff_x[b].astype(np.float32),
                                   coeff_y[b].astype(np.float32))
                for b in range(MSS_BANDS)])
        if want_pan_c:
            return aligned, coeff_x, coeff_y, pan_c
        return aligned, coeff_x, coeff_y

    return step


def make_prestitch_step(
    mesh: LineMesh,
    sections: int,
    line_per_section: int,
    overlap_cols: int,
    edge_cols: int = 0,
):
    """The sharded prestitch pieces over ``mesh``: ``(correlate, rrc,
    remap)``.

    * ``correlate(pan1, pan2, real_lines=None)`` -> numpy (dx, dy, rs) a
      section: the reference's sampled overlap windows (stitcher.h:151-176,
      PAN1's right ``overlap - edge`` columns against PAN2's left) of the
      *uncorrected* strips (main.cpp:280-284), a contiguous block of
      sections on each device, phase-correlated as the host ``Stitcher``
      does; filter them with ``models.stitcher.average_valid_deltas``;
    * ``rrc(strip, params)`` -> the corrected strip (kernel (a) a shard);
    * ``remap(pan2_c, delta_x, delta_y)`` -> the prestitched strip: the
      constant shift as alignment coefficients (cX = [4 dx, 0], cY = [4
      dy, 0, 0]) through :func:`remap_band_dynamic` at row bound
      ``max(6, ceil(|dy|) + 1)``.
    """

    from ..models.device_pipeline import stt_offsets

    def correlate(pan1, pan2, real_lines: int | None = None):
        pan1 = as_line_sharded(mesh, pan1)
        pan2 = as_line_sharded(mesh, pan2)
        lines, width = real_lines or pan1.rows, pan1.shape[1]
        offs = stt_offsets(lines, sections, line_per_section)
        plan = [(d, o, o + line_per_section)
                for d, (s0, s1) in enumerate(tile_blocks(sections, len(mesh)))
                for o in offs[s0:s1]]
        win1, win2 = (strip.fetch([(d, a, b, c) for d, a, b in plan])
                      for strip, c in (
                          (pan1, (width - overlap_cols, width - edge_cols)),
                          (pan2, (edge_cols, overlap_cols))))
        stats = []
        for t1, t2 in zip(win1, win2):
            if t1 is None:
                continue
            # one section a batch, as the tiles of the align step
            stats.append([v.cpu().numpy() for v in
                          phasecorr.phase_correlate_batch(
                              t1[None].to(torch.float32),
                              t2[None].to(torch.float32))])
        stats = all_gather_list(mesh, stats)
        return tuple(np.concatenate([s[k] for s in stats]) for k in range(3))

    def rrc(strip, params):
        return rrc_sharded(as_line_sharded(mesh, strip), *params)

    def remap(pan2_c, delta_x: float, delta_y: float):
        row_bound = max(ROW_OFF_BOUND,
                        int(math.ceil(abs(float(delta_y)))) + 1)
        cx = torch.tensor([4.0 * float(delta_x), 0.0], dtype=torch.float32)
        cy = torch.tensor([4.0 * float(delta_y), 0.0, 0.0],
                          dtype=torch.float32)
        return remap_band_dynamic(as_line_sharded(mesh, pan2_c), cx, cy,
                                  row_bound)

    return correlate, rrc, remap

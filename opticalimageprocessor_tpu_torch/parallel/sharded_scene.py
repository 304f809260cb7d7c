"""The scene over the line mesh (``scene --mesh N``).

Counterpart of ``opticalimageprocessor_tpu/parallel/sharded_scene.py``,
with the port's single-device modules doing the per-device work:

* estimate: the registration tiles are cut from the line shards, RRC'd as
  they are cut (kernel (a)), and spread over the devices in contiguous
  blocks of tiles (JAX's tile axis); each block goes through
  ``device_pipeline.correlate_tiles`` on its device (cuFFT and kernel
  (b)), the (dx, dy, response) statistics are gathered to the first
  device and fitted there (``fit_tiles``); the stt windows are spread the
  same way and averaged on the first device (``stt_peaks``,
  ``stt_average``);
* transform: every shard, with its neighbours' halo rows copied onto its
  device, goes through ``ScenePipeline.transform`` (kernels (a), (c) at
  row bound 3, (d)) or ``MssAlign.remap`` (kernel (c) at row bound 6), and
  keeps its own rows.

The halos are clipped at the strip ends, as the streamed route cuts its
sections: kernels (c) and (d) read 0 past the edges of their input after
the RRC, so a strip end sees border 0, never the RRC of a zero fill (which
is its bias -- JAX masks its pad rows for that reason, :379-432).  No
output row depends on its absolute index, so with the same estimates every
raster is the resident route's, byte for byte.  The estimates are too
wherever a transform's batch size does not change its bits (the CPU);
cuFFT may choose other plans for other batch sizes.
"""

from __future__ import annotations

import copy

import torch

from ..constants import MSS_BANDS
from ..models.device_pipeline import (
    MssAlign,
    ScenePipeline,
    _section_tiles,
    correlate_tiles,
    fit_tiles,
    register_geometry,
    stt_average,
    stt_geometry,
    stt_peaks,
)
from ..ops.rrc import rrc_apply
from .halo import clipped_halo
from .mesh import LineMesh, LineSharded
from .sharded import as_line_sharded, tile_blocks


def _per_device(module, mesh: LineMesh) -> dict:
    """A copy of ``module`` on each distinct device of the mesh."""
    return {dev: copy.deepcopy(module).to(dev) for dev in mesh.distinct()}


def correlate_sharded(geom, pan: LineSharded, mss: LineSharded,
                      params: dict | None = None, win=(64, 64)):
    """Registration statistics of line-sharded strips: ``pan`` (L, W) and
    ``mss`` (4, L/4, W/4), RAW when ``params`` (``{device: (pan_k, pan_b,
    mss_k, mss_b)}``) is given -- each tile is then RRC'd as it is cut --
    or already corrected.  Device ``d`` takes tiles ``tile_blocks(T,
    N)[d]`` (section-major, slice-minor), cut from the shards that hold
    their rows.  -> (dx, dy, rs), each (T, 4), on the mesh's first
    device."""
    mesh = pan.mesh
    first = mesh.devices[0]
    outs = []
    for (t0, t1), dev in zip(
            tile_blocks(geom.n_sections * geom.slices, len(mesh)),
            mesh.devices):
        pan_tiles, band_tiles = [], []
        for sec in range(t0 // geom.slices, -(-t1 // geom.slices)):
            i0 = max(t0 - sec * geom.slices, 0)
            i1 = min(t1 - sec * geom.slices, geom.slices)
            c0, c1 = i0 * geom.cols, i1 * geom.cols
            r0 = geom.row0(sec)
            pan_blk = pan.rows_on(r0, r0 + geom.corr_rows, dev, (c0, c1))
            band_blk = mss.rows_on(r0 // MSS_BANDS,
                                   r0 // MSS_BANDS + geom.brows, dev,
                                   (c0 // MSS_BANDS, c1 // MSS_BANDS))
            pp = mp = None
            if params is not None:
                pk, pb, mk, mb = params[dev]
                pp = (pk[c0:c1], pb[c0:c1])
                mp = (mk[:, c0 // MSS_BANDS:c1 // MSS_BANDS],
                      mb[:, c0 // MSS_BANDS:c1 // MSS_BANDS])
            pan_tiles.append(_section_tiles(
                pan_blk, pp, 0, geom.corr_rows, geom.cols, i1 - i0))
            band_tiles.append(_section_tiles(
                band_blk, mp, 0, geom.brows, geom.bcols, i1 - i0))
        if pan_tiles:
            outs.append([t.to(first) for t in correlate_tiles(
                geom, pan_tiles, band_tiles, win)])
    return tuple(torch.cat([o[k] for o in outs]) for k in range(3))


def stt_sharded(pan1: LineSharded, pan2: LineSharded, sections: int = 10,
                line_per_section: int | None = None, overlap_cols: int = 200,
                edge_cols: int = 0, threshold: float = 0.4,
                max_delta_y: float = 0.0, win=(64, 64)):
    """``device_pipeline.stt_estimate_fast`` on line-sharded strips: the
    overlap windows of a contiguous block of sections on each device, the
    peaks gathered to the first device and averaged there.  -> (delta_x,
    delta_y, response, n_valid) 0-d tensors."""
    mesh = pan1.mesh
    first = mesh.devices[0]
    width = pan1.shape[1]
    lps, offs = stt_geometry(pan1.rows, sections, line_per_section)
    ow = overlap_cols - edge_cols
    c1 = width - overlap_cols
    outs = []
    for (s0, s1), dev in zip(tile_blocks(sections, len(mesh)),
                             mesh.devices):
        if s0 == s1:
            continue
        t1, t2 = (torch.stack([strip.rows_on(o, o + lps, dev, cols)
                               for o in offs[s0:s1]]).to(torch.float32)
                  for strip, cols in ((pan1, (c1, c1 + ow)),
                                      (pan2, (edge_cols, edge_cols + ow))))
        outs.append([t.to(first) for t in stt_peaks(t1, t2, win)])
    peaks = (torch.cat([o[k] for o in outs]) for k in range(3))
    return stt_average(*peaks, threshold, max_delta_y)


class ShardedScene:
    """:class:`~..models.device_pipeline.ScenePipeline` over a line mesh:
    the same :meth:`estimate`, :meth:`transform` and :meth:`forward` on
    line-sharded strips (``pan1`` / ``pan2`` (L, W) on axis 0, ``mss`` (4,
    L/4, W/4) on axis 1, MSS shard ``i`` holding PAN shard ``i``'s rows /
    4, as :func:`~.sharded.shard_bounds` cuts them); the rasters come back
    line-sharded the same way."""

    def __init__(self, pipe: ScenePipeline, mesh: LineMesh):
        self.pipe = pipe
        self.mesh = mesh
        self.pipes = _per_device(pipe, mesh)

    def _shard(self, pan1, pan2, mss):
        m = self.mesh
        pan1 = as_line_sharded(m, pan1, 0, MSS_BANDS)
        pan2 = as_line_sharded(m, pan2, 0, MSS_BANDS)
        mss = as_line_sharded(m, mss, 1)
        for i in range(len(m)):
            a, b = pan1.bounds(i)
            if pan2.bounds(i) != (a, b) or mss.bounds(i) != (
                    a // MSS_BANDS, b // MSS_BANDS):
                raise ValueError(
                    "the PAN shards and the MSS shards do not line up "
                    f"(shard {i}: PAN {pan1.bounds(i)} / {pan2.bounds(i)}, "
                    f"MSS {mss.bounds(i)})")
        return pan1, pan2, mss

    def estimate(self, pan1, pan2, mss):
        """-> (cx (4, 2), cy (4, 3), n_valid (4,), raw_dx, raw_dy, n_stt)
        on the mesh's first device."""
        pan1, pan2, mss = self._shard(pan1, pan2, mss)
        p = self.pipe
        geom = register_geometry(pan1.rows, pan1.shape[1], p.slices,
                                 p.n_sections)
        params = {dev: (q.pan1_k, q.pan1_b, q.mss_k, q.mss_b)
                  for dev, q in self.pipes.items()}
        stats = correlate_sharded(geom, pan1, mss, params)
        coeffs, n_valid = fit_tiles(geom, *stats, p.threshold)
        raw_dx, raw_dy, _resp, n_stt = stt_sharded(
            pan1, pan2, overlap_cols=p.overlap_cols, **p.stt_kw)
        cx = torch.stack([c[0] for c in coeffs])
        cy = torch.stack([c[1] for c in coeffs])
        return cx, cy, n_valid, raw_dx, raw_dy, n_stt

    def transform(self, pan1, pan2, mss, cx, cy, raw_dx, raw_dy):
        """-> (aligned (L/4, W/4, 4), stitched (L, 2*(W - fold))[, prestt
        (L, W)]) line-sharded on axis 0."""
        pan1, pan2, mss = self._shard(pan1, pan2, mss)
        p = self.pipe
        raw_dx, raw_dy = float(raw_dx), float(raw_dy)
        halo_p = p.prestt_row_bound + 2
        halo_b = p.row_bound + 2
        outs = []
        for i, dev in enumerate(self.mesh.devices):
            (p1, top), (p2, _) = pan1.window(i, halo_p, halo_p), \
                pan2.window(i, halo_p, halo_p)
            bands, top_b = mss.window(i, halo_b, halo_b)
            a, b = pan1.bounds(i)
            ab, bb = mss.bounds(i)
            if a == b:
                outs.append(self._empty(dev, pan1.shape[1], bands.shape[-1]))
                continue
            res = self.pipes[dev].transform(p1, p2, bands, cx.to(dev),
                                            cy.to(dev), raw_dx, raw_dy)
            outs.append([res[0][top_b:top_b + bb - ab],
                         *(t[top:top + b - a] for t in res[1:])])
        return tuple(LineSharded(self.mesh, [o[k] for o in outs], 0)
                     for k in range(len(outs[0])))

    def _empty(self, dev, width, band_px):
        u16 = torch.uint16
        fold = self.pipe.fold
        out = [torch.empty((0, band_px, MSS_BANDS), dtype=u16, device=dev),
               torch.empty((0, 2 * (width - fold)), dtype=u16, device=dev)]
        if self.pipe.return_prestt:
            out.append(torch.empty((0, width), dtype=u16, device=dev))
        return out

    def forward(self, pan1, pan2, mss):
        """Estimate then transform: -> (aligned, stitched[, prestt],
        n_valid, n_stt, params), as ``ScenePipeline.forward``."""
        pan1, pan2, mss = self._shard(pan1, pan2, mss)
        cx, cy, n_valid, raw_dx, raw_dy, n_stt = self.estimate(
            pan1, pan2, mss)
        outs = self.transform(pan1, pan2, mss, cx, cy, raw_dx, raw_dy)
        dxs, dys = self.pipe.clamp_stt(raw_dx, raw_dy)
        return (*outs, n_valid, n_stt, (cx, cy, dxs, dys, raw_dx, raw_dy))

    __call__ = forward


class ShardedMssAlign:
    """:class:`~..models.device_pipeline.MssAlign` over a line mesh: RRC of
    the line-sharded bands (kernel (a)), the registration against the
    line-sharded corrected PAN (:func:`correlate_sharded`), and each
    shard's alignment resample with its neighbours' halo rows
    (``MssAlign.remap``, kernel (c) at row bound 6)."""

    def __init__(self, align: MssAlign, mesh: LineMesh):
        self.align = align
        self.mesh = mesh
        self.aligns = _per_device(align, mesh)

    def remap(self, mss_c: LineSharded, cx, cy) -> LineSharded:
        halo = self.align.row_bound + 2
        out = []
        for i, ((win, top), dev) in enumerate(
                zip(clipped_halo(mss_c, halo, halo), self.mesh.devices)):
            a, b = mss_c.bounds(i)
            if a == b:
                out.append(torch.empty((0, win.shape[-1], MSS_BANDS),
                                       dtype=torch.uint16, device=dev))
                continue
            res = self.aligns[dev].remap(win, cx.to(dev), cy.to(dev))
            out.append(res[top:top + b - a])
        return LineSharded(self.mesh, out, 0)

    def forward(self, pan_c, mss):
        """``pan_c`` (L, W) corrected PAN, ``mss`` (4, L/4, W/4) RAW
        bands, line-sharded (or to ingest) -> (aligned (L/4, W/4, 4)
        line-sharded, n_valid (4,), (cx (4, 2), cy (4, 3)))."""
        pan_c = as_line_sharded(self.mesh, pan_c, 0, MSS_BANDS)
        mss = as_line_sharded(self.mesh, mss, 1)
        mss_c = mss.map(lambda t, dev: rrc_apply(
            t, self.aligns[dev].mss_k, self.aligns[dev].mss_b))
        al = self.align
        geom = register_geometry(pan_c.rows, pan_c.shape[1], al.slices,
                                 al.n_sections)
        stats = correlate_sharded(geom, pan_c, mss_c)
        coeffs, n_valid = fit_tiles(geom, *stats, al.threshold)
        cx = torch.stack([c[0] for c in coeffs])
        cy = torch.stack([c[1] for c in coeffs])
        return self.remap(mss_c, cx, cy), n_valid, (cx, cy)

    __call__ = forward

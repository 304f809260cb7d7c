"""The scene over the line mesh (``scene --mesh N``).

Counterpart of ``opticalimageprocessor_tpu/parallel/sharded_scene.py``,
with the port's single-device modules doing the per-device work:

* estimate: the resident route's own (``ScenePipeline.estimate_rows``,
  ``MssAlign.register``) with the line-sharded strips as its row source:
  the registration tiles and the stt windows are spread over the devices
  in contiguous blocks (JAX's tile axis), cut from the shards that hold
  their rows, and each device's statistics are gathered in tile order to
  the first device of every process (:func:`_gather_to_first`) and fitted
  or averaged there, so the estimates are replicated;
* transform: every shard, with its neighbours' halo rows copied onto its
  device, goes through ``ScenePipeline.transform`` (kernels (a), (c) at
  row bound 3, (d)) or ``MssAlign.remap`` (kernel (c) at row bound 6), and
  keeps its own rows.

On a mesh spanning processes each process runs its own shards and its
own blocks of tiles: the tile rows and halo windows come through
``LineSharded.fetch``, the statistics through ``distributed.
all_gather_list`` (host copies, bit for bit).

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
import functools

import torch

from ..constants import MSS_BANDS
from ..models.device_pipeline import MssAlign, ScenePipeline
from ..ops.rrc import rrc_apply
from ..utils.logging import to_host
from .distributed import all_gather_list
from .halo import clipped_halo
from .mesh import LineMesh, LineSharded
from .sharded import as_line_sharded


def _per_device(module, mesh: LineMesh) -> dict:
    """A copy of ``module`` on each distinct device of this process."""
    return {dev: copy.deepcopy(module).to(dev) for dev in mesh.distinct()}


def _gather_to_first(mesh: LineMesh, outs: list) -> tuple:
    """Per-block tuples of (n,) statistics -> the tuple of their
    concatenations in block order on this process's first device: moved
    there directly in one process, all-gathered through host copies
    across processes."""
    first = mesh.first
    if mesh.spans_processes:
        outs = all_gather_list(mesh, [[t.cpu() for t in o] for o in outs])
    return tuple(torch.cat([o[k].to(first) for o in outs])
                 for k in range(len(outs[0])))


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
        self._gather = functools.partial(_gather_to_first, mesh)

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
        on this process's first device (every process's)."""
        pan1, pan2, mss = self._shard(pan1, pan2, mss)
        return self.pipe.estimate_rows(pan1, pan2, mss, self.mesh.devices,
                                       self._gather, self.pipes)

    def transform(self, pan1, pan2, mss, cx, cy, raw_dx, raw_dy):
        """-> (aligned (L/4, W/4, 4), stitched (L, 2*(W - fold))[, prestt
        (L, W)]) line-sharded on axis 0."""
        pan1, pan2, mss = self._shard(pan1, pan2, mss)
        p = self.pipe
        raw_dx, raw_dy = float(to_host(raw_dx)), float(to_host(raw_dy))
        halo_p = p.prestt_row_bound + 2
        halo_b = p.row_bound + 2
        n_out = 3 if p.return_prestt else 2
        outs = []
        windows = (pan1.windows(halo_p, halo_p), pan2.windows(halo_p, halo_p),
                   mss.windows(halo_b, halo_b))
        for i, dev in enumerate(self.mesh.devices):
            # one shard's windows alive at a time (next(), not a zip,
            # which would keep an earlier shard's in its result tuple)
            (p1, top), (p2, _), (bands, top_b) = (next(w) for w in windows)
            a, b = pan1.bounds(i)
            ab, bb = mss.bounds(i)
            if dev is None:
                outs.append([None] * n_out)
                continue
            if a == b:
                outs.append(self._empty(dev, pan1.shape[1], bands.shape[-1]))
                continue
            res = self.pipes[dev].transform(p1, p2, bands, cx.to(dev),
                                            cy.to(dev), raw_dx, raw_dy)
            outs.append([res[0][top_b:top_b + bb - ab],
                         *(t[top:top + b - a] for t in res[1:])])
        return tuple(LineSharded(self.mesh, [o[k] for o in outs], 0,
                                 mss.edges if k == 0 else pan1.edges)
                     for k in range(n_out))

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
    line-sharded corrected PAN (:meth:`MssAlign.register` on the shards),
    and each
    shard's alignment resample with its neighbours' halo rows
    (``MssAlign.remap``, kernel (c) at row bound 6)."""

    def __init__(self, align: MssAlign, mesh: LineMesh):
        self.align = align
        self.mesh = mesh
        self.aligns = _per_device(align, mesh)
        self._gather = functools.partial(_gather_to_first, mesh)

    def remap(self, mss_c: LineSharded, cx, cy) -> LineSharded:
        halo = self.align.row_bound + 2
        out = []
        for i, ((win, top), dev) in enumerate(
                zip(clipped_halo(mss_c, halo, halo), self.mesh.devices)):
            a, b = mss_c.bounds(i)
            if dev is None:
                out.append(None)
                continue
            if a == b:
                out.append(torch.empty((0, win.shape[-1], MSS_BANDS),
                                       dtype=torch.uint16, device=dev))
                continue
            res = self.aligns[dev].remap(win, cx.to(dev), cy.to(dev))
            out.append(res[top:top + b - a])
        return LineSharded(self.mesh, out, 0, mss_c.edges)

    def forward(self, pan_c, mss):
        """``pan_c`` (L, W) corrected PAN, ``mss`` (4, L/4, W/4) RAW
        bands, line-sharded (or to ingest) -> (aligned (L/4, W/4, 4)
        line-sharded, n_valid (4,), (cx (4, 2), cy (4, 3)))."""
        pan_c = as_line_sharded(self.mesh, pan_c, 0, MSS_BANDS)
        mss = as_line_sharded(self.mesh, mss, 1)
        mss_c = mss.map(lambda t, dev: rrc_apply(
            t, self.aligns[dev].mss_k, self.aligns[dev].mss_b))
        cx, cy, n_valid = self.align.register(pan_c, mss_c, self.mesh.devices,
                                              self._gather)
        return self.remap(mss_c, cx, cy), n_valid, (cx, cy)

    __call__ = forward

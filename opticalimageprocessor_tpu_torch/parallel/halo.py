"""Halo exchange over the line mesh.

Counterpart of ``opticalimageprocessor_tpu/parallel/halo.py``.  A cubic
resample needs a few rows beyond each shard (kernel support plus the
fitted dy range).  JAX sends each device's edge rows to its neighbours
with ``ppermute`` and pads the strip ends with the border value 0; here
each shard's neighbour rows are copied onto its device
(:meth:`~.mesh.LineSharded.fetch`, one collective when the mesh spans
processes).  Rows may come from any shard, so a halo deeper than a
neighbour's rows (uneven or empty shards) still reads the true rows.
"""

from __future__ import annotations

import torch

from .mesh import LineSharded


def exchange_halo(x: LineSharded, top: int, bottom: int
                  ) -> list[torch.Tensor | None]:
    """Each shard of ``x`` extended with ``top`` rows before it and
    ``bottom`` rows after it, on its own device; zeros beyond the strip
    ends (JAX's ``exchange_halo``); None for another process's shards."""
    return list(x.fetch([(i, a - top, b + bottom, None)
                         for i, (a, b) in enumerate(map(
                             x.bounds, range(len(x.shards))))]))


def clipped_halo(x: LineSharded, top: int, bottom: int
                 ) -> list[tuple[torch.Tensor, int]]:
    """The clipped form: each shard with up to ``top`` / ``bottom``
    neighbour rows and no rows beyond the strip ends, as the streamed
    route cuts its sections (``models/scene_stream``).  A resample that
    reads 0 past the edges of its input then sees border 0 at a strip end
    *after* the RRC -- never the RRC of a zero fill, which is its bias.
    -> ``[(rows, top rows present), ...]``, ``(None, top)`` for another
    process's shards."""
    return list(x.windows(top, bottom))

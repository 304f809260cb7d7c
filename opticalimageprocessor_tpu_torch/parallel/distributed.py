"""The multi-process launch variables, and the line mesh's offset-write
drains in their single-process form.

Counterpart of ``opticalimageprocessor_tpu/parallel/distributed.py``.  The
JAX CLI reads the ``OIP_DIST_*`` launch variables before any work: a
partial set aborts the run, a complete one joins ``jax.distributed``.  The
port runs one process (its mesh is one process driving N devices), so
:func:`check_distributed_env` keeps the JAX checks and refuses a complete
set: N processes launched with it would each run the whole job and race on
the same output files.

The drains write a line-sharded raster shard by shard at the rows' byte
offsets (the host holds one block of a shard at a time): RAW, an
uncompressed strip TIFF (header, zeroed raster and IFD first, byte for byte
the sequential writer's file).  The LZW drain, barriers and multi-host
writes come with the multi-process launch.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import LineMesh, LineSharded

_ENV_COORD = "OIP_DIST_COORD"
_ENV_NPROCS = "OIP_DIST_NPROCS"
_ENV_PROCID = "OIP_DIST_PROCID"

_WRITE_ROWS = 4096   # host rows a drain copies from the device at a time


def distributed_env_present() -> bool:
    """True iff the launch env requests multi-process operation."""
    return bool(os.environ.get(_ENV_COORD))


def check_distributed_env() -> None:
    """The env checks of JAX's ``maybe_initialize_distributed``, run before
    any work.  No-op when ``OIP_DIST_COORD`` is unset.  A partial set
    (``OIP_DIST_NPROCS`` or ``OIP_DIST_PROCID`` missing, or the id outside
    ``[0, NPROCS)``) raises JAX's message, which names the variable; a
    complete one raises that the multi-process launch is not ported."""
    if not distributed_env_present():
        return
    try:
        nprocs = int(os.environ[_ENV_NPROCS])
        procid = int(os.environ[_ENV_PROCID])
    except KeyError as e:
        raise RuntimeError(
            f"{_ENV_COORD} is set but {e.args[0]} is missing: the "
            "distributed launch env needs all of "
            f"{_ENV_COORD}/{_ENV_NPROCS}/{_ENV_PROCID}"
        ) from None
    if not (0 <= procid < nprocs):
        raise RuntimeError(
            f"{_ENV_PROCID}={procid} outside [0, {_ENV_NPROCS}={nprocs})"
        )
    raise RuntimeError(
        "the multi-process launch is not ported to the PyTorch package yet "
        "(ROADMAP.md, slice 11): unset the OIP_DIST_* variables and run one "
        "process, with --mesh N for N devices"
    )


def _sharded(arr) -> LineSharded:
    """A line-sharded raster, or a tensor / host array as one shard."""
    if isinstance(arr, LineSharded):
        return arr
    t = torch.as_tensor(np.asarray(arr)) if not isinstance(
        arr, torch.Tensor) else arr
    return LineSharded(LineMesh([t.device]), [t], 0)


def drain_line_sharded_to_raw(arr, path: str, pixels_per_line: int,
                              total: int | None = None) -> str:
    """Write rows ``[0, total)`` of a line-sharded (rows, W) uint16 raster
    to one RAW file, each shard's rows at their offset."""
    arr = _sharded(arr)
    total = arr.rows if total is None else total
    if arr.shape[1] != pixels_per_line:
        raise ValueError(
            f"raster width {arr.shape[1]} != {pixels_per_line} pixels a line")
    row_bytes = pixels_per_line * 2
    with open(path, "wb") as f:
        f.truncate(total * row_bytes)
        for r, blk in arr.host_blocks(0, total, _WRITE_ROWS):
            f.seek(r * row_bytes)
            f.write(np.ascontiguousarray(blk, dtype="<u2").tobytes())
    return path


def drain_line_sharded_to_tiff(
    arr,
    path: str,
    total: int | None = None,
    order: list[int] | None = None,
    rows_per_strip: int = 512,
    photometric: int | None = None,
    extrasamples: int | None = None,
    row0: int = 0,
) -> str:
    """Write rows ``[row0, total)`` of a line-sharded (rows, W) or (rows,
    W, S) uint16 raster to one uncompressed strip TIFF: the complete file
    shell first (``io.tiff.create_tiff_shell``), then each shard's rows at
    their byte offsets (uncompressed rows are affine in the row index).
    ``order`` permutes the sample axis (the BGRA channel convention)."""
    from ..io.tiff import create_tiff_shell

    arr = _sharded(arr)
    total = arr.rows if total is None else total
    width = arr.shape[1]
    samples = arr.shape[2] if len(arr.shape) == 3 else 1
    row_bytes = width * samples * 2
    data_start = create_tiff_shell(
        path, width, total - row0, samples, rows_per_strip=rows_per_strip,
        photometric=photometric, extrasamples=extrasamples,
    )
    with open(path, "r+b") as f:
        for r, blk in arr.host_blocks(row0, total, _WRITE_ROWS):
            if order is not None:
                blk = blk[..., order]
            f.seek(data_start + (r - row0) * row_bytes)
            f.write(np.ascontiguousarray(blk, dtype="<u2").tobytes())
    return path

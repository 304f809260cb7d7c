"""The multi-process launch: the ``OIP_DIST_*`` variables, the process
group, the cross-process row fetches of a line mesh that spans processes,
and the line mesh's offset-write drains.

Counterpart of ``opticalimageprocessor_tpu/parallel/distributed.py``.  The
CLI calls :func:`maybe_initialize_distributed` before any work: a partial
``OIP_DIST_*`` set aborts the run, a complete one joins a
``torch.distributed`` process group (one process per host, or several on
one host).  ``--mesh N`` then spans the processes
(``parallel/mesh.line_mesh``): each process ingests, computes and drains
only its own shards.

Launch (one process each, ``k`` in ``[0, P)``)::

    OIP_DIST_COORD=host0:9876 OIP_DIST_NPROCS=P OIP_DIST_PROCID=k \\
        [OIP_DIST_LOCAL_DEVICE_IDS=0,1] \\
        python -m opticalimageprocessor_tpu_torch.cli scene --mesh N ...

Transport (the choice is logged once a process):

* a gloo group always exists, the default group: it carries the
  barriers, small objects (tile statistics, card UUIDs) and CPU tensors;
* a NCCL group is added only when the mesh is CUDA and no two processes
  claim the same card (the cards' UUIDs are all-gathered over gloo);
  CUDA rows then cross processes over NCCL;
* where processes share a card, CUDA rows cross through pinned host
  copies over gloo (NCCL refuses two ranks on one GPU);
* a NCCL group that fails to come up raises: it never gives way to gloo.

The drains write a line-sharded raster at the rows' byte offsets, each
process its own shards (the host holds one block of a shard at a time):
RAW, an uncompressed strip TIFF (header, zeroed raster and IFD first, byte
for byte the sequential writer's file), and an LZW strip TIFF (each
process encodes the strips that start in its rows, process 0 assembles).
Under several processes, process 0 creates each file and barriers order
create -> write -> return.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from ..utils.logging import olog
from .mesh import LineMesh, LineSharded

_ENV_COORD = "OIP_DIST_COORD"
_ENV_NPROCS = "OIP_DIST_NPROCS"
_ENV_PROCID = "OIP_DIST_PROCID"
_ENV_LOCAL_IDS = "OIP_DIST_LOCAL_DEVICE_IDS"

# seconds a process waits for its peers at the join, a barrier or a
# transfer (JAX's initialization_timeout default): a dead process makes
# the others fail within it instead of hanging
_DEFAULT_TIMEOUT_S = 300.0

_WRITE_ROWS = 4096   # host rows a drain copies from the device at a time


class _Launch:
    """This process's part of the launch: the claimed cards, the NCCL
    group once made, the transports already logged."""

    def __init__(self, local_ids: list[int] | None):
        self.local_ids = local_ids
        self.nccl = None
        self.logged: set[str] = set()


_launch: _Launch | None = None


def distributed_env_present() -> bool:
    """True iff the launch env requests multi-process operation."""
    return bool(os.environ.get(_ENV_COORD))


def maybe_initialize_distributed() -> bool:
    """Join the process group from the ``OIP_DIST_*`` env vars.

    Runs before any work; a no-op (False) when ``OIP_DIST_COORD`` is
    unset.  Idempotent within a process.  A partial set
    (``OIP_DIST_NPROCS`` or ``OIP_DIST_PROCID`` missing, or the id outside
    ``[0, NPROCS)``) raises JAX's message, which names the variable.

    Env contract:
      - ``OIP_DIST_COORD``  -- ``host:port`` of process 0's store
      - ``OIP_DIST_NPROCS`` -- total number of processes
      - ``OIP_DIST_PROCID`` -- this process's id in ``[0, NPROCS)``
      - ``OIP_DIST_LOCAL_DEVICE_IDS`` -- optional comma-separated CUDA
        indices this process claims (default: every visible card)

    A peer that has not joined within the timeout (300 s) fails the join,
    naming the coordinator.
    """
    global _launch
    if not distributed_env_present():
        return False
    if _launch is not None:
        return True
    import torch.distributed as dist

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
    ids = os.environ.get(_ENV_LOCAL_IDS)
    local_ids = [int(x) for x in ids.split(",")] if ids else None
    coord, timeout = os.environ[_ENV_COORD], _DEFAULT_TIMEOUT_S
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}", world_size=nprocs,
            rank=procid, timeout=datetime.timedelta(seconds=timeout),
        )
    except RuntimeError as e:
        raise RuntimeError(
            f"process {procid} of {nprocs} could not join the process group "
            f"at {coord} within {timeout:g} s: {e}") from e
    _launch = _Launch(local_ids)
    olog("Process %d of %d joined the process group at %s (gloo, %g s "
         "timeout).", procid, nprocs, coord, timeout)
    return True


def process_count() -> int:
    return torch.distributed.get_world_size() if _launch is not None else 1


def process_index() -> int:
    return torch.distributed.get_rank() if _launch is not None else 0


def is_primary() -> bool:
    """True on the process that does the host-side singleton work
    (creating the shared output files, assembling the LZW TIFF)."""
    return process_index() == 0


def barrier(name: str = "oip_barrier") -> None:
    """Cross-process sync point on the gloo group; a peer that does not
    arrive within the group's timeout (or has died) raises, naming the
    barrier."""
    if process_count() == 1:
        return
    try:
        torch.distributed.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier '{name}' failed: {e}") from e


def claimed_cuda_devices() -> list[int]:
    """The CUDA indices this process claims: ``OIP_DIST_LOCAL_DEVICE_IDS``
    under a launch that sets it, else every visible card."""
    have = torch.cuda.device_count()
    ids = _launch.local_ids if _launch is not None else None
    if ids is None:
        return list(range(have))
    bad = [i for i in ids if not 0 <= i < have]
    if bad:
        raise RuntimeError(
            f"{_ENV_LOCAL_IDS} names card(s) {bad}, only {have} visible")
    return ids


def _log_transport(kind: str, what: str) -> None:
    if kind not in _launch.logged:
        _launch.logged.add(kind)
        olog("Line mesh over %d processes: rows cross processes %s.",
             process_count(), what)


def cpu_transport() -> str:
    """The transport of a CPU mesh spanning processes: gloo."""
    _log_transport("gloo", "as CPU tensors over gloo")
    return "gloo"


def cuda_transport(mine: list[torch.device], per: int) -> tuple[str, int]:
    """The transport of a CUDA mesh spanning processes, agreed by a
    collective: every process all-gathers the UUIDs of the cards its
    ``per`` shards use (``mine``).  -> (``"nccl"`` when no two processes
    share a card, else ``"gloo"``; the usable cards of all processes).
    When some process has fewer than ``per`` cards nothing more is done:
    the caller raises, on every process alike."""
    import torch.distributed as dist

    uuids = [str(torch.cuda.get_device_properties(d).uuid) for d in mine]
    every: list = [None] * process_count()
    dist.all_gather_object(every, uuids)
    have = sum(min(len(u), per) for u in every)
    if any(len(u) < per for u in every):
        return "none", have
    flat = [u for us in every for u in us]
    if len(set(flat)) < len(flat):
        _log_transport("gloo-staged", "through pinned host copies over gloo "
                       "(processes share a card; NCCL refuses two ranks on "
                       "one GPU)")
        return "gloo", have
    if _launch.nccl is None:
        torch.cuda.set_device(mine[0])
        _launch.nccl = dist.new_group(backend="nccl")
        # NCCL makes a group's communicator at its first call, and a
        # point-to-point batch that leaves some processes out must not be
        # that call: make it now, every process alike
        dist.all_reduce(torch.zeros(1, device=mine[0]), group=_launch.nccl)
        torch.cuda.synchronize(mine[0])
    _log_transport("nccl", "over NCCL")
    return "nccl", have


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 tensor (a view): the
    transport moves bytes, whatever the dtype."""
    return t.reshape(-1).view(torch.uint8)


def _process_rows(x: LineSharded) -> dict[int, tuple[int, int]]:
    """The contiguous rows ``[lo, hi)`` each process holds."""
    spans: dict[int, tuple[int, int]] = {}
    for i, o in enumerate(x.mesh.owners):
        a, b = x.bounds(i)
        lo, hi = spans.get(o, (a, b))
        spans[o] = (min(lo, a), max(hi, b))
    return spans


def fetch(x: LineSharded, plan, device=None) -> list[torch.Tensor | None]:
    """:meth:`LineSharded.fetch` on a mesh spanning processes: one
    collective that every process calls with the same plan of
    ``(destination shard, a, b, cols)`` entries, derived from geometry all
    processes share.  For each entry, each process that holds some of rows
    ``[a, b)`` sends them (one message a process, tagged with the entry's
    index) to the destination's process, which receives them in process
    order; entries, then processes, are posted in one deterministic order.
    Rows on both ends in this process are copied directly.  -> the rows of
    the entries whose destination this process holds (zeros outside the
    raster), None for the others."""
    import torch.distributed as dist

    mesh = x.mesh
    me = mesh.rank
    nccl = mesh.transport == "nccl"
    group = _launch.nccl if nccl else None
    # CUDA rows over gloo go through pinned host copies
    staged = mesh.first.type == "cuda" and not nccl
    spans = _process_rows(x)
    ops, entries = [], []
    for k, (d, a, b, cols) in enumerate(plan):
        dst = mesh.owners[d]
        dev = None
        if dst == me:
            dev = torch.device(device) if device is not None \
                else mesh.devices[d]
        pieces = []
        for r, (plo, phi) in sorted(spans.items()):
            lo, hi = max(a, plo), min(b, phi)
            if lo >= hi or (r != me and dst != me):
                continue
            if r == me and dst == me:
                pieces.append(x.rows_on(lo, hi, dev, cols))
            elif r == me:
                blk = x.rows_on(lo, hi, mesh.first, cols)
                if staged:
                    host = torch.empty(blk.shape, dtype=blk.dtype,
                                       pin_memory=True)
                    blk = host.copy_(blk)
                ops.append(dist.P2POp(dist.isend, _bytes(blk.contiguous()),
                                      dst, group=group, tag=k))
            else:
                # NCCL receives on the shard's card, gloo on the host
                buf = torch.empty(
                    x.piece_shape(hi - lo, cols), dtype=x.dtype,
                    device=mesh.devices[d] if nccl else "cpu",
                    pin_memory=staged and dev.type == "cuda")
                ops.append(dist.P2POp(dist.irecv, _bytes(buf), r,
                                      group=group, tag=k))
                pieces.append(buf)
        entries.append((dev, a, b, cols, pieces))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    out = []
    for dev, a, b, cols, pieces in entries:
        if dev is None:
            out.append(None)
            continue
        parts = [p.to(dev) for p in pieces]
        if a < 0:
            parts.insert(0, x.zeros(min(b, 0) - a, dev, cols))
        if b > x.rows:
            parts.append(x.zeros(b - max(a, x.rows), dev, cols))
        if not parts:
            parts = [x.zeros(0, dev, cols)]
        out.append(parts[0] if len(parts) == 1
                   else torch.cat(parts, dim=x.axis))
    return out


def all_gather_list(mesh: LineMesh, items: list) -> list:
    """Every process's ``items`` (host objects: CPU tensors, arrays),
    concatenated in process order -- tile order, since the processes hold
    ascending shards and compute contiguous blocks of tiles.  The items
    travel pickled, bit for bit.  A mesh in one process: ``items``."""
    if not mesh.spans_processes:
        return list(items)
    every: list = [None] * process_count()
    torch.distributed.all_gather_object(every, list(items))
    return [it for part in every for it in part]


def _sharded(arr) -> LineSharded:
    """A line-sharded raster, or a tensor / host array as one shard."""
    if isinstance(arr, LineSharded):
        return arr
    t = torch.as_tensor(np.asarray(arr)) if not isinstance(
        arr, torch.Tensor) else arr
    return LineSharded(LineMesh([t.device]), [t], 0)


def _addressable_row_range(arr: LineSharded) -> tuple[int, int]:
    """The contiguous ``[lo, hi)`` rows of this process's shards (a line
    mesh gives each process one contiguous block of rows; checked, not
    assumed)."""
    spans = sorted(arr.bounds(i) for i, t in enumerate(arr.shards)
                   if t is not None)
    lo, hi = spans[0]
    for a, b in spans[1:]:
        if a != hi:
            raise ValueError(
                f"this process's shards are not row-contiguous: gap at "
                f"{hi}..{a}")
        hi = b
    return lo, hi


def drain_line_sharded_to_raw(arr, path: str, pixels_per_line: int,
                              total: int | None = None) -> str:
    """Write rows ``[0, total)`` of a line-sharded (rows, W) uint16 raster
    to one RAW file, each shard's rows at their offset.  On a mesh
    spanning processes process 0 sizes the file, and after a barrier each
    process writes its own shards' rows."""
    arr = _sharded(arr)
    total = arr.rows if total is None else total
    if arr.shape[1] != pixels_per_line:
        raise ValueError(
            f"raster width {arr.shape[1]} != {pixels_per_line} pixels a line")
    row_bytes = pixels_per_line * 2
    multi = arr.mesh.spans_processes
    if not multi or is_primary():
        with open(path, "wb") as f:
            f.truncate(total * row_bytes)
    if multi:
        barrier("drain-create:" + path)
    lo, hi = _addressable_row_range(arr)
    with open(path, "r+b") as f:
        for r, blk in arr.host_blocks(lo, min(hi, total), _WRITE_ROWS):
            f.seek(r * row_bytes)
            f.write(np.ascontiguousarray(blk, dtype="<u2").tobytes())
    if multi:
        barrier("drain-done:" + path)
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
    shell first (``io.tiff.create_tiff_shell``, by process 0 on a mesh
    spanning processes; the others project its raster offset,
    ``io.tiff.tiff_data_start``), then each shard's rows at their byte
    offsets (uncompressed rows are affine in the row index).  ``order``
    permutes the sample axis (the BGRA channel convention)."""
    from ..io.tiff import create_tiff_shell, tiff_data_start

    arr = _sharded(arr)
    total = arr.rows if total is None else total
    width = arr.shape[1]
    samples = arr.shape[2] if len(arr.shape) == 3 else 1
    row_bytes = width * samples * 2
    multi = arr.mesh.spans_processes
    data_start = tiff_data_start(width, total - row0, samples)
    if not multi or is_primary():
        made = create_tiff_shell(
            path, width, total - row0, samples, rows_per_strip=rows_per_strip,
            photometric=photometric, extrasamples=extrasamples,
        )
        # the other processes write at the projected offset
        if made != data_start:
            raise RuntimeError(
                f"TIFF shell raster at byte {made}, projected {data_start}")
    if multi:
        barrier("tiff-create:" + path)
    lo, hi = _addressable_row_range(arr)
    with open(path, "r+b") as f:
        for r, blk in arr.host_blocks(max(lo, row0), min(hi, total),
                                      _WRITE_ROWS):
            if order is not None:
                blk = blk[..., order]
            f.seek(data_start + (r - row0) * row_bytes)
            f.write(np.ascontiguousarray(blk, dtype="<u2").tobytes())
    if multi:
        barrier("tiff-done:" + path)
    return path


def drain_line_sharded_to_tiff_lzw(
    arr,
    path: str,
    total: int | None = None,
    order: list[int] | None = None,
    rows_per_strip: int = 512,
    row0: int = 0,
    photometric: int | None = None,
    extrasamples: int | None = None,
    predictor: bool = True,
) -> str:
    """Write rows ``[row0, total)`` of a line-sharded raster to one
    LZW(+predictor-2) strip TIFF, the compressed counterpart of
    :func:`drain_line_sharded_to_tiff` (JAX's drain, itself after the
    reference's GDAL LZW / PREDICTOR=2 writer, imageop.h:470-474).

    TIFF strips are compressed independently, so each process LZW-encodes
    the strips whose first raster row it holds (``io.tiff.
    encode_lzw_strip``, the sequential writer's bytes) into a segment file
    beside the output; a strip that straddles a process edge is completed
    with spill rows the next process(es) leave beside the output; then
    process 0 joins the segments and the strip tables into the final file
    (``io.tiff.assemble_tiff_from_strips``): the offsets are known once
    the compressed sizes are.  Byte for byte the sequential
    ``TiffStripWriter``'s file where that writer does not fall back to no
    compression on its first strip (this drain has no such fallback).
    One process runs the same flow without barriers or spills.
    """
    from ..io.tiff import assemble_tiff_from_strips, encode_lzw_strip

    arr = _sharded(arr)
    total = arr.rows if total is None else total
    height = total - row0
    width = arr.shape[1]
    samples = arr.shape[2] if len(arr.shape) == 3 else 1
    rps = rows_per_strip
    n_strips = -(-height // rps)
    multi = arr.mesh.spans_processes
    me, nprocs = (process_index(), process_count()) if multi else (0, 1)

    lo, hi = _addressable_row_range(arr)
    lo_r, hi_r = max(lo, row0), min(hi, total)   # my rows in the raster
    mine = None
    if hi_r > lo_r:
        mine = np.concatenate([blk for _, blk in arr.host_blocks(lo_r, hi_r)])
        # little-endian uint16 is what the strips' uint16 IFD promises
        mine = np.ascontiguousarray(mine, dtype="<u2")
        if mine.ndim == 2:
            mine = mine[:, :, None]
        if order is not None:
            mine = mine[:, :, order]

    # strip k covers raster rows [k*rps, min((k+1)*rps, height)), i.e.
    # array rows [row0 + k*rps, ...); its owner holds its first row
    def strip_of(array_row: int) -> int:
        return (array_row - row0) // rps

    if multi:
        # spill: my leading rows that belong to a strip starting before my
        # range (its owner needs them to complete its last strip)
        np.save(f"{path}.rng.{me}.npy", np.asarray([lo_r, hi_r]))
        spill_rows = 0
        if mine is not None and lo_r > row0 and (lo_r - row0) % rps:
            strip_end = row0 + (strip_of(lo_r) + 1) * rps
            spill_rows = min(strip_end, hi_r) - lo_r
        np.save(
            f"{path}.spill.{me}.npy",
            mine[:spill_rows] if mine is not None
            else np.zeros((0, width, samples), np.uint16),
        )
        barrier("lzw-spill:" + path)
        ranges = [np.load(f"{path}.rng.{p}.npy") for p in range(nprocs)]
        # segments are joined in process order, so the processes must hold
        # ascending rows (else the TIFF decodes with row blocks swapped)
        prev_hi = None
        for p in range(nprocs):
            plo, phi = int(ranges[p][0]), int(ranges[p][1])
            if phi <= plo:
                continue
            if prev_hi is not None and plo < prev_hi:
                raise ValueError(
                    "line-sharded processes are not in ascending raster-"
                    f"row order (process {p} starts at row {plo}, before "
                    f"a previous process's end {prev_hi}); the LZW drain "
                    "requires process index order == row order"
                )
            prev_hi = phi
    else:
        ranges = [np.asarray([lo_r, hi_r])]

    # my strips: first raster row in [lo_r, hi_r), from the first strip
    # boundary at or after lo_r
    k0 = strip_of(lo_r) if mine is not None else n_strips
    if mine is not None and (lo_r - row0) % rps:
        k0 += 1          # the head strip belongs to a previous process
    k1 = strip_of(hi_r - 1) + 1 if mine is not None else k0
    k1 = min(k1, n_strips)

    counts = []
    with open(f"{path}.seg.{me}", "wb") as seg:
        spill_cache: dict[int, np.ndarray] = {}
        for k in range(k0, k1):
            a = row0 + k * rps
            b = min(a + rps, total)
            s, e = max(a, lo_r), min(b, hi_r)
            parts = [mine[s - lo_r:e - lo_r]]
            nxt = e
            p = me + 1
            while nxt < b and p < nprocs:
                # complete a straddling strip with the next process's spill
                plo, phi = int(ranges[p][0]), int(ranges[p][1])
                if phi <= plo:       # the process holds no raster rows
                    p += 1
                    continue
                if p not in spill_cache:
                    spill_cache[p] = np.load(f"{path}.spill.{p}.npy")
                take = spill_cache[p][:min(b, phi) - plo]
                if nxt != plo:
                    raise ValueError(
                        f"strip {k}: expected spill at row {nxt}, "
                        f"process {p} starts at {plo}"
                    )
                parts.append(take)
                nxt = plo + take.shape[0]
                p += 1
            strip = np.concatenate(parts) if len(parts) > 1 else parts[0]
            if strip.shape[0] != b - a:
                raise ValueError(
                    f"strip {k}: assembled {strip.shape[0]} rows, "
                    f"want {b - a}"
                )
            blob = encode_lzw_strip(strip, predictor=predictor)
            counts.append(len(blob))
            seg.write(blob)
    np.save(f"{path}.cnt.{me}.npy", np.asarray(counts, np.int64))
    if multi:
        barrier("lzw-seg:" + path)

    if not multi or is_primary():
        def blobs():
            for p in range(nprocs):
                cnt = np.load(f"{path}.cnt.{p}.npy")
                with open(f"{path}.seg.{p}", "rb") as f:
                    for c in cnt:
                        yield f.read(int(c))

        assemble_tiff_from_strips(
            path, width, height, samples, blobs(),
            rows_per_strip=rps, predictor=predictor,
            photometric=photometric, extrasamples=extrasamples,
        )
        for p in range(nprocs):
            for side in (f"{path}.seg.{p}", f"{path}.cnt.{p}.npy",
                         f"{path}.rng.{p}.npy", f"{path}.spill.{p}.npy"):
                if os.path.exists(side):
                    os.remove(side)
    if multi:
        barrier("lzw-done:" + path)
    return path


def require_single_process_drain(what: str) -> None:
    """Guard for a sequential drain that assumes every shard of a
    line-sharded raster is in this process: under several processes each
    holds only its own shards, so the drain would write a partial raster
    -- it fails loudly instead (JAX's guard)."""
    if process_count() > 1:
        raise NotImplementedError(
            f"{what}: sequential file drain is single-process only; in a "
            f"multi-host run ({process_count()} processes) each process "
            "holds only its own shards -- write through the offset-write "
            "drains of parallel.distributed"
        )

"""The line mesh: an explicit list of devices over the strip's line axis,
and rasters split along that axis, one tensor a device.

Counterpart of ``opticalimageprocessor_tpu/parallel/mesh.py``.  JAX's
``--mesh N`` is one process driving ``jax.devices()[:N]`` through a
``Mesh``; here one process drives a :class:`LineMesh`, a list of
``torch.device`` s, and a line-sharded raster is a :class:`LineSharded`:
shard ``i`` holds a contiguous block of rows on ``mesh.devices[i]``.  What
XLA inserts in a sharded JAX program -- halo rows, tile gathers -- is an
explicit copy between devices here (:meth:`LineSharded.rows_on`).

A device may repeat in the list: ``[cpu] * N`` is the counterpart of JAX's
virtual CPU mesh (the tests), and ``[cuda:0] * N`` runs N shards on one
card.  Device-to-device copies go through ``Tensor.to``, which orders the
copy after the source device's current stream and the destination's
current stream after the copy, so no shard reads a halo before its
neighbour has written it.

Under a multi-process launch (``OIP_DIST_*``, ``parallel/distributed``)
one logical mesh spans the processes: :func:`line_mesh` gives process
``p`` of ``P`` the contiguous shards ``[p N/P, (p+1) N/P)``, and a
:class:`LineSharded` holds tensors for its own shards only (the others
are ``None``).  Every read of rows that may lie in another process --
halo windows, tile blocks, a whole-raster gather -- is one collective,
:meth:`LineSharded.fetch`, that every process calls with the same plan.
"""

from __future__ import annotations

from collections.abc import Iterator, Sequence

import numpy as np
import torch

LINE_AXIS = "line"


class LineMesh:
    """A 1-D mesh over the line axis: shard ``i`` lives on ``devices[i]``.

    All devices are of one type: a CUDA mesh never puts a shard on the
    CPU.  ``owners`` (a mesh spanning processes, :func:`line_mesh`): the
    process index holding each shard, ascending with the shards;
    ``devices[i]`` is ``None`` for a shard another process holds, and
    ``transport`` names how rows cross processes: ``"gloo"`` or
    ``"nccl"`` (``parallel.distributed.cpu_transport`` /
    ``cuda_transport``).  Without ``owners`` every shard is this
    process's (``transport`` ``"local"``)."""

    def __init__(self, devices: Sequence[str | torch.device | None],
                 owners: Sequence[int] | None = None,
                 transport: str = "local"):
        from .distributed import process_index

        self.rank = process_index()
        self.owners = (list(owners) if owners is not None
                       else [self.rank] * len(devices))
        if len(self.owners) != len(devices):
            raise ValueError(
                f"{len(self.owners)} owners for {len(devices)} devices")
        if any(b < a for a, b in zip(self.owners, self.owners[1:])):
            raise ValueError(
                f"shard owners must ascend with the shards, got {self.owners}")
        self.devices = [None if d is None else torch.device(d)
                        for d in devices]
        for i, (d, o) in enumerate(zip(self.devices, self.owners)):
            if (d is not None) != (o == self.rank):
                raise ValueError(
                    f"shard {i}: a device is given exactly for the shards "
                    f"this process ({self.rank}) owns")
        local = [d for d in self.devices if d is not None]
        if not local:
            raise ValueError("a line mesh needs at least one device")
        kinds = {d.type for d in local}
        if len(kinds) != 1:
            raise ValueError(
                f"a line mesh's devices are of one type, got {sorted(kinds)}")
        if local[0].type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device {local[0]} requested but CUDA is not "
                    "available")
            # "cuda" names the current device; tensors moved there carry
            # its index, and shards are checked against their device
            cur = torch.cuda.current_device()
            self.devices = [d if d is None or d.index is not None
                            else torch.device("cuda", cur)
                            for d in self.devices]
        self.transport = transport

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"LineMesh({[str(d) for d in self.devices]})"

    @property
    def spans_processes(self) -> bool:
        """True iff another process holds some of the shards."""
        return any(o != self.rank for o in self.owners)

    def distinct(self) -> list[torch.device]:
        """This process's devices without repeats, in mesh order."""
        return list(dict.fromkeys(d for d in self.devices if d is not None))

    @property
    def first(self) -> torch.device:
        """This process's first device: where replicated estimates live."""
        return self.distinct()[0]


def line_mesh(n_devices: int, device: str | torch.device = "cuda") -> LineMesh:
    """The CLI's ``--mesh N``: ``[cpu] * N`` for the CPU, ``cuda:0`` ...
    ``cuda:N-1`` for CUDA.  Fewer CUDA devices than N raise JAX's message
    (models/scene.py:198-202); there is no smaller mesh.

    Under a launch of ``P`` processes the mesh spans them: process ``p``
    holds shards ``[p N/P, (p+1) N/P)``, on the CPU or on the cards it
    claims (``OIP_DIST_LOCAL_DEVICE_IDS``), in order.  ``N`` must be a
    multiple of ``P``.  Every process must call this at the same point: a
    CUDA mesh agrees its transport with a collective."""
    from .distributed import (
        claimed_cuda_devices,
        cpu_transport,
        cuda_transport,
        process_count,
        process_index,
    )

    dev = torch.device(device)
    if n_devices <= 0:
        raise ValueError(f"mesh must be >= 1 device, got {n_devices}")
    nprocs, me = process_count(), process_index()
    if n_devices % nprocs:
        raise ValueError(
            f"--mesh {n_devices} over {nprocs} processes: the shards must "
            "split evenly over the processes")
    per = n_devices // nprocs
    owners = [i // per for i in range(n_devices)]
    if dev.type == "cpu":
        return LineMesh([dev if o == me else None for o in owners], owners,
                        cpu_transport() if nprocs > 1 else "local")
    if dev.type != "cuda":
        raise ValueError(f"no line mesh over {dev.type} devices")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    mine = [torch.device("cuda", i) for i in claimed_cuda_devices()[:per]]
    if nprocs > 1:
        # every process learns every process's cards before any raises
        transport, have = cuda_transport(mine, per)
    else:
        transport, have = "local", len(claimed_cuda_devices())
    if have < n_devices:
        raise RuntimeError(
            f"--mesh {n_devices} needs {n_devices} devices, only {have} "
            "available")
    it = iter(mine)
    return LineMesh([next(it) if o == me else None for o in owners], owners,
                    transport)


def resolve_mesh(mesh: int | LineMesh, device="cuda") -> LineMesh | None:
    """A route's ``mesh`` argument: ``0`` (the single-device route) ->
    None, ``N`` -> :func:`line_mesh`, a :class:`LineMesh` as it is.
    Negative counts raise JAX's message (models/scene.py:188-189)."""
    if isinstance(mesh, LineMesh):
        return mesh
    if mesh < 0:
        raise ValueError(f"mesh must be >= 0, got {mesh}")
    return line_mesh(mesh, device) if mesh else None


def pad_to_multiple(rows: int, n: int) -> int:
    return (rows + n - 1) // n * n


class LineSharded:
    """A raster split along its line axis (dimension ``axis``) over a
    :class:`LineMesh`: ``shards[i]`` holds rows ``bounds(i)`` on
    ``mesh.devices[i]``.  Shards may be uneven or empty; no row is padding.

    On a mesh spanning processes ``shards[i]`` is ``None`` for a shard
    another process holds, and ``edges`` (the shards' first rows, then the
    row count) must be given: every process knows every shard's rows."""

    def __init__(self, mesh: LineMesh, shards: Sequence[torch.Tensor | None],
                 axis: int = 0, edges: Sequence[int] | None = None):
        if len(shards) != len(mesh):
            raise ValueError(
                f"{len(shards)} shards for a {len(mesh)}-device mesh")
        held = [t for t in shards if t is not None]
        ref = held[0]
        for t, d in zip(shards, mesh.devices):
            if (t is None) != (d is None):
                raise ValueError("a shard is held exactly where its process "
                                 "owns it")
            if t is None:
                continue
            if t.device != d:
                raise ValueError(f"a shard on {t.device}, its device is {d}")
            if t.dim() != ref.dim() or t.dtype != ref.dtype or any(
                t.shape[k] != ref.shape[k] for k in range(t.dim()) if k != axis
            ):
                raise ValueError("shards differ beyond the line axis")
        if edges is None:
            if len(held) != len(shards):
                raise ValueError("the row edges of shards another process "
                                 "holds must be given")
            edges = [0]
            for t in shards:
                edges.append(edges[-1] + t.shape[axis])
        edges = list(edges)
        if len(edges) != len(shards) + 1 or edges[0] != 0 or any(
                b < a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"bad row edges {edges}")
        for i, t in enumerate(shards):
            if t is not None and t.shape[axis] != edges[i + 1] - edges[i]:
                raise ValueError(
                    f"shard {i} holds {t.shape[axis]} rows, its edges "
                    f"{edges[i]}:{edges[i + 1]}")
        self.mesh = mesh
        self.shards = list(shards)
        self.axis = axis
        self.edges = edges
        self._ref = ref

    @property
    def rows(self) -> int:
        return self.edges[-1]

    @property
    def shape(self) -> tuple[int, ...]:
        s = list(self._ref.shape)
        s[self.axis] = self.rows
        return tuple(s)

    @property
    def dtype(self) -> torch.dtype:
        return self._ref.dtype

    def bounds(self, i: int) -> tuple[int, int]:
        """Rows ``[a, b)`` of the raster that shard ``i`` holds."""
        return self.edges[i], self.edges[i + 1]

    def piece_shape(self, rows: int, cols=None) -> list[int]:
        """The shape of ``rows`` rows (columns ``cols`` of the last
        dimension, all by default)."""
        s = list(self._ref.shape)
        s[self.axis] = rows
        if cols is not None:
            s[-1] = cols[1] - cols[0]
        return s

    def zeros(self, rows: int, device, cols=None) -> torch.Tensor:
        s = self.piece_shape(rows, cols)
        if self.dtype == torch.uint16:
            # zero bits through int16: the port does no uint16 arithmetic
            # on CUDA, fills included
            return torch.zeros(s, dtype=torch.int16, device=device).view(
                torch.uint16)
        return torch.zeros(s, dtype=self.dtype, device=device)

    def rows_on(self, a: int, b: int, device,
                cols: tuple[int, int] | None = None) -> torch.Tensor:
        """Rows ``[a, b)`` of the raster on ``device`` (columns ``cols`` of
        the last dimension, all by default): copies of the shards that hold
        them, zeros for rows outside ``[0, rows)``.  A block that lies in
        one shard on ``device`` comes back as a view.  Every row must be
        this process's: rows another process holds come through
        :meth:`fetch`."""
        device = torch.device(device)
        if b <= a:
            return self.zeros(0, device, cols)
        parts = []
        if a < 0:
            parts.append(self.zeros(min(b, 0) - a, device, cols))
        for i, t in enumerate(self.shards):
            lo, hi = max(a, self.edges[i]), min(b, self.edges[i + 1])
            if lo < hi:
                if t is None:
                    raise ValueError(
                        f"rows {lo}:{hi} are held by process "
                        f"{self.mesh.owners[i]}: fetch them")
                blk = t.narrow(self.axis, lo - self.edges[i], hi - lo)
                if cols is not None:
                    blk = blk[..., cols[0]:cols[1]]
                parts.append(blk.to(device))
        if b > self.rows:
            parts.append(self.zeros(b - max(a, self.rows), device, cols))
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts, dim=self.axis)

    def fetch(self, plan, device=None) -> Iterator[torch.Tensor | None]:
        """Rows for a plan of ``(destination shard, a, b, cols)`` entries,
        in plan order: rows ``[a, b)`` (columns ``cols``, all when None;
        zeros outside the raster) on the destination shard's device (or
        ``device``), as :meth:`rows_on` gives them; ``None`` for the
        entries whose destination another process holds.  In one process
        each entry is copied as it is taken (the direct ``Tensor.to``
        path), so a caller holds one at a time.  On a mesh spanning
        processes this is one collective (``parallel.distributed.fetch``)
        that every process calls with the same plan."""
        if not self.mesh.spans_processes:
            return (self.rows_on(a, b, device or self.mesh.devices[d], cols)
                    for d, a, b, cols in plan)
        from .distributed import fetch

        return iter(fetch(self, plan, device))

    def windows(self, top: int, bottom: int
                ) -> Iterator[tuple[torch.Tensor | None, int]]:
        """Each shard with up to ``top`` rows before it and ``bottom``
        after it, copied from its neighbours onto its device and clipped
        at the strip ends (the streamed route's rule: a resample reads 0
        past the edges of its input, after the RRC), in shard order
        (:meth:`fetch`).  -> ``(rows, top rows present)`` a shard,
        ``(None, top)`` for another process's shards."""
        plan, tops = [], []
        for i in range(len(self.shards)):
            a, b = self.bounds(i)
            t = min(top, a)
            plan.append((i, a - t, min(b + bottom, self.rows), None))
            tops.append(t)
        for rows, t in zip(self.fetch(plan), tops):
            yield rows, t

    def map(self, fn) -> LineSharded:
        """``fn(shard, device)`` on every shard this process holds; the
        results (each as many rows as its shard), line-sharded like this
        raster."""
        return LineSharded(
            self.mesh, [None if t is None else fn(t, d)
                        for t, d in zip(self.shards, self.mesh.devices)],
            self.axis, self.edges)

    def drop_rows(self, n: int) -> LineSharded:
        """The raster's rows ``[n, rows)``, each shard trimmed in place
        (views)."""
        out = []
        for i, t in enumerate(self.shards):
            a, b = self.bounds(i)
            lo = min(max(n, a), b)
            out.append(None if t is None
                       else t.narrow(self.axis, lo - a, b - lo))
        return LineSharded(self.mesh, out, self.axis,
                           [max(e - n, 0) for e in self.edges])

    def band(self, k: int) -> LineSharded:
        """Index ``k`` of the leading dimension of a (bands, rows, ...)
        raster line-sharded on axis 1: a (rows, ...) raster on axis 0."""
        if self.axis != 1:
            raise ValueError("band() takes a raster line-sharded on axis 1")
        return LineSharded(self.mesh, [None if t is None else t[k]
                                       for t in self.shards], 0, self.edges)

    def host_blocks(self, a: int = 0, b: int | None = None,
                    block: int = 4096) -> Iterator[tuple[int, np.ndarray]]:
        """``(first row, host rows)`` of rows ``[a, b)`` in line order, at
        most ``block`` rows at a time, never crossing a shard: the host
        holds one block, never the raster.  The rows must be this
        process's (a drain of a mesh spanning processes writes its own)."""
        b = self.rows if b is None else b
        if any(t is None and max(a, self.edges[i]) < min(b, self.edges[i + 1])
               for i, t in enumerate(self.shards)):
            from .distributed import require_single_process_drain

            require_single_process_drain(
                f"LineSharded.host_blocks({a}, {b})")
        for i, t in enumerate(self.shards):
            lo, hi = max(a, self.edges[i]), min(b, self.edges[i + 1])
            for r in range(lo, hi, block):
                n = min(block, hi - r)
                yield r, t.narrow(self.axis, r - self.edges[i], n).cpu(
                ).numpy()

    def gather(self, device="cpu") -> torch.Tensor:
        """The whole raster on one device; on a mesh spanning processes,
        on every process (an all-gather)."""
        if not self.mesh.spans_processes:
            return self.rows_on(0, self.rows, device)
        owners = self.mesh.owners
        # one entry a process: to its first shard
        firsts = [owners.index(o) for o in dict.fromkeys(owners)]
        got = self.fetch([(i, 0, self.rows, None) for i in firsts],
                         torch.device(device))
        return next(t for t in got if t is not None)

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
"""

from __future__ import annotations

from collections.abc import Iterator, Sequence

import numpy as np
import torch

LINE_AXIS = "line"


class LineMesh:
    """A 1-D mesh over the line axis: shard ``i`` lives on ``devices[i]``.

    All devices are of one type: a CUDA mesh never puts a shard on the
    CPU."""

    def __init__(self, devices: Sequence[str | torch.device]):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a line mesh needs at least one device")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1:
            raise ValueError(
                f"a line mesh's devices are of one type, got {sorted(kinds)}")
        if self.devices[0].type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device {self.devices[0]} requested but CUDA is not "
                    "available")
            # "cuda" names the current device; tensors moved there carry
            # its index, and shards are checked against their device
            cur = torch.cuda.current_device()
            self.devices = [torch.device("cuda", cur if d.index is None
                                         else d.index) for d in self.devices]

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"LineMesh({[str(d) for d in self.devices]})"

    def distinct(self) -> list[torch.device]:
        """The mesh's devices without repeats, in mesh order."""
        return list(dict.fromkeys(self.devices))


def line_mesh(n_devices: int, device: str | torch.device = "cuda") -> LineMesh:
    """The CLI's ``--mesh N``: ``[cpu] * N`` for the CPU, ``cuda:0`` ...
    ``cuda:N-1`` for CUDA.  Fewer CUDA devices than N raise JAX's message
    (models/scene.py:198-202); there is no smaller mesh."""
    dev = torch.device(device)
    if n_devices <= 0:
        raise ValueError(f"mesh must be >= 1 device, got {n_devices}")
    if dev.type == "cpu":
        return LineMesh([dev] * n_devices)
    if dev.type != "cuda":
        raise ValueError(f"no line mesh over {dev.type} devices")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    have = torch.cuda.device_count()
    if have < n_devices:
        raise RuntimeError(
            f"--mesh {n_devices} needs {n_devices} devices, only {have} "
            "available")
    return LineMesh([torch.device("cuda", i) for i in range(n_devices)])


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
    """

    def __init__(self, mesh: LineMesh, shards: Sequence[torch.Tensor],
                 axis: int = 0):
        if len(shards) != len(mesh):
            raise ValueError(
                f"{len(shards)} shards for a {len(mesh)}-device mesh")
        ref = shards[0]
        for t, d in zip(shards, mesh.devices):
            if t.device != d:
                raise ValueError(f"a shard on {t.device}, its device is {d}")
            if t.dim() != ref.dim() or t.dtype != ref.dtype or any(
                t.shape[k] != ref.shape[k] for k in range(t.dim()) if k != axis
            ):
                raise ValueError("shards differ beyond the line axis")
        self.mesh = mesh
        self.shards = list(shards)
        self.axis = axis
        self._edges = [0]
        for t in self.shards:
            self._edges.append(self._edges[-1] + t.shape[axis])

    @property
    def rows(self) -> int:
        return self._edges[-1]

    @property
    def shape(self) -> tuple[int, ...]:
        s = list(self.shards[0].shape)
        s[self.axis] = self.rows
        return tuple(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def bounds(self, i: int) -> tuple[int, int]:
        """Rows ``[a, b)`` of the raster that shard ``i`` holds."""
        return self._edges[i], self._edges[i + 1]

    def _zeros(self, rows: int, device, cols) -> torch.Tensor:
        s = list(self.shards[0].shape)
        s[self.axis] = rows
        if cols is not None:
            s[-1] = cols[1] - cols[0]
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
        one shard on ``device`` comes back as a view."""
        device = torch.device(device)
        if b <= a:
            return self._zeros(0, device, cols)
        parts = []
        if a < 0:
            parts.append(self._zeros(min(b, 0) - a, device, cols))
        for i, t in enumerate(self.shards):
            lo, hi = max(a, self._edges[i]), min(b, self._edges[i + 1])
            if lo < hi:
                blk = t.narrow(self.axis, lo - self._edges[i], hi - lo)
                if cols is not None:
                    blk = blk[..., cols[0]:cols[1]]
                parts.append(blk.to(device))
        if b > self.rows:
            parts.append(self._zeros(b - max(a, self.rows), device, cols))
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts, dim=self.axis)

    def window(self, i: int, top: int, bottom: int
               ) -> tuple[torch.Tensor, int]:
        """Shard ``i`` with up to ``top`` rows before it and ``bottom``
        after it, copied from its neighbours onto its device and clipped
        at the strip ends (the streamed route's rule: a resample reads 0
        past the edges of its input, after the RRC).  -> ``(rows, top
        rows present)``."""
        a, b = self.bounds(i)
        t = min(top, a)
        return self.rows_on(a - t, min(b + bottom, self.rows),
                            self.mesh.devices[i]), t

    def map(self, fn) -> LineSharded:
        """``fn(shard, device)`` on every shard; the results, line-sharded
        like this raster."""
        return LineSharded(
            self.mesh, [fn(t, d) for t, d in zip(self.shards,
                                                 self.mesh.devices)],
            self.axis)

    def drop_rows(self, n: int) -> LineSharded:
        """The raster's rows ``[n, rows)``, each shard trimmed in place
        (views)."""
        out = []
        for i, t in enumerate(self.shards):
            a, b = self.bounds(i)
            lo = min(max(n, a), b)
            out.append(t.narrow(self.axis, lo - a, b - lo))
        return LineSharded(self.mesh, out, self.axis)

    def band(self, k: int) -> LineSharded:
        """Index ``k`` of the leading dimension of a (bands, rows, ...)
        raster line-sharded on axis 1: a (rows, ...) raster on axis 0."""
        if self.axis != 1:
            raise ValueError("band() takes a raster line-sharded on axis 1")
        return LineSharded(self.mesh, [t[k] for t in self.shards], 0)

    def host_blocks(self, a: int = 0, b: int | None = None,
                    block: int = 4096) -> Iterator[tuple[int, np.ndarray]]:
        """``(first row, host rows)`` of rows ``[a, b)`` in line order, at
        most ``block`` rows at a time, never crossing a shard: the host
        holds one block, never the raster."""
        b = self.rows if b is None else b
        for i, t in enumerate(self.shards):
            lo, hi = max(a, self._edges[i]), min(b, self._edges[i + 1])
            for r in range(lo, hi, block):
                n = min(block, hi - r)
                yield r, t.narrow(self.axis, r - self._edges[i], n).cpu(
                ).numpy()

    def gather(self, device="cpu") -> torch.Tensor:
        """The whole raster on one device."""
        return self.rows_on(0, self.rows, device)

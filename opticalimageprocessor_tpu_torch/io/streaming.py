"""Double-buffered host<->device section streaming, in PyTorch.

Counterpart of ``opticalimageprocessor_tpu/io/streaming.py``.
:class:`HostDeviceCopies` moves a streamed loop's sections between host and
device off the compute stream: on CUDA the host fills a pinned staging
buffer (two of them, used in turn), a side stream copies it to the device,
and the compute stream waits on that copy's event only when the section's
work is enqueued; results go back the same way on a second side stream
(host->device and device->host have their own copy engines on the card).
So the next section's upload and the previous section's drain overlap the
current section's kernels, and the host's file IO overlaps all three.

:class:`SectionStreamer` iterates line sections of a memory-mapped RAW
strip with halo rows; :func:`stream_process` runs a function over them and
writes each result in line order, one step behind.  On the CPU the same
code runs with plain copies and no streams.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator, Sequence
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.logging import host_wait
from .raw import RawStrip

SLOTS = 2   # pinned staging buffers a direction (double buffering)


def window(lines: int, offset: int, count: int, halo: int):
    """The rows ``[offset - top, offset + count + bottom)`` of a
    ``lines``-line strip around the payload ``[offset, offset + count)``,
    with up to ``halo`` context rows each side, clipped at the strip ends:
    -> ``(start, stop, top, bottom)``."""
    top = min(halo, offset)
    bottom = min(halo, lines - offset - count)
    return offset - top, offset + count + bottom, top, bottom


class Upload:
    """Device tensors whose host->device copy has been issued.  :meth:`get`
    orders the current stream after the copy and hands the tensors over."""

    def __init__(self, tensors, event=None):
        self._tensors = tensors
        self._event = event

    def get(self) -> list[torch.Tensor]:
        if self._event is not None:
            cur = torch.cuda.current_stream(self._tensors[0].device)
            cur.wait_event(self._event)
            for t in self._tensors:
                # allocated on the copy stream, read on this one: the
                # allocator must not recycle them before this work ends
                t.record_stream(cur)
        return self._tensors


class Drain:
    """Host arrays whose device->host copy has been issued.  :meth:`wait`
    blocks until they hold the data."""

    def __init__(self, arrays, event=None):
        self._arrays = arrays
        self._event = event

    def wait(self) -> list[np.ndarray]:
        if self._event is not None:
            with host_wait():
                self._event.synchronize()
        return self._arrays


class HostDeviceCopies:
    """Host<->device copies of a streamed loop (see the module docstring).

    :meth:`upload` copies host arrays (memory-map views included) to the
    device; :meth:`download` starts copying device tensors back.  On CUDA
    the staging buffers are pinned and reused in turn, so a loop keeps at
    most :data:`SLOTS` uploads in flight ahead of their :meth:`Upload.get`
    and at most :data:`SLOTS` downloads ahead of their :meth:`Drain.wait`:
    the next upload (download) into a slot first waits for the copy out of
    (the host's use of) that slot two steps before."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
        self._bufs = {"up": [[] for _ in range(SLOTS)],
                      "down": [[] for _ in range(SLOTS)]}
        self._done = [None] * SLOTS      # each upload slot's copy event
        self._n = {"up": 0, "down": 0}

    def _slot(self, way: str) -> int:
        k = self._n[way] % SLOTS
        self._n[way] += 1
        return k

    def _staging(self, way: str, slot: int, i: int, shape, dtype):
        """Pinned buffer ``i`` of a slot, viewed as ``shape``; grown when
        too small (its last copy has ended when this is called)."""
        bufs = self._bufs[way][slot]
        n = int(np.prod(shape))
        nbytes = n * torch.empty((), dtype=dtype).element_size()
        if i == len(bufs):
            bufs.append(None)
        if bufs[i] is None or bufs[i].numel() < nbytes:
            bufs[i] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return bufs[i][:nbytes].view(dtype).view(shape)

    def upload(self, arrays: Sequence[np.ndarray]) -> Upload:
        """Copy each host array to the device; call :meth:`Upload.get` on
        the stream that uses the tensors."""
        if not self.cuda:
            return Upload([torch.from_numpy(np.array(a)).to(self.device)
                           for a in arrays])
        slot = self._slot("up")
        if self._done[slot] is not None:
            with host_wait():
                self._done[slot].synchronize()   # the slot's last copy ended
        staged = []
        for i, a in enumerate(arrays):
            buf = self._staging("up", slot, i, a.shape,
                                torch.from_numpy(np.empty(0, a.dtype)).dtype)
            np.copyto(buf.numpy(), a)        # the host read (file IO)
            staged.append(buf)
        with torch.cuda.stream(self._h2d):
            out = [b.to(self.device, non_blocking=True) for b in staged]
            ev = torch.cuda.Event()
            ev.record(self._h2d)
        self._done[slot] = ev
        return Upload(out, ev)

    def download(self, tensors: Sequence[torch.Tensor]) -> Drain:
        """Copy device tensors to the host once the current stream's work
        so far has made them; :meth:`Drain.wait` before reading."""
        if not self.cuda:
            return Drain([t.numpy() for t in tensors])
        slot = self._slot("down")
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        self._d2h.wait_event(ready)
        host = []
        with torch.cuda.stream(self._d2h):
            for i, t in enumerate(tensors):
                buf = self._staging("down", slot, i, tuple(t.shape), t.dtype)
                buf.copy_(t, non_blocking=True)
                # made on the compute stream, read here: keep it until then
                t.record_stream(self._d2h)
                host.append(buf.numpy())
            ev = torch.cuda.Event()
            ev.record(self._d2h)
        return Drain(host, ev)


@dataclass
class Section:
    index: int
    line_offset: int          # first payload line (excluding halo)
    lines: int                # payload lines
    halo_top: int             # halo rows actually present above the payload
    halo_bottom: int
    data: torch.Tensor        # (halo_top + lines + halo_bottom, W) on device


class SectionStreamer:
    """Iterate device-resident line sections of a RAW strip with halos.

    ``section_lines`` payload rows per step plus up to ``halo`` context rows
    on each side (clipped at the strip ends).  The next section's host read
    and upload are issued before the current one is yielded (double
    buffering); ``copies`` is the loop's :class:`HostDeviceCopies` (a new
    one by default)."""

    def __init__(self, strip: RawStrip, section_lines: int, device,
                 halo: int = 0, copies: HostDeviceCopies | None = None):
        self.strip = strip
        self.section_lines = section_lines
        self.halo = halo
        self.copies = copies or HostDeviceCopies(device)

    def _load(self, idx: int):
        off = idx * self.section_lines
        if off >= self.strip.lines:
            return None
        lines = min(self.section_lines, self.strip.lines - off)
        a, b, top, bottom = window(self.strip.lines, off, lines, self.halo)
        up = self.copies.upload([self.strip.section(a, b - a)])
        return idx, off, lines, top, bottom, up

    def __iter__(self) -> Iterator[Section]:
        nxt = self._load(0)
        while nxt is not None:
            idx, off, lines, top, bottom, up = nxt
            nxt = self._load(idx + 1)   # its copy overlaps the caller's work
            yield Section(idx, off, lines, top, bottom, up.get()[0])

    def __len__(self) -> int:
        return -(-self.strip.lines // self.section_lines)


def stream_process(
    strip: RawStrip,
    fn: Callable[[Section], torch.Tensor],
    write: Callable[[np.ndarray], None],
    section_lines: int,
    device,
    halo: int = 0,
) -> int:
    """Run ``fn`` over every section on ``device`` and drain its results to
    ``write`` in order; returns the payload lines written.

    ``fn`` receives a :class:`Section` (device tensor incl. halo rows) and
    returns the processed payload rows.  Section i-1's result is handed to
    ``write`` only after section i's work and drain are enqueued."""
    copies = HostDeviceCopies(device)
    pending = None
    total = 0
    for sec in SectionStreamer(strip, section_lines, device, halo, copies):
        drain = copies.download([fn(sec)])
        if pending is not None:
            total += _write_drained(pending, write)
        pending = (drain, sec.lines)
    if pending is not None:
        total += _write_drained(pending, write)
    return total


def _write_drained(pending, write) -> int:
    drain, lines = pending
    write(drain.wait()[0])
    return lines

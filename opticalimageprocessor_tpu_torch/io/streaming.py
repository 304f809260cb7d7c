"""Double-buffered host<->device section streaming, in PyTorch.

Counterpart of ``opticalimageprocessor_tpu/io/streaming.py``.
:class:`SectionStreamer` iterates line sections of a memory-mapped RAW
strip with halo rows on an explicit device: the next section's host read
and host->device copy (from pinned memory, asynchronous to the host on
CUDA) are issued before the current section is yielded.
:func:`stream_process` defers each result's device->host drain by one
step.  Copies and kernels share the current stream, so what overlaps is
the host's file IO with the device's copies and compute.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator
from dataclasses import dataclass

import numpy as np
import torch

from .raw import RawStrip


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
    on each side (clipped at the strip ends).  The next section is loaded
    and its copy to ``device`` issued before the current one is yielded
    (double buffering)."""

    def __init__(self, strip: RawStrip, section_lines: int, device,
                 halo: int = 0):
        self.strip = strip
        self.section_lines = section_lines
        self.halo = halo
        self.device = torch.device(device)

    def _load(self, idx: int) -> Section | None:
        off = idx * self.section_lines
        if off >= self.strip.lines:
            return None
        lines = min(self.section_lines, self.strip.lines - off)
        top = min(self.halo, off)
        bottom = min(self.halo, self.strip.lines - off - lines)
        host = torch.from_numpy(
            np.array(self.strip.section(off - top, top + lines + bottom)))
        if self.device.type == "cuda":
            host = host.pin_memory()
        data = host.to(self.device, non_blocking=True)
        return Section(idx, off, lines, top, bottom, data)

    def __iter__(self) -> Iterator[Section]:
        nxt = self._load(0)
        i = 0
        while nxt is not None:
            cur = nxt
            i += 1
            nxt = self._load(i)   # its copy overlaps the caller's compute
            yield cur

    def __len__(self) -> int:
        return -(-self.strip.lines // self.section_lines)


def _drain(out: torch.Tensor):
    """Start the device->host copy of ``out``; returns (host tensor, event
    to wait on, or None on the CPU)."""
    if out.device.type != "cuda":
        return out, None
    host = out.to("cpu", non_blocking=True)     # into pinned memory
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(out.device))
    return host, ev


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
    ``write`` only after section i's compute is enqueued."""
    pending = None
    total = 0
    for sec in SectionStreamer(strip, section_lines, device, halo):
        out = _drain(fn(sec))
        if pending is not None:
            total += _write_drained(pending, write)
        pending = (*out, sec.lines)
    if pending is not None:
        total += _write_drained(pending, write)
    return total


def _write_drained(pending, write) -> int:
    host, ev, lines = pending
    if ev is not None:
        ev.synchronize()
    write(host.numpy())
    return lines

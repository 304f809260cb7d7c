"""RAW strip IO: memory-mapped uint16 line rasters and a streaming writer.
All files are uint16 little-endian, ``pixels_per_line`` pixels per line
(oipshared.h:27-29).

Copied from ``opticalimageprocessor_tpu/io/raw.py`` (``RawStrip``,
``RawStripWriter``, ``file_size`` and ``check_pan_mss_sizes``).
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import BYTES_PER_PIXEL, MSS_BANDS, PIXELS_PER_LINE
from ..utils.logging import olog


def file_size(path: str) -> int:
    return os.stat(path).st_size


class RawStrip:
    """Memory-mapped view of a RAW uint16 strip file."""

    def __init__(self, path: str, pixels_per_line: int = PIXELS_PER_LINE):
        self.path = path
        self.pixels_per_line = pixels_per_line
        size = file_size(path)
        if size % (pixels_per_line * BYTES_PER_PIXEL) != 0:
            raise ValueError(
                f"file size {size} is not a whole number of "
                f"{pixels_per_line}-px lines: {path}"
            )
        self.lines = size // (pixels_per_line * BYTES_PER_PIXEL)
        self.nbytes = size
        self._mm = np.memmap(path, dtype="<u2", mode="r").reshape(
            self.lines, pixels_per_line
        )

    def section(self, line_offset: int, lines: int) -> np.ndarray:
        """Zero-copy (lines, pixels_per_line) view."""
        if line_offset < 0 or lines < 0:
            # negative offsets would silently wrap via numpy indexing and
            # return data from the strip END — corruption, not a view
            raise ValueError(
                f"negative section request: offset={line_offset}, "
                f"lines={lines} ({self.path})"
            )
        end = min(line_offset + lines, self.lines)
        return self._mm[line_offset:end]

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._mm, dtype=dtype)

    def close(self):
        del self._mm


class RawStripWriter:
    """Sequential line-oriented RAW writer with throughput logging."""

    def __init__(self, path: str, pixels_per_line: int = PIXELS_PER_LINE):
        self.path = path
        self.pixels_per_line = pixels_per_line
        self._f = open(path, "wb")
        self.lines_written = 0

    def write_lines(self, block: np.ndarray) -> None:
        block = np.ascontiguousarray(block, dtype="<u2")
        assert block.ndim == 2 and block.shape[1] == self.pixels_per_line
        self._f.write(block.tobytes())
        self.lines_written += block.shape[0]

    def close(self) -> None:
        self._f.close()
        olog(
            "RawStripWriter: %d lines -> %s", self.lines_written, self.path
        )


def check_pan_mss_sizes(pan: RawStrip, mss: RawStrip) -> None:
    """CheckFilesAttributes size relation (preproc.h:565-567): the PAN strip
    must be exactly MSS_BANDS x the MSS strip.  (Whole-line divisibility is
    enforced by RawStrip itself at construction.)"""
    if pan.nbytes != MSS_BANDS * mss.nbytes:
        raise ValueError(
            "PAN file size does not match MSS file size: PAN file should "
            f"be {MSS_BANDS}x as large as MSS file"
        )

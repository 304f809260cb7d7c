"""Minimal TIFF / BigTIFF reader and writer for uint16 rasters: strip-based,
little endian, uint16, 1 or 4 samples per pixel (chunky), optional LZW
compression with the horizontal differencing predictor 2 -- the option set
of the reference's GDAL writer (``COMPRESS=LZW``, ``PREDICTOR=2``,
``imageop.h:470-474``).  BigTIFF is selected automatically above 4 GB.
The reader also takes the foreign rasters the reference read through
OpenCV / GDAL (deflate, PackBits, planar, tiled, big-endian).

Copied from ``opticalimageprocessor_tpu/io/tiff.py`` (the streaming
writer, ``write_tiff``, ``read_tiff_info``, the readers, and
``create_tiff_shell`` for the line mesh's offset-write TIFF drain).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

from ..utils import native
from ..utils.logging import olog, stage

# TIFF tags
T_IMAGEWIDTH = 256
T_IMAGELENGTH = 257
T_BITSPERSAMPLE = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_STRIPOFFSETS = 273
T_SAMPLESPERPIXEL = 277
T_ROWSPERSTRIP = 278
T_STRIPBYTECOUNTS = 279
T_PLANARCONFIG = 284
T_PREDICTOR = 317
T_TILEWIDTH = 322
T_TILELENGTH = 323
T_TILEOFFSETS = 324
T_TILEBYTECOUNTS = 325
T_SAMPLEFORMAT = 339
T_EXTRASAMPLES = 338

COMPRESSION_NONE = 1
COMPRESSION_LZW = 5
COMPRESSION_DEFLATE = 8           # zlib ("new-style" deflate)
COMPRESSION_ADOBE_DEFLATE = 32946  # zlib (legacy codepoint, same stream)
COMPRESSION_PACKBITS = 32773


def auto_bigtiff(width: int, height: int, samples: int = 1) -> bool:
    """The writer's automatic BigTIFF decision for a uint16 raster: the
    projected raster size is within 16 MiB of the 4 GiB classic-TIFF
    offset ceiling."""
    return width * height * samples * 2 >= (1 << 32) - (1 << 24)


def _predict2_encode(strip: np.ndarray) -> np.ndarray:
    """Horizontal differencing (predictor 2) on a (rows, w, spp) uint16 view."""
    out = strip.astype(np.int32)
    out[:, 1:, :] = out[:, 1:, :] - out[:, :-1, :]
    return (out & 0xFFFF).astype(np.uint16)


@dataclass
class TiffInfo:
    width: int
    height: int
    samples: int
    bits: int
    compression: int
    predictor: int
    rows_per_strip: int
    strip_offsets: np.ndarray
    strip_counts: np.ndarray
    bigtiff: bool
    little_endian: bool
    extrasamples: tuple[int, ...] = ()
    planar: int = 1                # PlanarConfiguration: 1 chunky, 2 planar
    tile_width: int = 0            # nonzero => tiled layout
    tile_length: int = 0


class TiffStripWriter:
    """Streaming strip-based TIFF writer.

    Usage::

        w = TiffStripWriter(path, width, height, samples=4,
                            compression="lzw", predictor=True)
        for block in blocks:       # (rows, width) or (rows, width, samples)
            w.write_rows(block)
        w.close()

    Strips are written to the file as data arrives; the IFD is emitted on
    close.  BigTIFF is chosen automatically when the projected size exceeds
    4 GB (like GDAL's IF_NEEDED) unless forced.
    """

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        samples: int = 1,
        rows_per_strip: int = 512,
        compression: str = "none",
        predictor: bool = False,
        bigtiff: bool | None = None,
        photometric: int | None = None,
        extrasamples: int | None = None,
    ):
        self.path = path
        self.width = width
        self.height = height
        self.samples = samples
        self.rows_per_strip = min(rows_per_strip, height)
        self.comp = COMPRESSION_LZW if compression == "lzw" else COMPRESSION_NONE
        if compression == "lzw" and not native.native_available():
            olog("native LZW unavailable; writing uncompressed TIFF")
            self.comp = COMPRESSION_NONE
        self.predictor = predictor and self.comp == COMPRESSION_LZW
        self.bigtiff = (
            bool(bigtiff) if bigtiff is not None
            else auto_bigtiff(width, height, samples)
        )
        self.photometric = photometric if photometric is not None else (
            2 if samples >= 3 else 1
        )
        # per-band color interpretation: with 4 samples GDAL writes
        # EXTRASAMPLES=2 (unassociated alpha) when band 4 is tagged
        # GCI_AlphaBand (imageop.h:508-512,528-530 setBandInterpretion), 0
        # (unspecified) otherwise
        self.extrasamples = extrasamples if extrasamples is not None else 0
        self._f = open(path, "wb")
        if self.bigtiff:
            self._f.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, 0))
            # IFD offset (the final 8 bytes of the 16-byte header) patched on close
        else:
            self._f.write(struct.pack("<2sHI", b"II", 42, 0))
        self._offsets: list[int] = []
        self._counts: list[int] = []
        self._rows_written = 0
        self._pending = np.zeros((0, width, samples), np.uint16)

    def write_rows(self, block: np.ndarray) -> None:
        block = np.asarray(block, dtype=np.uint16)
        if block.ndim == 2:
            block = block[:, :, None]
        assert block.shape[1] == self.width and block.shape[2] == self.samples
        self._pending = (
            block
            if self._pending.shape[0] == 0
            else np.concatenate([self._pending, block], axis=0)
        )
        while self._pending.shape[0] >= self.rows_per_strip:
            self._emit_strip(self._pending[: self.rows_per_strip])
            self._pending = self._pending[self.rows_per_strip :]

    def _emit_strip(self, strip: np.ndarray) -> None:
        plain = np.ascontiguousarray(strip).tobytes()
        if self.comp == COMPRESSION_LZW:
            if self.predictor:
                strip = _predict2_encode(strip)
            raw = np.ascontiguousarray(strip).tobytes()
            enc = native.lzw_encode(raw)
            if enc is None:
                raise RuntimeError("LZW requested but unavailable")
            if not self._offsets and len(enc) >= len(raw):
                # pathological expansion (incompressible content): the
                # compression tag is file-global, so the guard can only
                # engage before any strip is written — switch the whole
                # file to uncompressed on the first strip
                olog(
                    "LZW expanded the first strip (%d -> %d bytes); "
                    "writing uncompressed TIFF", len(raw), len(enc),
                )
                self.comp = COMPRESSION_NONE
                self.predictor = False
                data = plain
            else:
                data = enc
        else:
            data = plain
        self._offsets.append(self._f.tell())
        self._counts.append(len(data))
        self._f.write(data)
        self._rows_written += strip.shape[0]

    def close(self) -> None:
        if self._pending.shape[0] > 0:
            self._emit_strip(self._pending)
            self._pending = self._pending[:0]
        if self._rows_written != self.height:
            raise ValueError(
                f"wrote {self._rows_written} rows, expected {self.height}"
            )
        self._write_ifd()
        self._f.close()

    # -- IFD helpers --------------------------------------------------------
    def _write_ifd(self) -> None:
        f = self._f
        big = self.bigtiff
        n_strips = len(self._offsets)
        off_type = 16 if big else 4  # LONG8 / LONG
        inline_cap = 8 if big else 4
        type_fmt = {1: "B", 3: "H", 4: "I", 16: "Q"}
        type_size = {1: 1, 3: 2, 4: 4, 16: 8}

        raw_entries: list[tuple[int, int, list[int]]] = [
            (T_IMAGEWIDTH, 4, [self.width]),
            (T_IMAGELENGTH, 4, [self.height]),
            (T_BITSPERSAMPLE, 3, [16] * self.samples),
            (T_COMPRESSION, 3, [self.comp]),
            (T_PHOTOMETRIC, 3, [self.photometric]),
            (T_STRIPOFFSETS, off_type, list(self._offsets)),
            (T_SAMPLESPERPIXEL, 3, [self.samples]),
            (T_ROWSPERSTRIP, 4, [self.rows_per_strip]),
            (T_STRIPBYTECOUNTS, off_type, list(self._counts)),
            (T_SAMPLEFORMAT, 3, [1] * self.samples),
        ]
        if self.predictor:
            raw_entries.append((T_PREDICTOR, 3, [2]))
        if self.samples == 4:
            raw_entries.append((T_EXTRASAMPLES, 3, [self.extrasamples]))
        raw_entries.sort(key=lambda entry: entry[0])

        # first pass: write out-of-line arrays, record value field per entry
        packed: list[tuple[int, int, int, int]] = []
        for tag, typ, values in raw_entries:
            size = type_size[typ] * len(values)
            fmt = type_fmt[typ]
            if size <= inline_cap:
                data = struct.pack(f"<{len(values)}{fmt}", *values)
                data = data.ljust(inline_cap, b"\x00")
                (value,) = struct.unpack("<Q" if big else "<I", data)
            else:
                value = f.tell()
                f.write(struct.pack(f"<{len(values)}{fmt}", *values))
            packed.append((tag, typ, len(values), value))

        ifd_pos = f.tell()
        if big:
            f.write(struct.pack("<Q", len(packed)))
            for tag, typ, count, value in packed:
                f.write(struct.pack("<HHQQ", tag, typ, count, value))
            f.write(struct.pack("<Q", 0))
            f.seek(8)
            f.write(struct.pack("<Q", ifd_pos))
        else:
            f.write(struct.pack("<H", len(packed)))
            for tag, typ, count, value in packed:
                f.write(struct.pack("<HHII", tag, typ, count, value))
            f.write(struct.pack("<I", 0))
            f.seek(4)
            f.write(struct.pack("<I", ifd_pos))


def create_tiff_shell(
    path: str,
    width: int,
    height: int,
    samples: int = 1,
    rows_per_strip: int = 512,
    bigtiff: bool | None = None,
    photometric: int | None = None,
    extrasamples: int | None = None,
) -> int:
    """Create a complete UNCOMPRESSED strip TIFF with zeroed raster bytes
    and the IFD already in place; returns the byte offset of raster row 0.

    With no compression the strip layout is fixed up front (row ``r``
    lives at ``data_start + r * width * samples * 2``), so a drain can fill
    the rows of each shard at their offsets, in any order."""
    w = TiffStripWriter(
        path, width, height, samples,
        rows_per_strip=rows_per_strip, compression="none",
        bigtiff=bigtiff, photometric=photometric,
        extrasamples=extrasamples,
    )
    data_start = w._f.tell()
    rps = w.rows_per_strip
    strip_bytes = rps * width * samples * 2
    n_strips = -(-height // rps)
    for k in range(n_strips):
        rows = min(rps, height - k * rps)
        w._offsets.append(data_start + k * strip_bytes)
        w._counts.append(rows * width * samples * 2)
    data_end = w._offsets[-1] + w._counts[-1]
    w._f.truncate(data_end)
    w._f.seek(data_end)
    w._rows_written = height
    w._write_ifd()
    w._f.close()
    return data_start


def write_tiff(
    path: str,
    image: np.ndarray,
    compression: str = "none",
    predictor: bool = False,
    bigtiff: bool | None = None,
    rows_per_strip: int = 512,
) -> None:
    """Write a whole (H, W) or (H, W, S) uint16 raster."""
    h = image.shape[0]
    w = image.shape[1]
    s = 1 if image.ndim == 2 else image.shape[2]
    nbytes = image.size * 2
    with stage(f"write_tiff:{os.path.basename(path)}", nbytes):
        tw = TiffStripWriter(
            path, w, h, s,
            rows_per_strip=rows_per_strip,
            compression=compression,
            predictor=predictor,
            bigtiff=bigtiff,
        )
        tw.write_rows(image)
        tw.close()


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def _read_ifd(f, big: bool, le: bool):
    e = "<" if le else ">"
    if big:
        (n,) = struct.unpack(e + "Q", f.read(8))
        entries = [struct.unpack(e + "HHQQ", f.read(20)) for _ in range(n)]
        (nxt,) = struct.unpack(e + "Q", f.read(8))
    else:
        (n,) = struct.unpack(e + "H", f.read(2))
        entries = [struct.unpack(e + "HHII", f.read(12)) for _ in range(n)]
        (nxt,) = struct.unpack(e + "I", f.read(4))
    return entries, nxt


_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 16: 8, 17: 8, 13: 4}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 16: "Q"}


def _tag_values(f, typ, count, value, big: bool, le: bool):
    e = "<" if le else ">"
    size = _TYPE_SIZE.get(typ, 1) * count
    inline_cap = 8 if big else 4
    fmt = _TYPE_FMT.get(typ)
    if fmt is None:
        return [value]
    if size <= inline_cap:
        # value field holds the data packed little-endian; reinterpret
        raw = struct.pack(e + ("Q" if big else "I"), value)
        return list(struct.unpack(e + f"{count}{fmt}", raw[:size]))
    pos = f.tell()
    f.seek(value)
    vals = list(struct.unpack(e + f"{count}{fmt}", f.read(size)))
    f.seek(pos)
    return vals


def read_tiff_info(path: str) -> TiffInfo:
    with open(path, "rb") as f:
        hdr = f.read(4)
        le = hdr[:2] == b"II"
        e = "<" if le else ">"
        magic = struct.unpack(e + "H", hdr[2:4])[0]
        big = magic == 43
        if big:
            f.read(4)  # bytesize of offsets + pad
            (ifd_off,) = struct.unpack(e + "Q", f.read(8))
        else:
            (ifd_off,) = struct.unpack(e + "I", f.read(4))
        f.seek(ifd_off)
        entries, _ = _read_ifd(f, big, le)
        tags = {}
        for tag, typ, count, value in entries:
            tags[tag] = _tag_values(f, typ, count, value, big, le)
        h = int(tags[T_IMAGELENGTH][0])
        tiled = T_TILEOFFSETS in tags
        if tiled:
            # tiled layout: the offsets/counts arrays hold TILES (row-major,
            # planes sequential when planar=2); tile_width nonzero signals
            # the interpretation
            offsets = np.asarray(tags[T_TILEOFFSETS], np.int64)
            counts = np.asarray(tags[T_TILEBYTECOUNTS], np.int64)
        else:
            offsets = np.asarray(tags[T_STRIPOFFSETS], np.int64)
            counts = np.asarray(tags[T_STRIPBYTECOUNTS], np.int64)
        return TiffInfo(
            width=int(tags[T_IMAGEWIDTH][0]),
            height=h,
            samples=int(tags.get(T_SAMPLESPERPIXEL, [1])[0]),
            bits=int(tags[T_BITSPERSAMPLE][0]),
            compression=int(tags.get(T_COMPRESSION, [1])[0]),
            predictor=int(tags.get(T_PREDICTOR, [1])[0]),
            rows_per_strip=int(tags.get(T_ROWSPERSTRIP, [h])[0]),
            strip_offsets=offsets,
            strip_counts=counts,
            bigtiff=big,
            little_endian=le,
            extrasamples=tuple(
                int(v) for v in tags.get(T_EXTRASAMPLES, [])
            ),
            planar=int(tags.get(T_PLANARCONFIG, [1])[0]),
            tile_width=int(tags.get(T_TILEWIDTH, [0])[0]) if tiled else 0,
            tile_length=int(tags.get(T_TILELENGTH, [0])[0]) if tiled else 0,
        )


_READABLE_COMPRESSIONS = (
    COMPRESSION_NONE,
    COMPRESSION_LZW,
    COMPRESSION_DEFLATE,
    COMPRESSION_ADOBE_DEFLATE,
    COMPRESSION_PACKBITS,
)


def _check_readable(info: TiffInfo) -> None:
    if info.bits != 16:
        raise ValueError(f"only 16-bit TIFFs supported, got {info.bits}")
    if info.compression not in _READABLE_COMPRESSIONS:
        raise ValueError(f"unsupported compression {info.compression}")
    if info.planar not in (1, 2):
        raise ValueError(f"unsupported planar configuration {info.planar}")


def _packbits_decode(data: bytes, want: int) -> bytes:
    """Apple PackBits RLE (TIFF 6.0 §9): literal runs and repeats."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < want:
        h = data[i]
        i += 1
        if h < 128:                       # h+1 literal bytes
            out += data[i : i + h + 1]
            i += h + 1
        elif h > 128:                     # next byte repeated 257-h times
            out += data[i : i + 1] * (257 - h)
            i += 1
        # h == 128: no-op
    return bytes(out)


def _decompress(data: bytes, compression: int, want: int) -> bytes:
    if compression == COMPRESSION_LZW:
        return native.lzw_decode(data, want)
    if compression in (COMPRESSION_DEFLATE, COMPRESSION_ADOBE_DEFLATE):
        import zlib

        return zlib.decompress(data)
    if compression == COMPRESSION_PACKBITS:
        return _packbits_decode(data, want)
    return data


def _decode_block(
    f, info: TiffInfo, off: int, cnt: int, rows: int, width: int, samples: int
):
    """Decode one strip or tile into a (rows, width, samples) uint16 array.

    ``width``/``samples`` are passed explicitly because planar strips carry
    one sample plane and tiles carry the tile width, not the image width.
    """
    want = rows * width * samples * 2
    f.seek(off)
    data = f.read(int(cnt))
    data = _decompress(data, info.compression, want)
    arr = np.frombuffer(
        data[:want], dtype="<u2" if info.little_endian else ">u2"
    )
    block = arr.reshape(rows, width, samples).astype(np.uint16)
    if info.predictor == 2:
        # horizontal differencing is per sample within each row of the
        # strip/tile — integrate across the block's own width
        acc = np.cumsum(block.astype(np.uint64), axis=1)
        block = (acc & 0xFFFF).astype(np.uint16)
    return block


def _iter_strips_chunky(f, info: TiffInfo):
    row = 0
    for off, cnt in zip(info.strip_offsets, info.strip_counts):
        rows = min(info.rows_per_strip, info.height - row)
        yield _decode_block(f, info, off, cnt, rows, info.width, info.samples)
        row += rows


def _iter_strips_planar(f, info: TiffInfo):
    """PlanarConfiguration=2: all strips of sample 0, then sample 1, ...
    Re-interleave plane strips of the same row range into chunky blocks;
    memory stays bounded by one strip per plane."""
    strips_per_plane = -(-info.height // info.rows_per_strip)
    if len(info.strip_offsets) != strips_per_plane * info.samples:
        raise ValueError(
            f"planar TIFF: expected {strips_per_plane * info.samples} "
            f"strips, found {len(info.strip_offsets)}"
        )
    row = 0
    for i in range(strips_per_plane):
        rows = min(info.rows_per_strip, info.height - row)
        planes = [
            _decode_block(
                f, info,
                info.strip_offsets[s * strips_per_plane + i],
                info.strip_counts[s * strips_per_plane + i],
                rows, info.width, 1,
            )
            for s in range(info.samples)
        ]
        yield np.concatenate(planes, axis=2)
        row += rows


def _iter_tiles(f, info: TiffInfo):
    """Tiled layout (row-major tiles; planes sequential when planar=2):
    assemble one tile-row band at a time into a (tile_length, W, S) block,
    trimmed to the image bounds — memory bounded by one tile band."""
    tw, tl = info.tile_width, info.tile_length
    tiles_x = -(-info.width // tw)
    tiles_y = -(-info.height // tl)
    planes = info.samples if info.planar == 2 else 1
    spp_tile = 1 if info.planar == 2 else info.samples
    expected = tiles_x * tiles_y * planes
    if len(info.strip_offsets) != expected:
        raise ValueError(
            f"tiled TIFF: expected {expected} tiles, found "
            f"{len(info.strip_offsets)}"
        )
    for ty in range(tiles_y):
        rows = min(tl, info.height - ty * tl)
        band = np.empty((rows, info.width, info.samples), np.uint16)
        for p in range(planes):
            for tx in range(tiles_x):
                idx = (p * tiles_y + ty) * tiles_x + tx
                tile = _decode_block(
                    f, info,
                    info.strip_offsets[idx], info.strip_counts[idx],
                    tl, tw, spp_tile,
                )
                cols = min(tw, info.width - tx * tw)
                dst = band[:, tx * tw : tx * tw + cols]
                if info.planar == 2:
                    dst[:, :, p] = tile[:rows, :cols, 0]
                else:
                    dst[:] = tile[:rows, :cols]
        yield band


def iter_tiff_strips(path: str):
    """Yield successive decoded (rows, W, S) uint16 blocks of a TIFF
    without ever materialising the raster — the reader counterpart of
    :class:`TiffStripWriter`, enabling StitchTiffGDAL-style sectioned
    streaming (per-section RasterIO loop, imageop.h:489-558).

    Beyond the writer's own dialect (strip-based chunky, none/LZW), the
    reader accepts foreign rasters the reference consumed through
    cv::imread / GDAL (imageop.h:418-420, 489-558): deflate and PackBits
    compression, PlanarConfiguration=2, tiled layout, and big-endian files.
    """
    info = read_tiff_info(path)
    _check_readable(info)
    with open(path, "rb") as f:
        if info.tile_width:
            it = _iter_tiles(f, info)
        elif info.planar == 2 and info.samples > 1:
            it = _iter_strips_planar(f, info)
        else:
            it = _iter_strips_chunky(f, info)
        yield from it


def iter_tiff_rows(path: str, chunk_rows: int):
    """Yield (rows, W, S) uint16 blocks of exactly ``chunk_rows`` rows
    (last block smaller), re-chunking the file's strips; memory is bounded
    by ``chunk_rows + rows_per_strip`` rows."""
    pending: list[np.ndarray] = []
    have = 0
    for strip in iter_tiff_strips(path):
        pending.append(strip)
        have += strip.shape[0]
        while have >= chunk_rows:
            block = np.concatenate(pending) if len(pending) > 1 else pending[0]
            yield block[:chunk_rows]
            rest = block[chunk_rows:]
            pending = [rest] if rest.shape[0] else []
            have = rest.shape[0]
    if have:
        yield np.concatenate(pending) if len(pending) > 1 else pending[0]


def read_tiff(path: str) -> np.ndarray:
    """Read a strip-based uint16 TIFF (compression none/LZW, predictor 1/2).

    Returns (H, W) or (H, W, S) uint16.
    """
    info = read_tiff_info(path)
    _check_readable(info)
    out = np.empty((info.height, info.width, info.samples), np.uint16)
    row = 0
    for strip in iter_tiff_strips(path):
        out[row : row + strip.shape[0]] = strip
        row += strip.shape[0]
    return out[..., 0] if info.samples == 1 else out

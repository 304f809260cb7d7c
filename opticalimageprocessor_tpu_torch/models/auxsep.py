"""Downlink AUX/image separation (reference ``AuxSeparator``,
aux_separator.h:190-748).

Pipeline parity (SURVEY §3.4) with a vectorised host runtime instead of the
reference's two-thread byte-at-a-time loop:

1. AOS scan: read the downlink in fixed-size chunks (peak RSS ~2 chunks
   for any downlink size, vs the reference's whole-file mmap), find every
   sync marker (native memmem sweep), validate VCID/injection/CRC-16 in
   batch, walk the cursor with the reference's advance rules (valid ->
   +1024 bytes, invalid/empty -> +4), and carry unconsumed tail bytes
   across chunk seams.
2. IMTR reassembly: concatenate the 880-byte payloads, cut 882-byte
   image-transfer frames (no resync, sub-frame remainders carried between
   chunks), validate signatures + CRC, warn on sequence gaps, and append
   the 866-byte payloads to the `.IMDT` intermediate file (named
   station_satellite_CMOS-n_date_time.IMDT).
3. Image-data separation: scan the IMDT byte stream for image-frame
   signatures (the frame *data precedes* the signature), zero-fill missing
   sequence numbers to keep raster geometry, split each frame into the
   48 KB aux block + 40 sub-image tiles (32 PAN + 8 MSS), inflate
   (raw copy or JPEG2000 decode), byte-swap to little-endian, and merge to
   `.AUX`, `.PAN.RAW`, `.MSS.RAW`.

JPEG2000 tiles decode through OpenCV when available (the same codec the
reference uses, aux_separator.h:383); uncompressed frames need no codec.

Copied from ``opticalimageprocessor_tpu/models/auxsep.py``, on the port's
own host modules.  It runs on the host only, as in the JAX package: it
holds no device work.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..constants import AUX_FILE_EXT, RAW_FILE_EXT, STEM_EXT_MSS, STEM_EXT_PAN
from ..formats import aos
from ..formats.naming import (
    AosFileInfo,
    build_output_file_path,
    imdt_file_name,
    parse_aos_file_info,
)
from ..utils import native
from ..utils.logging import logw, olog, stage

BYTES_PER_PANLINE = 12288 * 2


def _decode_jp2(codestream: bytes) -> np.ndarray:
    """Decode one JPEG2000 sub-image tile to uint16.

    Backend order (override with ``OIP_JP2_BACKEND=cv2|pil``): OpenCV —
    the reference's own codec (``cv::imdecode``, aux_separator.h:383) —
    then Pillow's OpenJPEG binding.  The downlink tiles are losslessly
    coded (reversible 5/3), so every conforming decoder returns identical
    pixels; the fallback removes the framework's only hard OpenCV
    dependency (everything else is JAX/numpy/from-scratch)."""
    backend = os.environ.get("OIP_JP2_BACKEND", "")
    errors = []
    if backend in ("", "cv2"):
        try:
            import cv2

            img = cv2.imdecode(
                np.frombuffer(codestream, dtype=np.uint8),
                cv2.IMREAD_UNCHANGED,
            )
            if img is None:
                raise ValueError("JPEG2000 decode failed")
            return img.astype(np.uint16)
        except ImportError as e:
            if backend == "cv2":
                raise RuntimeError(
                    "OIP_JP2_BACKEND=cv2 but OpenCV is not importable"
                ) from e
            errors.append(f"cv2: {e}")
    if backend in ("", "pil"):
        try:
            import io

            from PIL import Image

            img = np.asarray(Image.open(io.BytesIO(codestream)))
            return img.astype(np.uint16)
        except Exception as e:
            # not just ImportError: Pillow built WITHOUT OpenJPEG raises
            # UnidentifiedImageError from Image.open — either way this
            # backend is unusable here and the diagnostic below must fire
            if backend == "pil":
                raise RuntimeError(
                    "OIP_JP2_BACKEND=pil but Pillow cannot decode "
                    f"JPEG2000 here ({type(e).__name__}: {e})"
                ) from e
            errors.append(f"PIL: {type(e).__name__}: {e}")
    if backend and backend not in ("cv2", "pil"):
        raise RuntimeError(
            f"unknown OIP_JP2_BACKEND={backend!r} (want cv2 or pil)"
        )
    raise RuntimeError(
        "JPEG2000 sub-image decoding needs OpenCV (cv2) or Pillow with "
        f"OpenJPEG; neither importable ({'; '.join(errors)}).  "
        "Uncompressed downlinks work without any codec."
    )


@dataclass
class AuxSeparator:
    input_file: str
    offset: int = 0
    out_dir: str | None = None
    # AOS scan chunk size: peak host RSS is a few chunks regardless of
    # downlink size (the reference mmaps instead, aux_separator.h:407);
    # modest chunks keep the one-time buffer page-fault cost low on
    # hosts where page faults are costly, while the reader thread hides
    # the per-chunk IO
    chunk_bytes: int = 0  # 0 -> OIP_AUXSEP_CHUNK env or 64 MB

    def __post_init__(self):
        self.is_imdt = self.input_file.upper().endswith(".IMDT")
        self.imdt_file = self.input_file if self.is_imdt else ""
        self.afi = AosFileInfo()
        if not self.is_imdt:
            name = os.path.basename(self.input_file)
            afi = parse_aos_file_info(name)
            if afi is None:
                afi = parse_aos_file_info(
                    os.path.basename(os.path.dirname(self.input_file))
                )
            if afi is None:
                raise ValueError("unrecognized AOS file name pattern")
            self.afi = afi
        # page-align the start offset like the reference (aux_separator.h:197-201)
        page = 4096
        if self.offset % page != 0:
            adjusted = self.offset // page * page
            logw(
                "offset not aligned with system memory page size, adjusted "
                "to %d (0x%X).", adjusted, adjusted,
            )
            self.offset = adjusted
        if not self.chunk_bytes:
            self.chunk_bytes = int(
                os.environ.get("OIP_AUXSEP_CHUNK", 64 << 20)
            )
        self._pool = None

    # ------------------------------------------------------------------
    def separate(self) -> dict[str, str]:
        """Run the full separation; returns the output file paths."""
        if not self.is_imdt:
            self._separate_aos()
        return self._separate_image_data()

    # -- stages 1+2 -----------------------------------------------------
    def _read_chunks(self):
        """Producer: read fixed-size chunks on a dedicated thread into a
        bounded queue — the reference's 2-thread producer/consumer overlap
        of file IO with scanning (aux_separator.h:233-238), with RSS still
        bounded.  Chunks live in a fixed pool of 3 reusable buffers
        (readinto), so the big allocations are page-faulted once, not per
        chunk; the consumer returns each buffer to the pool when done.
        Yields (data u8 array view, eof) pairs in order.
        """
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=1)
        pool: queue.Queue = queue.Queue()
        for _ in range(3):
            pool.put(np.empty(self.chunk_bytes, np.uint8))

        def reader():
            try:
                with open(self.input_file, "rb") as f:
                    f.seek(self.offset)
                    while True:
                        buf = pool.get()
                        n = f.readinto(memoryview(buf))
                        eof = n < self.chunk_bytes
                        q.put((buf, n, eof, None))
                        if eof:
                            break
            except Exception as e:  # noqa: BLE001 — surfaced to consumer
                q.put((None, 0, True, e))

        t = threading.Thread(target=reader, name="aos-reader", daemon=True)
        t.start()
        while True:
            buf, n, eof, err = q.get()
            if err is not None:
                raise err
            yield buf[:n], eof
            pool.put(buf)          # done with this chunk: recycle
            if eof:
                break
        t.join()

    def _separate_aos(self):
        """Chunked AOS scan + IMTR reassembly with carry-over at seams.

        A reader thread streams chunks (compute/IO overlap, see
        :meth:`_read_chunks`); each chunk is scanned in anonymous memory
        (the scan's random-access CRC gathers are far cheaper there than
        against a page-faulting mmap) with the reference cursor rules;
        unconsumed tail bytes — at most one frame plus a partial sync
        marker, or the sub-frame IMTR remainder — carry into the next
        chunk, so peak RSS is ~3 chunks for any downlink size."""
        total = os.stat(self.input_file).st_size - self.offset
        n_valid = n_empty = n_invalid = 0
        carry = np.zeros(0, np.uint8)
        imtr_tail = np.zeros(0, np.uint8)
        last_seq = 0
        n_payload = 0
        chid = 0
        f_imdt = None
        # reusable work + payload buffers: page-faulted once, not per chunk
        workbuf = np.empty(self.chunk_bytes + 4096, np.uint8)
        scan_out = np.empty(
            (workbuf.size // aos.AOS_FRAME_BYTES + 1) * aos.AOS_DATA_BYTES,
            np.uint8,
        )
        with stage("aos_scan", max(total, 0)):
            for chunk, eof in self._read_chunks():
                if chunk.size == 0 and not carry.size:
                    break
                if carry.size:
                    buf = workbuf[: carry.size + chunk.size]
                    buf[: carry.size] = carry
                    buf[carry.size :] = chunk
                else:
                    buf = chunk
                carry = np.zeros(0, np.uint8)
                nat = native.scan_aos(buf, scan_out)
                if nat is not None:
                    # single-pass native sweep: memmem + validate + CRC +
                    # payload copy with one traversal of the chunk
                    payloads, nv, ne, ni, cursor = nat
                    stream = payloads.reshape(-1)
                else:
                    res = aos.scan_aos_frames(buf)
                    nv = res.valid.size
                    ne = res.empty.size
                    ni = res.invalid.size
                    cursor = res.cursor
                    stream = aos.extract_aos_payloads(
                        buf, res.valid
                    ).reshape(-1)
                n_valid += nv
                n_empty += ne
                n_invalid += ni
                if not eof:
                    # candidates needing bytes past the chunk end start
                    # within the last frame_bytes-1 bytes; a truncated sync
                    # marker within the last 3
                    keep = max(
                        cursor,
                        buf.shape[0] - (aos.AOS_FRAME_BYTES - 1) - 3,
                    )
                    carry = buf[keep:].copy()

                blob = (
                    np.concatenate([imtr_tail, stream])
                    if imtr_tail.size
                    else stream
                )
                n_frames = blob.shape[0] // aos.IMTR_FRAME_BYTES
                imtr_tail = blob[n_frames * aos.IMTR_FRAME_BYTES :].copy()
                if n_frames == 0:
                    if eof:
                        break
                    continue
                imtr = aos.parse_imtr_stream(
                    blob[: n_frames * aos.IMTR_FRAME_BYTES], last_seq
                )
                for lo, hi in imtr.missing_ranges:
                    logw(
                        "missing or invalid image transfer frame(s) "
                        "#%08d-%08d", lo, hi,
                    )
                if imtr.seq.size:
                    last_seq = int(imtr.seq[-1])
                    if f_imdt is None:
                        chid = imtr.chid
                        self.imdt_file = os.path.join(
                            self.out_dir or os.getcwd(),
                            imdt_file_name(
                                self.afi, chid == aos.IMTR_CHID_CMOS1
                            ),
                        )
                        f_imdt = open(self.imdt_file, "wb")
                    f_imdt.write(memoryview(imtr.payload).cast("B"))
                    n_payload += imtr.payload.shape[0]
                if eof:
                    break
        if f_imdt is None:
            raise RuntimeError("no valid image transfer frames found")
        f_imdt.close()
        olog(
            "AOS frames: %d valid, %d empty, %d invalid.",
            n_valid, n_empty, n_invalid,
        )
        olog("%d frames parsed & written -> %s", n_payload, self.imdt_file)

    # -- stage 3 --------------------------------------------------------
    def _separate_image_data(self) -> dict[str, str]:
        sz = os.stat(self.imdt_file).st_size
        aux_path = build_output_file_path(
            self.imdt_file, "", AUX_FILE_EXT, out_dir=self.out_dir
        )
        pan_path = build_output_file_path(
            self.imdt_file, STEM_EXT_PAN, RAW_FILE_EXT, out_dir=self.out_dir
        )
        mss_path = build_output_file_path(
            self.imdt_file, STEM_EXT_MSS, RAW_FILE_EXT, out_dir=self.out_dir
        )
        # memory-map like the reference (aux_separator.h:275): frame reads
        # are sequential big slices, so RSS stays page-cache-bounded for
        # any IMDT size
        buf = np.memmap(self.imdt_file, dtype=np.uint8, mode="r")

        zero_aux = bytes(aos.IMGSIG_AUX_ALLBYTES)
        zero_pan = bytes(BYTES_PER_PANLINE * aos.IMGSIG_PAN_LINES)
        zero_mss = bytes(BYTES_PER_PANLINE * aos.IMGSIG_MSS_LINES)

        sigs = native.find_signatures(buf, aos.IMGSIG_SIG)
        last_seq = 0
        n_frames = 0
        with (
            open(aux_path, "wb") as f_aux,
            open(pan_path, "wb") as f_pan,
            open(mss_path, "wb") as f_mss,
            stage("imdt_extract", sz),
        ):
            cursor = 0
            pending = None   # one frame in flight: decode k+1 while writing k
            for sp in sigs.tolist():
                if sp < cursor:
                    continue
                if sp + aos.IMGSIG_META_BYTES > buf.shape[0]:
                    break
                meta = aos.parse_image_frame_meta(buf, sp)
                if meta.start < cursor:
                    # incomplete frame: data would begin before the cursor
                    olog("incomplete image frame #%05d, ignored.", meta.seq)
                    cursor = meta.frame_end
                    continue
                gap = meta.seq - last_seq - 1
                if gap > 0:
                    olog(
                        "Missing image frame(s) of range[%06d,%06d], "
                        "filling with zero data ...", last_seq + 1, meta.seq - 1,
                    )
                # submit this frame's tile work to the pool, then drain the
                # PREVIOUS frame while it decodes/swaps (the frame-level
                # producer/consumer overlap, aux_separator.h:233-238)
                submitted = (meta, gap, self._submit_frame(buf, meta))
                if pending is not None:
                    self._flush_frame(
                        pending, zero_aux, zero_pan, zero_mss,
                        f_aux, f_pan, f_mss,
                    )
                pending = submitted
                cursor = meta.frame_end
                last_seq = meta.seq
                n_frames += 1
            if pending is not None:
                self._flush_frame(
                    pending, zero_aux, zero_pan, zero_mss,
                    f_aux, f_pan, f_mss,
                )
        olog("%d image frames processed.", n_frames)
        return {"aux": aux_path, "pan": pan_path, "mss": mss_path}

    def _submit_frame(self, buf, meta: aos.ImageFrameMeta):
        """Slice the frame's 40 sub-image blocks and submit their
        inflate+byte-swap to the worker pool (compressed AND uncompressed:
        the pool covers JP2 decode, the raw memcpy, and the 16-bit swap).
        Returns (aux_bytes, ordered list of futures)."""
        aux_bytes = buf[
            meta.start : meta.start + aos.IMGSIG_AUX_ALLBYTES
        ].tobytes()
        p = meta.start + aos.IMGSIG_AUX_ALLBYTES
        n_vparts = aos.IMGSIG_PAN_VPARTS + aos.IMGSIG_MSS_VPARTS
        n_tiles = n_vparts * aos.IMGSIG_IMG_HPARTS
        pool = self._decode_pool()
        futures = []
        for idx in range(n_tiles):
            nbytes = int(meta.sub_image_dwords[idx]) * 4
            futures.append(
                pool.submit(
                    self._inflate_sub_image, meta.z_ratio, buf[p : p + nbytes]
                )
            )
            p += nbytes
        return aux_bytes, futures

    def _flush_frame(
        self, pending, zero_aux, zero_pan, zero_mss, f_aux, f_pan, f_mss
    ):
        """Write one completed frame in sequence order: the zero-fill for
        any preceding gap, the AUX block, then the merged image stripes."""
        meta, gap, (aux_bytes, futures) = pending
        for _ in range(gap):
            f_aux.write(zero_aux)
            f_pan.write(zero_pan)
            f_mss.write(zero_mss)
        f_aux.write(aux_bytes)

        stripe = np.empty(
            (aos.IMGSIG_IMBASE_LINES, aos.IMGSIG_IMG_HPARTS * aos.IMGSIG_IMBASE_COLS),
            np.uint16,
        )
        for idx, fut in enumerate(futures):
            tile = fut.result()
            r, c = divmod(idx, aos.IMGSIG_IMG_HPARTS)
            stripe[
                :, c * aos.IMGSIG_IMBASE_COLS : (c + 1) * aos.IMGSIG_IMBASE_COLS
            ] = tile
            if c == aos.IMGSIG_IMG_HPARTS - 1:
                (f_pan if r < aos.IMGSIG_PAN_VPARTS else f_mss).write(
                    memoryview(
                        np.ascontiguousarray(stripe, dtype="<u2")
                    ).cast("B")
                )

    def _decode_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="jp2",
            )
        return self._pool

    def _inflate_sub_image(self, z_ratio: int, block: np.ndarray) -> np.ndarray:
        shape = (aos.IMGSIG_IMBASE_LINES, aos.IMGSIG_IMBASE_COLS)
        if z_ratio == aos.IMGSIG_ZRTO_NONE:
            tile = np.frombuffer(block.tobytes(), dtype=np.uint16).reshape(shape)
            tile = tile.copy()
        else:
            zih = aos.parse_z_image_header(block)
            code = block[aos.Z_ZDATA_OFF : aos.Z_ZDATA_OFF + zih.data_dwords * 4]
            tile = _decode_jp2(code.tobytes()).reshape(shape)
        # unconditional big->little byte swap (aux_separator.h:387-392)
        return native.byteswap16(np.ascontiguousarray(tile, dtype=np.uint16))

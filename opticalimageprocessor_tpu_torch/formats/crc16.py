"""CRC-16/CCITT-FALSE, vectorised: poly 0x1021, init 0xFFFF, no
reflection, xorout 0 (reference ``CRC.h:1522-1526``), the check of every
AOS and image-transfer frame (``aux_separator.h:577-583,679-686``).  The
check value of ASCII "123456789" is 0x29B1 (``CRC.h:1519``).

* :func:`crc16_ccitt_false` — table-driven, one buffer at a time;
* :func:`crc16_ccitt_false_many` — vectorised over a batch of equal-length
  frames.

``native/oipnative.cpp`` has the fast path (``utils/native.crc16_many``);
this module is its portable fallback.

Copied from ``opticalimageprocessor_tpu/formats/crc16.py``.
"""

from __future__ import annotations

import numpy as np


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint16)
    for byte in range(256):
        crc = byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if (crc & 0x8000) else (crc << 1)
            crc &= 0xFFFF
        table[byte] = crc
    return table


_TABLE = _make_table()


def crc16_ccitt_false(data: bytes | np.ndarray, init: int = 0xFFFF) -> int:
    """CRC of a single buffer."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)
    ) else np.asarray(data, dtype=np.uint8)
    crc = init
    for b in buf.tolist():
        crc = ((crc << 8) & 0xFFFF) ^ int(_TABLE[((crc >> 8) ^ b) & 0xFF])
    return crc


def crc16_ccitt_false_many(frames: np.ndarray, init: int = 0xFFFF) -> np.ndarray:
    """CRC of a batch of frames.

    ``frames``: uint8 array of shape (n_frames, frame_len).  Returns a uint16
    array of per-frame CRCs.  Vectorises across frames (the byte dimension is
    inherently sequential), so throughput scales with batch size.
    """
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 2:
        raise ValueError("frames must be 2-D (n_frames, frame_len)")
    crc = np.full(frames.shape[0], init, dtype=np.uint16)
    for j in range(frames.shape[1]):
        idx = ((crc >> 8) ^ frames[:, j]).astype(np.uint16) & 0xFF
        crc = ((crc << 8) & np.uint16(0xFFFF)) ^ _TABLE[idx]
    return crc

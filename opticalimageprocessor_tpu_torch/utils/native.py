"""TIFF-flavour LZW through the repository's native host library
(``native/oipnative.cpp``, built by ``native/build.sh`` into
``native/liboipnative.so``), with a pure-python decoder when the library is
missing.

Copied from ``opticalimageprocessor_tpu/utils/native.py`` (the LZW entry
points only).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    return os.path.join(here, "native", "liboipnative.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        # try building it once
        build = os.path.join(os.path.dirname(path), "build.sh")
        if os.path.exists(build):
            os.system(f"sh {build} >/dev/null 2>&1")
    if os.path.exists(path):
        try:
            lib = ctypes.CDLL(path)
            lib.oip_lzw_encode.restype = ctypes.c_int64
            lib.oip_lzw_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.oip_lzw_decode.restype = ctypes.c_int64
            lib.oip_lzw_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ]
            _LIB = lib
        except OSError:
            _LIB = None
    return _LIB


def native_available() -> bool:
    return _load() is not None


def lzw_encode(data: bytes | np.ndarray) -> bytes | None:
    """TIFF-flavour LZW encode; None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    arr = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.ascontiguousarray(data, dtype=np.uint8)
    )
    cap = arr.size + (arr.size >> 1) + 1024
    out = np.empty(cap, dtype=np.uint8)
    n = lib.oip_lzw_encode(arr.ctypes.data, arr.size, out.ctypes.data, cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def lzw_decode(data: bytes, expected_size: int) -> bytes:
    """TIFF-flavour LZW decode (native fast path, python fallback)."""
    lib = _load()
    arr = np.frombuffer(data, dtype=np.uint8)
    if lib is not None:
        out = np.empty(expected_size, dtype=np.uint8)
        n = lib.oip_lzw_decode(arr.ctypes.data, arr.size, out.ctypes.data,
                               expected_size)
        if n >= 0:
            return out[:n].tobytes()
    return _lzw_decode_py(data, expected_size)


def _lzw_decode_py(data: bytes, expected_size: int) -> bytes:
    """Pure-python TIFF LZW decoder (slow; portability fallback)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    width = 9
    acc = 0
    nbits = 0
    prev: bytes | None = None
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= width:
            code = (acc >> (nbits - width)) & ((1 << width) - 1)
            nbits -= width
            if code == EOI:
                return bytes(out)
            if code == CLEAR:
                table = [bytes([i]) for i in range(256)] + [b"", b""]
                width = 9
                prev = None
                continue
            if code < len(table):
                entry = table[code]
            elif code == len(table) and prev is not None:
                entry = prev + prev[:1]
            else:
                raise ValueError("corrupt LZW stream")
            out += entry
            if prev is not None:
                table.append(prev + entry[:1])
                # decoder lags the encoder by one entry (libtiff convention)
                if len(table) == (1 << width) - 1 and width < 12:
                    width += 1
            prev = entry
            if len(out) >= expected_size:
                return bytes(out)
    return bytes(out)

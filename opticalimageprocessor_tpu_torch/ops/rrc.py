"""Relative Radiometric Correction: per-column gain/bias in float64.

Reference semantics (``imageop.h:129-138``)::

    dst[y,x] = (uint16_t)(k[x] * src[y,x] + b[x])     // k, b are C doubles

a float64 multiply then add, truncation toward zero through an int32
conversion (negative values wrap two's complement), and x86-64
``cvttsd2si``'s out-of-range result (|v| >= 2^31 or NaN -> 0x80000000,
whose low 16 bits are 0).

CUDA tensors go through kernel (a) (``csrc/rrc.cu``); CPU tensors through
:func:`_rrc_plain`, the same float64 math in PyTorch.  Parameters are the
float64 ``(k, b)`` pair itself; the JAX package's six-row float32 split
exists only because the TPU has no float64 (:func:`params_from_jax_split`
converts one back).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

_TWO31 = 2147483648.0


def params_from_jax_split(split6: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rebuild float64 ``(k, b)`` from the JAX package's
    ``split_rrc_params`` output (6, cols) float32.

    ``k = (k_ha + k_hb) + (k_lo + k_l2)`` comes back bit-exact; ``b =
    b_hi + b_lo`` only to ~2^-48 relative, because the split rounded
    ``b_lo`` — feed both packages from the same float64 ``(k, b)`` where
    they exist, and use this only where a split array is all there is.
    """
    s = np.asarray(split6, np.float64)
    k = (s[0] + s[1]) + (s[2] + s[3])
    b = s[4] + s[5]
    return k, b


def _rrc_plain(src: torch.Tensor, k: torch.Tensor, b: torch.Tensor):
    """Plain PyTorch RRC: ``src`` (..., rows, cols) uint16, ``k``/``b``
    (..., cols) float64 broadcast over rows.  ``mul`` then ``add`` as two
    ops (never a fused multiply-add)."""
    v = torch.add(torch.mul(k.unsqueeze(-2), src.to(torch.float64)),
                  b.unsqueeze(-2))
    in_range = v.abs() < _TWO31
    i = torch.where(in_range, torch.trunc(v), torch.zeros_like(v))
    return (i.to(torch.int64) & 0xFFFF).to(torch.uint16)


def _rrc_cuda(src: torch.Tensor, k: torch.Tensor, b: torch.Tensor):
    _build.require_cuda("rrc_apply", src, k, b)
    if src.dtype != torch.uint16:
        raise ValueError(f"rrc_apply: src must be uint16, got {src.dtype}")
    if k.dtype != torch.float64 or b.dtype != torch.float64:
        raise ValueError("rrc_apply: k and b must be float64")
    squeeze = src.dim() == 2
    s3 = src.unsqueeze(0) if squeeze else src
    if s3.dim() != 3:
        raise ValueError(f"rrc_apply: src must be 2-D or 3-D, got {src.shape}")
    batch, rows, cols = s3.shape
    k2 = k.reshape(-1, cols).expand(batch, cols).contiguous()
    b2 = b.reshape(-1, cols).expand(batch, cols).contiguous()
    out = torch.empty((batch, rows, cols), dtype=torch.uint16,
                      device=src.device)
    _build.launch(
        "rrc", "oip_rrc", s3.data_ptr(), out.data_ptr(), k2.data_ptr(),
        b2.data_ptr(), batch, rows, cols, s3.stride(1), s3.stride(0),
        _build.stream_of(src), device=src.device,
    )
    return out[0] if squeeze else out


def rrc_apply(src: torch.Tensor, k: torch.Tensor, b: torch.Tensor):
    """Apply RRC to a uint16 strip or a stack of strips.

    ``src``: (rows, cols) or (batch, rows, cols) uint16, last dimension
    contiguous (row/batch strides are honoured, so a window of a strip
    needs no copy); ``k``, ``b``: (cols,) or (batch, cols) float64.
    Returns a contiguous uint16 tensor shaped like ``src``.
    """
    if src.device.type == "cpu":
        return _rrc_plain(src, k, b)
    return _rrc_cuda(src, k, b)

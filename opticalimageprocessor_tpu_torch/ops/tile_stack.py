"""The registration's float32 tile stack, written once from the uint16
rows: kernel (h).

A run of ``n`` tiles of one section is a uint16 row block ``blk`` (...,
rows, n * cols) -- a view of a resident strip, a strip file's upload or a
line-sharded fetch, columns contiguous, any row and band strides -- and
:func:`write_tiles` writes its tiles, RRC'd when ``params`` (the block's
columns' float64 ``(k, b)``) is given, into tiles ``[t0, t0 + n)`` of one
contiguous float32 stack (T, ..., rows, cols).  The values are those of
``rrc_apply`` (kernel (a)) then a cast, in the same places as the
sections' tiles concatenated, bit for bit.

CUDA tensors go through kernel (h) (``csrc/tile_stack.cu``); CPU tensors
through :func:`_write_tiles_plain`, ``rrc_apply``'s plain path
(``_rrc_plain``) and a copy of the cast view.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils.logging import count
from .rrc import _rrc_plain


def _write_tiles_plain(stack, t0, blk, params, cols):
    if params is not None:
        blk = _rrc_plain(blk, *params)
    tiles = blk.reshape(*blk.shape[:-1], -1, cols).movedim(-2, 0)
    stack[t0:t0 + tiles.shape[0]].copy_(tiles)


def _write_tiles_cuda(stack, t0, blk, params, cols):
    if blk.dtype != torch.uint16 or stack.dtype != torch.float32:
        raise ValueError(f"write_tiles: blk must be uint16 and stack "
                         f"float32, got {blk.dtype} and {stack.dtype}")
    if blk.dim() not in (2, 3):
        raise ValueError(f"write_tiles: blk must be 2-D or 3-D, got "
                         f"{tuple(blk.shape)}")
    rows, run_cols = blk.shape[-2:]
    n = run_cols // cols
    if (cols <= 0 or n * cols != run_cols or not stack.is_contiguous()
            or tuple(stack.shape[1:]) != (*blk.shape[:-1], cols)
            or not 0 <= t0 <= stack.shape[0] - n):
        raise ValueError(
            f"write_tiles: no room for the {cols}-column tiles of a "
            f"{tuple(blk.shape)} block at tile {t0} of a "
            f"{'contiguous' if stack.is_contiguous() else 'strided'} "
            f"{tuple(stack.shape)} stack")
    if rows * cols % 4:
        # the kernel stores four floats at a time
        raise ValueError(f"write_tiles: {rows} x {cols} tiles hold no "
                         "whole number of 16-byte stores")
    bands = blk.shape[0] if blk.dim() == 3 else 1
    k = b = None
    pb = 0
    if params is not None:
        k, b = params
        if k.dtype != torch.float64 or b.dtype != torch.float64:
            raise ValueError("write_tiles: k and b must be float64")
        if (k.shape != b.shape or k.shape[-1] != run_cols
                or k.dim() > blk.dim() - 1
                or (k.dim() == 2 and k.shape[0] != bands)):
            raise ValueError(
                f"write_tiles: parameters {tuple(k.shape)} / "
                f"{tuple(b.shape)} do not fit a {tuple(blk.shape)} block")
    _build.require_cuda("write_tiles", stack, blk,
                        *(params if params is not None else ()))
    if stack.data_ptr() % 16:
        raise ValueError("write_tiles: the stack must be 16-byte aligned")
    if params is not None:
        if k.stride() != b.stride():
            k, b = k.contiguous(), b.contiguous()
        pb = k.stride(0) if k.dim() == 2 else 0
    _build.launch(
        "tile_stack", "oip_tile_stack", blk.data_ptr(),
        stack[t0:].data_ptr(),
        None if k is None else k.data_ptr(),
        None if b is None else b.data_ptr(), bands, rows, cols, n,
        blk.stride(-2), blk.stride(0) if blk.dim() == 3 else 0, pb,
        _build.stream_of(blk), device=blk.device,
    )


def write_tiles(stack: torch.Tensor, t0: int, blk: torch.Tensor, params,
                cols: int) -> None:
    """Write the ``cols``-column tiles of the uint16 row block ``blk``
    (rows, n * cols) or (bands, rows, n * cols), RRC'd when ``params``
    (``(k, b)``, float64 (n * cols,) or (bands, n * cols)) is given, into
    tiles ``[t0, t0 + n)`` of the contiguous float32 ``stack`` (T, rows,
    cols) or (T, bands, rows, cols).  Counts the ``n`` tiles as
    ``reg_stack_tiles`` while a profiler records."""
    n = blk.shape[-1] // cols
    if stack.device.type == "cpu":
        _write_tiles_plain(stack, t0, blk, params, cols)
    else:
        _write_tiles_cuda(stack, t0, blk, params, cols)
    count("reg_stack_tiles", n)

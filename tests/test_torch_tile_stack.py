"""Kernel (h), the registration's float32 tile stack
(opticalimageprocessor_tpu_torch.ops.tile_stack.write_tiles): the wrapper's
checks here, and on an NVIDIA card (marker ``cuda``) the kernel against its
plain version, bit for bit.

This file imports no JAX, so it also runs where the port runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_tile_stack.py
"""

import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu_torch import _build
from opticalimageprocessor_tpu_torch.models import device_pipeline as dp
from opticalimageprocessor_tpu_torch.ops import tile_stack

W, BW, COLS, BCOLS = 12288, 3072, 1228, 307   # the scene's geometry


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel (h) has no CPU form")
    return torch.device("cuda", 0)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["dtype", "stack_dtype", "dims", "ragged",
                                  "stack_shape", "no_room", "odd_tiles",
                                  "params_dtype", "params_shape"])
def test_wrapper_refuses_what_the_kernel_cannot_write(case):
    """Types and shapes the kernel does not take are refused before any
    launch (meta tensors, checked ahead of the device)."""
    u16, f32, f64 = torch.uint16, torch.float32, torch.float64
    blk, stack, params, t0 = _meta((64, 96), u16), _meta((4, 64, 32), f32), \
        None, 0
    cols = 32
    if case == "dtype":
        blk = _meta((64, 96), torch.int32)
    elif case == "stack_dtype":
        stack = _meta((4, 64, 32), f64)
    elif case == "dims":
        blk = _meta((2, 4, 64, 96), u16)
    elif case == "ragged":
        blk = _meta((64, 100), u16)
    elif case == "stack_shape":
        stack = _meta((4, 63, 32), f32)
    elif case == "no_room":
        t0 = 2
    elif case == "odd_tiles":
        blk, stack = _meta((63, 93), u16), _meta((4, 63, 31), f32)
        cols = 31
    elif case == "params_dtype":
        params = (_meta((96,), f32), _meta((96,), f32))
    else:
        params = (_meta((96,), f64), _meta((95,), f64))
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="write_tiles"):
        tile_stack.write_tiles(stack, t0, blk, params, cols)
    assert _build.LAUNCHES == before


def test_wrapper_raises_instead_of_falling_back(monkeypatch):
    """A tensor off the CPU never takes the plain version: without a CUDA
    device the wrapper raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="no kernel for meta"):
        tile_stack.write_tiles(_meta((4, 4, 64, 32), torch.float32), 1,
                               _meta((4, 64, 96), torch.uint16),
                               (_meta((4, 96), torch.float64),
                                _meta((4, 96), torch.float64)), 32)
    assert _build.LAUNCHES == before


def _params(rng, dev, *shape):
    """RRC (k, b) of ordinary gains and biases, with columns whose values
    wrap negative, reach 2^31 or more, or are NaN (as test_torch_rrc draws
    them)."""
    k = 0.98 + 0.04 * rng.random(shape)
    b = rng.normal(0, 20, shape)
    fk, fb = k.reshape(-1), b.reshape(-1)
    fk[1::7], fb[1::7] = -0.75, 30000.0
    fk[2::11] = 70000.0
    fk[3::13] = np.nan
    fb[4::17] = 2.0 ** 31
    fk[5::19], fb[5::19] = 2.0 ** 31, 0.0
    return (torch.from_numpy(k).to(dev), torch.from_numpy(b).to(dev))


def _both(stack_shape, t0, blk, params, cols):
    """The kernel's stack and the plain version's, each written into a
    NaN-filled stack (tiles outside the run must stay NaN)."""
    out = []
    for fn in (tile_stack._write_tiles_cuda, tile_stack._write_tiles_plain):
        s = torch.full(stack_shape, float("nan"), device=blk.device)
        fn(s, t0, blk, params, cols)
        out.append(s)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("inline_rrc", [False, True], ids=["raw", "rrc"])
@pytest.mark.parametrize("i0,i1", [(0, 10), (3, 8), (1, 2), (9, 10)])
def test_kernel_equals_plain_at_the_scene_shapes(card, inline_rrc, i0, i1):
    """A run of slices [i0, i1) of a 12288-px PAN strip (1228-column tiles,
    8-byte aligned) and of its 4 bands (307-column tiles: at odd i0 only
    2-byte aligned), at reduced rows, into tiles 2.. of a stack:
    torch.equal to the plain version, and no other tile touched."""
    rng = np.random.default_rng(10 * i0 + i1)
    pan = torch.from_numpy(rng.integers(0, 65536, (1003, W),
                                        dtype=np.uint16)).to(card)
    mss = torch.from_numpy(rng.integers(0, 65536, (4, 301, BW),
                                        dtype=np.uint16)).to(card)
    n = i1 - i0
    cases = [(pan[7:7 + 960, i0 * COLS:i1 * COLS], COLS, W),
             (mss[:, 5:5 + 240, i0 * BCOLS:i1 * BCOLS], BCOLS, BW)]
    for blk, cols, width in cases:
        params = None
        if inline_rrc:
            k, b = _params(rng, card, *blk.shape[:-2], width)
            params = (k[..., i0 * cols:i1 * cols], b[..., i0 * cols:i1 * cols])
        got, want = _both((n + 3, *blk.shape[:-1], cols), 2, blk, params,
                          cols)
        assert torch.equal(got[2:2 + n], want[2:2 + n])
        assert got[:2].isnan().all() and got[2 + n:].isnan().all()


@pytest.mark.cuda
@pytest.mark.parametrize("inline_rrc", [False, True], ids=["raw", "rrc"])
def test_kernel_equals_plain_on_strided_sources(card, inline_rrc):
    """Row sources with other strides: every other row of a strip (a row
    stride of two lines), the bands as the RAW MSS file lays them out
    (band-interleaved lines: a band stride of one band line, a row stride
    of four), a strip window at an odd column, and one row of parameters
    shared by every band."""
    rng = np.random.default_rng(5)
    pan = torch.from_numpy(rng.integers(0, 65536, (900, W),
                                        dtype=np.uint16)).to(card)
    lines = torch.from_numpy(rng.integers(0, 65536, (200, 4, BW),
                                          dtype=np.uint16)).to(card)
    bands = lines.transpose(0, 1)                       # (4, 200, BW) view
    runs = [(pan[::2, 2 * COLS:6 * COLS], COLS, W, 2 * COLS),
            (bands[:, 3:163, 3 * BCOLS:7 * BCOLS], BCOLS, BW, 3 * BCOLS),
            (pan[:64, 1:1 + 5 * BCOLS], BCOLS, W, 1)]
    for blk, cols, width, c0 in runs:
        params = None
        if inline_rrc:
            k, b = _params(rng, card, width)
            span = slice(c0, c0 + blk.shape[-1])
            params = (k[span], b[span])
        n = blk.shape[-1] // cols
        got, want = _both((n, *blk.shape[:-1], cols), 0, blk, params, cols)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_tile_stack_launches_ten_a_scene_registration(card):
    """The scene's registration (10 slices, 5 row blocks; 2048 rows
    here): one launch for the PAN and one for the bands a row block."""
    rng = np.random.default_rng(2)
    pan = torch.from_numpy(rng.integers(2000, 42000, (2048, W),
                                        dtype=np.uint16)).to(card)
    mss = torch.from_numpy(rng.integers(2000, 42000, (4, 512, BW),
                                        dtype=np.uint16)).to(card)
    params = dict(pan_params=_params(rng, card, W),
                  mss_params=_params(rng, card, 4, BW))
    _build.reset_launch_counts()
    dp.register_fast(pan, mss, slices=10, n_sections=5, **params)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["tile_stack"] == 10


@pytest.mark.cuda
def test_kernel_refuses_an_unaligned_stack(card):
    """The kernel stores four floats at a time: a stack that starts off a
    16-byte boundary is refused before any launch."""
    blk = torch.zeros((64, 2 * COLS), dtype=torch.int16,
                      device=card).view(torch.uint16)
    flat = torch.empty(2 * 64 * COLS + 1, device=card)
    stack = flat[1:].view(2, 64, COLS)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tile_stack.write_tiles(stack, 0, blk, None, COLS)
    assert _build.LAUNCHES == before

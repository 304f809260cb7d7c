"""Kernel (i), the registration's row DFTs, and the column transforms that
complete its spectra (opticalimageprocessor_tpu_torch.ops.row_fft): the
plain version of the algorithm against a float64 FFT, the tables, the
wrapper's checks, the column pass, the route by tile width and the CPU
route of ``correlate_tiles`` here; on an
NVIDIA card (marker ``cuda``) the kernel at the scene's shapes against a
float64 FFT and cuFFT's float32 one, the 2-D spectra, the bits of blocks of
tiles, kernel (b) on the column-major spectra and the registration at tile
widths (i) does not take.

This file imports no JAX, so it also runs where the port runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_row_fft.py
"""

import math

import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu_torch import _build
from opticalimageprocessor_tpu_torch.models import device_pipeline as dp
from opticalimageprocessor_tpu_torch.ops import phasecorr
from opticalimageprocessor_tpu_torch.ops import phasecorr_cuda as pcc
from opticalimageprocessor_tpu_torch.ops import resample
from opticalimageprocessor_tpu_torch.ops import row_fft

P, COLS, KEEP = 307, 1228, 615        # the scene's band and PAN tile widths
M, BM = 16000, 4000                   # their rows (the 160000-line scene)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel (i) has no CPU form")
    return torch.device("cuda", 0)


def _rel_rms(got, want) -> float:
    """The RMS of ``got - want`` over the RMS of ``want`` (float64)."""
    got, want = got.to(torch.complex128), want.to(torch.complex128)
    return float((got - want).abs().pow(2).mean().sqrt()
                 / want.abs().pow(2).mean().sqrt())


def _noise(shape, seed, device="cpu"):
    """uint16 DN as float32, as kernel (h) writes the tile stacks."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 65536, shape, generator=g, device=device,
                         dtype=torch.int32).to(torch.float32)


# ---------------------------------------------------------------- CPU --

@pytest.mark.parametrize("p", [P, 11, 7])
@pytest.mark.parametrize("shape", [(2, 6), (3, 5)], ids=["even", "ragged"])
@pytest.mark.parametrize("kind", ["pan", "band"])
def test_plain_version_is_the_float64_fft(kind, shape, p):
    """The plain version of (i)'s algorithm (the kernel's tables and split,
    float32) against ``torch.fft.rfft`` / ``fft`` in float64: at the
    scene's widths 1228 / 307 and at small odd primes, on an even and a
    ragged row count (a band row left without a pair)."""
    pan = kind == "pan"
    x = _noise((*shape, 4 * p if pan else p), 7 * p + shape[1])
    got = (row_fft._pan_rows_plain if pan else row_fft._band_rows_plain)(x, p)
    want = (torch.fft.rfft if pan else torch.fft.fft)(x.double())
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert _rel_rms(got, want) <= 3e-7


@pytest.mark.parametrize("p", [P, 13, 17])
def test_rader_plan(p):
    """g is a primitive root; p - 1 = f1 f2 coprime; the slots' inputs
    g^j and output bins g^-j each cover 1 .. p - 1 once and multiply to 1;
    bhat is the float64 DFT of the convolution's sequence at the bins of
    residues (q1, q2)."""
    plan = row_fft.rader_plan(p)
    n = p - 1
    assert len({pow(plan.g, e, p) for e in range(n)}) == n
    assert plan.f1 * plan.f2 == n and math.gcd(plan.f1, plan.f2) == 1
    assert sorted(plan.src.ravel()) == list(range(1, p))
    assert sorted(plan.dst.ravel()) == list(range(1, p))
    assert np.all(plan.src * plan.dst % p == 1)
    assert plan.bhat.dtype == np.complex64
    j = np.arange(n)
    b = np.exp(-2j * np.pi * np.array([pow(plan.g, -int(e), p) for e in j])
               / p)
    for q1, q2 in ((0, 0), (1 % plan.f1, 2), (plan.f1 - 1, plan.f2 - 1)):
        q = next(q for q in range(n) if q % plan.f1 == q1
                 and q % plan.f2 == q2)
        want = np.sum(b * np.exp(-2j * np.pi * j * q / n)) / n
        assert abs(plan.bhat[q1, q2] - want) <= 1e-7


def test_kernel_tables():
    """The tables' layout (the offsets csrc/row_fft.cu reads): staging a
    PAN row by ``stage`` puts x[(307 n1 + 4 n2) mod 1228] at float 4 slot
    + n1 of every slot, each float once; ``slot`` sends input n2 = src[p1,
    p2] to slot p2 f1 + p1 and n2 = 0 to slot 306; ``out`` is dst at
    [p2][p1]; ``bhat`` the plan's; the constants float64's cosines and
    sines rounded."""
    plan = row_fft.rader_plan(P)
    tab = row_fft.kernel_tables()
    assert tab.dtype == np.uint8 and tab.size == row_fft.TAB_BYTES

    def u16(off, n):
        return tab[off:off + 2 * n].view(np.uint16).astype(np.int64)

    stage = u16(row_fft.TAB_STAGE, 4 * P)
    slot = u16(row_fft.TAB_SLOT, P)
    out = u16(row_fft.TAB_OUT, P - 1).reshape(plan.f2, plan.f1)
    bhat = tab[row_fft.TAB_BHAT:row_fft.TAB_BHAT + 8 * (P - 1)].view(
        np.complex64).reshape(plan.f1, plan.f2)
    assert sorted(stage) == list(range(4 * P))
    x = np.arange(4 * P)
    staged = np.empty(4 * P, dtype=np.int64)
    staged[stage] = x
    n1, n2 = np.arange(4)[None, :], np.arange(P)[:, None]
    want = (P * n1 + 4 * n2) % (4 * P)
    assert np.array_equal(staged.reshape(P, 4)[slot], want)
    p1, p2 = np.meshgrid(np.arange(plan.f1), np.arange(plan.f2),
                         indexing="ij")
    assert np.array_equal(slot[plan.src], p2 * plan.f1 + p1)
    assert slot[0] == P - 1
    assert np.array_equal(out, plan.dst.T)
    assert np.array_equal(bhat, plan.bhat)
    c = row_fft.kernel_consts()
    a17, a9 = 2 * np.pi * np.arange(17) / 17, 2 * np.pi * np.arange(9) / 9
    assert np.array_equal(c, np.concatenate(
        [np.cos(a17), np.sin(a17), np.cos(a9), np.sin(a9)]).astype(np.float32))


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["dtype", "pan_width", "band_width", "dims",
                                  "strided", "rows"])
def test_wrapper_refuses_what_the_kernel_cannot_take(case):
    """Types and shapes the kernel does not take are refused before any
    launch (meta tensors, checked ahead of the device)."""
    pan, x = True, _meta((2, 8, COLS))
    if case == "dtype":
        x = _meta((2, 8, COLS), torch.float64)
    elif case == "pan_width":
        x = _meta((2, 8, COLS + 4))
    elif case == "band_width":
        pan, x = False, _meta((2, 4, 8, P - 1))
    elif case == "dims":
        x = _meta((COLS,))
    elif case == "strided":
        x = _meta((2, 8, 2 * COLS))[..., :COLS]
    else:
        x = _meta((4, 1 << 20, COLS))
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="row_dft"):
        row_fft._row_dft_cuda(x, pan)
    assert _build.LAUNCHES == before


def test_wrapper_raises_instead_of_falling_back(monkeypatch):
    """A tensor off the CPU never takes the plain version: without a CUDA
    device the wrapper raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = dict(_build.LAUNCHES)
    for fn, x in ((row_fft.pan_row_dft, _meta((2, 8, COLS))),
                  (row_fft.band_row_dft, _meta((2, 4, 8, P))),
                  (row_fft.pan_spectra, _meta((2, 8, COLS)))):
        with pytest.raises(RuntimeError, match="no kernel for meta"):
            fn(x)
    assert _build.LAUNCHES == before


def test_cpu_routes_are_torch_fft():
    """On CPU tensors the spectra are torch.fft's rfft2 / fft2, bit for
    bit, and the row DFTs the plain version."""
    pan, band = _noise((2, 64, 28), 1), _noise((2, 4, 16, 7), 2)
    assert torch.equal(row_fft.pan_spectra(pan), torch.fft.rfft2(pan))
    assert torch.equal(row_fft.band_spectra(band), torch.fft.fft2(band))
    assert torch.equal(row_fft.pan_row_dft(pan),
                       row_fft._pan_rows_plain(pan, 7))
    assert torch.equal(row_fft.band_row_dft(band),
                       row_fft._band_rows_plain(band, 7))


@pytest.mark.parametrize("tiles", [1, 3, 7, 13])
@pytest.mark.parametrize("kind", ["pan", "band"])
def test_column_pass_is_one_fft_over_the_contiguous_columns(
        monkeypatch, kind, tiles):
    """The column pass is one ``torch.fft.fft`` over the last axis of (i)'s
    column-major storage -- contiguous, so no copy and one batch stride --
    and gives the transforms over dim -2 of the spectra, as a kx-major view
    (the layout kernel (b) reads)."""
    shape = (tiles, 9, 40) if kind == "pan" else (tiles, 4, 7, 20)
    g = torch.Generator().manual_seed(tiles)
    storage = torch.complex(torch.randn(shape, generator=g),
                            torch.randn(shape, generator=g))
    rows = storage.transpose(-1, -2)          # (..., m, K), as (i) gives
    calls, real_fft = [], torch.fft.fft

    def fft(x, dim=-1):
        calls.append((x.is_contiguous(), dim))
        return real_fft(x, dim=dim)

    monkeypatch.setattr(torch.fft, "fft", fft)
    got = row_fft._columns(rows)
    assert calls == [(True, -1)]
    assert got.shape == rows.shape and pcc.is_kx_major(got)
    want = real_fft(rows.to(torch.complex128), dim=-2)
    assert _rel_rms(got, want) <= 1e-6


@pytest.mark.parametrize("slices", [8, 10, 12])
def test_spectra_take_kernel_i_only_at_its_widths(monkeypatch, slices):
    """On the card (meta tensors here) the spectra of 12288-pixel lines cut
    into 10 slices (tiles 4 x 307 wide) come from kernel (i) and the column
    pass; other slice counts keep cuFFT's rfft2 / fft2, copied to kernel
    (b)'s kx-major layout.  Both come kx-major, and the stacks are taken
    from the list."""
    cols = 12288 // slices
    calls = []

    def row_dft(x, pan):
        calls.append(("i", pan))
        k = x.shape[-1] // 2 + 1 if pan else x.shape[-1]
        return torch.empty((*x.shape[:-2], k, x.shape[-2]),
                           dtype=torch.complex64,
                           device=x.device).transpose(-1, -2)

    real_rfft2, real_fft2 = torch.fft.rfft2, torch.fft.fft2
    monkeypatch.setattr(row_fft, "_row_dft_cuda", row_dft)
    monkeypatch.setattr(torch.fft, "rfft2",
                        lambda x: calls.append("rfft2") or real_rfft2(x))
    monkeypatch.setattr(torch.fft, "fft2",
                        lambda x: calls.append("fft2") or real_fft2(x))
    stacks = [_meta((3, 64, cols)), _meta((3, 4, 16, cols // 4))]
    fpan, fband = row_fft.take_spectra(stacks)
    assert stacks == []
    assert calls == ([("i", True), ("i", False)] if slices == 10
                     else ["rfft2", "fft2"])
    assert fpan.shape == (3, 64, cols // 2 + 1)
    assert fband.shape == (3, 4, 16, cols // 4)
    assert fpan.dtype == fband.dtype == torch.complex64
    assert pcc.is_kx_major(fpan) and pcc.is_kx_major(fband)


def test_kx_major_layout():
    """Kernel (b)'s operand layout: a kx-major view comes back as it is,
    a row-major tensor as a kx-major copy of the same values."""
    x = torch.randn(3, 8, 5, dtype=torch.complex64)
    y = pcc.kx_major(x)
    assert y.shape == x.shape and torch.equal(y, x)
    assert y.transpose(-1, -2).is_contiguous()
    assert pcc.is_kx_major(y) and not pcc.is_kx_major(x)
    assert pcc.kx_major(y) is y


def test_correlate_tiles_on_the_cpu_calls_torch_fft(monkeypatch):
    """``correlate_tiles`` on CPU stacks takes its spectra from
    ``torch.fft.rfft2`` / ``fft2``, never from kernel (i), and its output
    is the cross-power of those spectra, unchanged."""
    geom = dp.register_geometry(256, 1280, slices=10, n_sections=1)
    base = _noise((3, geom.brows, geom.bcols), 5)
    pan = torch.nn.functional.interpolate(
        base[:, None], scale_factor=4, mode="nearest")[:, 0]
    band = torch.stack([torch.roll(base, (b % 2, b - 1), (1, 2))
                        for b in range(4)], dim=1)
    calls = []
    real_rfft2, real_fft2 = torch.fft.rfft2, torch.fft.fft2
    monkeypatch.setattr(torch.fft, "rfft2",
                        lambda x: calls.append("rfft2") or real_rfft2(x))
    monkeypatch.setattr(torch.fft, "fft2",
                        lambda x: calls.append("fft2") or real_fft2(x))

    def no_kernel(*a):
        raise AssertionError("kernel (i) called on CPU tensors")

    monkeypatch.setattr(row_fft, "_row_dft_cuda", no_kernel)
    got = dp.correlate_tiles(geom, [pan.clone(), band.clone()])
    assert calls == ["rfft2", "fft2"]
    win = phasecorr.clamp_win((64, 64), (geom.corr_rows, geom.cols))
    want = pcc.windowed_crosspower_fused_tiles(
        real_rfft2(pan), real_fft2(band), (geom.corr_rows, geom.cols),
        geom.brows, *win)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# --------------------------------------------------------------- card --

def _per_tile_errors(got, x, pan):
    """(i)'s and cuFFT's float32 relative RMS errors a tile against the
    float64 FFT of the same rows."""
    fn = torch.fft.rfft if pan else torch.fft.fft
    errs = []
    for t in range(x.shape[0]):
        want = fn(x[t].double())
        errs.append((_rel_rms(got[t], want), _rel_rms(fn(x[t]), want)))
        del want
    return errs


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pan", "band"])
def test_kernel_error_at_the_scene_shapes(card, kind):
    """(i) on the 160000-line scene's stacks (50 PAN tiles of (16000,
    1228), 50 band quads of (4, 4000, 307)): relative RMS error a tile at
    most 2e-6 and at most twice cuFFT's float32 error, against the float64
    FFT of the same rows."""
    pan = kind == "pan"
    x = _noise((50, M, COLS) if pan else (50, 4, BM, P), 26, card)
    got = (row_fft.pan_row_dft if pan else row_fft.band_row_dft)(x)
    assert got.shape == ((50, M, KEEP) if pan else x.shape)
    for err, lib in _per_tile_errors(got, x, pan):
        assert err <= 2e-6 and err <= 2 * lib, (err, lib)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 13, COLS), (3, 5, COLS), (7, P),
                                   (2, 3, 5, P), (1, 4, 33, P)])
def test_kernel_on_ragged_row_counts(card, shape):
    """Row counts that leave a group, or a band pair, part full: (i)
    against its plain version on the card and the float64 FFT."""
    x = _noise(shape, sum(shape), card)
    pan = shape[-1] == COLS
    got = (row_fft.pan_row_dft if pan else row_fft.band_row_dft)(x)
    plain = (row_fft._pan_rows_plain if pan else row_fft._band_rows_plain)(x)
    want = (torch.fft.rfft if pan else torch.fft.fft)(x.double())
    assert _rel_rms(got, want) <= 2e-6
    assert _rel_rms(got, plain) <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pan", "band"])
def test_spectra_against_cufft(card, kind):
    """(i) and the column pass against ``torch.fft.rfft2`` / ``fft2`` on
    three tiles: each tile's relative RMS error against the float64 2-D FFT
    at most 2e-6 and twice cuFFT's float32 error."""
    pan = kind == "pan"
    x = _noise((3, M, COLS) if pan else (3, 4, BM, P), 3, card)
    got = (row_fft.pan_spectra if pan else row_fft.band_spectra)(x)
    fn = torch.fft.rfft2 if pan else torch.fft.fft2
    for t in range(3):
        want = fn(x[t].double())
        err, lib = _rel_rms(got[t], want), _rel_rms(fn(x[t]), want)
        assert err <= 2e-6 and err <= 2 * lib, (t, err, lib)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pan", "band"])
def test_blocks_of_tiles_give_the_same_bits(card, kind):
    """Blocks of 1, 7 and 50 tiles (a line mesh's blocks, the resident
    scene's 50): every tile's spectrum bit for bit the same."""
    pan = kind == "pan"
    x = _noise((50, M, COLS) if pan else (50, 4, BM, P), 50, card)
    fn = row_fft.pan_spectra if pan else row_fft.band_spectra
    whole = fn(x)
    for t0, n in ((0, 1), (3, 7), (49, 1), (43, 7)):
        assert torch.equal(fn(x[t0:t0 + n].contiguous()), whole[t0:t0 + n])


@pytest.mark.cuda
def test_crosspower_reads_the_kx_major_spectra(card):
    """Kernel (b) reads (i)'s column-major spectra as they come (no copy):
    its D within 1e-5 relative of the plain cross-power of the same
    spectra; the same spectra row-major are refused."""
    base = _noise((2, BM, P), 9, card)
    pan = torch.repeat_interleave(base, 4, dim=1).repeat(1, 1, 4)
    bands = torch.stack([torch.roll(base, (b % 2, b - 1), (1, 2))
                         for b in range(4)], dim=1)
    fpan, fband = row_fft.pan_spectra(pan), row_fft.band_spectra(bands)
    assert pcc.is_kx_major(fpan) and pcc.is_kx_major(fband)
    hr = phasecorr.filter_response(BM, 4, card)
    hc = phasecorr.filter_response(P, 4, card)[:KEEP]
    ex = phasecorr.eval_consts(COLS, KEEP, 64, False, card)
    packed = pcc.packed_eval_operands(COLS, KEEP, 64, card)
    got = pcc._crosspower_cuda(fpan, fband, hr, hc, *ex, packed)
    want = pcc._crosspower_plain(fpan, fband, hr, hc, *ex)
    assert float((got - want).norm() / want.norm()) <= 1e-5
    before = dict(_build.LAUNCHES)
    for fp, fb in ((fpan.contiguous(), fband), (fpan, fband.contiguous())):
        with pytest.raises(ValueError, match="kx-major"):
            pcc._crosspower_cuda(fp, fb, hr, hc, *ex, packed)
    assert _build.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [8, 12])
def test_registration_at_other_slice_widths(card, slices):
    """12288-pixel lines cut into 8 or 12 slices (tiles 1536 / 1024 wide,
    which kernel (i) does not take): the card's registration runs on
    cuFFT's spectra, launches no (i), finds the constructed shifts and
    fits within 1e-3 px of the CPU route on the same strips."""
    g = torch.Generator(device=card).manual_seed(12)
    base = torch.randint(2000, 42000, (512, 3072), generator=g, device=card,
                         dtype=torch.int32)
    pan = resample.upsample4_f32(base.to(torch.float32)).round().clamp(
        0, 65535).to(torch.int32).to(torch.uint16)
    vy, vx = [0, -1, 1, 0], [1, 0, -1, 2]
    mss = torch.stack([torch.roll(base, (vy[b], vx[b]), (0, 1))
                       for b in range(4)]).to(torch.uint16)
    _build.reset_launch_counts()
    got, nv = dp.register_fast(pan, mss, slices=slices, n_sections=1)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["row_fft"] == 0
    want, nv_want = dp.register_fast(pan.cpu(), mss.cpu(), slices=slices,
                                     n_sections=1)
    assert torch.equal(nv.cpu(), nv_want)
    for b in range(4):
        cx, cy = got[b][0].cpu(), got[b][1].cpu()
        assert abs(float(cx[0]) - 4 * vx[b]) < 0.3, (b, cx)
        assert abs(float(cy[0]) - 4 * vy[b]) < 0.3, (b, cy)
        assert float((cx - want[b][0]).abs().max()) <= 1e-3
        assert float((cy - want[b][1]).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_row_fft_launches_two_a_registration(card):
    """The scene's registration (10 slices, 5 row blocks; 2048 rows here)
    takes one launch of (i) for the PAN and one for the bands."""
    g = torch.Generator(device=card).manual_seed(4)
    pan = torch.randint(2000, 42000, (2048, 12288), generator=g, device=card,
                        dtype=torch.int32).to(torch.uint16)
    mss = torch.randint(2000, 42000, (4, 512, 3072), generator=g, device=card,
                        dtype=torch.int32).to(torch.uint16)
    _build.reset_launch_counts()
    dp.register_fast(pan, mss, slices=10, n_sections=5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["row_fft"] == 2


@pytest.mark.cuda
def test_kernel_refuses_an_unaligned_stack(card):
    """The kernel loads 16 bytes at a time: a stack that starts off a
    16-byte boundary is refused before any launch."""
    flat = torch.empty(2 * 8 * COLS + 1, device=card)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        row_fft.pan_row_dft(flat[1:].view(2, 8, COLS))
    assert _build.LAUNCHES == before

"""Fused windowed cross-power of the fast registration: kernel (b).

Counterpart of ``opticalimageprocessor_tpu/ops/phasecorr_pallas.py``.
Per (tile, band, ky) the kernel forms the spectrally upsampled band
spectrum ``F_up = Hr*Hc*F_band[ky mod m, kx mod n]``, the whitened
cross-power ``Cn = C/|C|`` with ``C = F_pan*conj(F_up)``, and contracts kx
onto the 2*win_x+1 window columns with the TPU kernel's numerics: ``Cn``
and the evaluation matrices rounded to bfloat16, the products summed in
float32 (on the card: wgmma on the tensor cores).  It writes every (tile,
band) into one float32 matrix ``D`` (:func:`contract_rows_stacked`), so
that on the card the ky -> window-rows contraction of all of them is one
float32 kernel, (g); the centroid runs in PyTorch, as the JAX package
leaves both to XLA.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .phasecorr import (
    _centroid_on_window,
    contract_rows,
    eval_consts,
    filter_response,
)

# the kernel's tiling (csrc/crosspower.cu): a k16 step of the wgmma is
# KX_STEP complex columns (2*KX_STEP real K), window columns are padded to
# N_PAD; a work item is ITEM_REPS repeats (ky = rep*m + row) of
# ITEM_ROWS band rows, of ITEM_BANDS bands of one tile
KX_STEP = 8
N_PAD = 136
ITEM_ROWS = 8
ITEM_REPS = 4
ITEM_BANDS = 4


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to bfloat16 and back (the TPU kernel's GEMM inputs)."""
    return x.to(torch.bfloat16).to(torch.float32)


def whitened_bf16(fpan_t, fband_tb, hr, hc):
    """``bf16(Cn)`` of one (tile, band) as float32 (real, imaginary)
    (M, keep) tensors: ``F_up = Hr*Hc*F_band[ky mod m, kx mod n]`` and
    ``Cn = C/|C|`` (|C| == 0 -> divide by 1), ``C = F_pan*conj(F_up)``, in
    real float32 operations in the kernel's order, each one rounded as in
    IEEE arithmetic.  (torch's complex multiply and float32 sqrt are
    avoided: on the CPU their vector and scalar paths round differently,
    so a result would depend on how a tensor is split.)"""
    m, n = fband_tb.shape
    M, keep = fpan_t.shape
    ky = torch.arange(M, device=fpan_t.device) % m
    kx = torch.arange(keep, device=fpan_t.device) % n
    hr_re, hr_im = hr.real[:, None], hr.imag[:, None]
    hc_re, hc_im = hc.real[None, :], hc.imag[None, :]
    h_re = hr_re * hc_re - hr_im * hc_im
    h_im = hr_re * hc_im + hr_im * hc_re
    q = fband_tb[ky][:, kx]
    fur = h_re * q.real - h_im * q.imag
    fui = h_re * q.imag + h_im * q.real
    far, fai = fpan_t.real, fpan_t.imag
    pr = far * fur + fai * fui
    pi = fai * fur - far * fui
    # |C| correctly rounded, like the kernel's __fsqrt_rn (float32
    # torch.sqrt on the CPU is not, everywhere)
    mag = torch.sqrt((pr * pr + pi * pi).double()).float()
    den = torch.where(mag == 0, torch.ones_like(mag), mag)
    return _bf16(pr / den), _bf16(pi / den)


def _crosspower_plain(fpan, fband, hr, hc, ex_c, ex_s):
    """Plain PyTorch windowed cross-power ``sum_kx Cn[ky, kx] (Ex_c + i
    Ex_s)[kx, w]`` of every (tile, band), in kernel (b)'s layout ``D``
    (:func:`stacked_columns`): (2M, T*NB*wx) float32, the real parts in
    rows 0..M-1 and the imaginary parts in rows M..2M-1.  ``Cn``, ``Ex_c``
    and ``Ex_s`` are rounded to bfloat16 and the products summed in float32
    (the TPU kernel's contract; bf16 x bf16 products are exact in float32),
    one (tile, band) at a time to bound memory."""
    tiles, n_bands = fband.shape[:2]
    M = fpan.shape[-2]
    wx = ex_c.shape[1]
    ec, es = _bf16(ex_c), _bf16(ex_s)
    d = torch.empty((2 * M, tiles * n_bands * wx), dtype=torch.float32,
                    device=fpan.device)
    for t in range(tiles):
        for b in range(n_bands):
            cr, ci = whitened_bf16(fpan[t], fband[t, b], hr, hc)
            cols = stacked_columns(t * n_bands + b, wx)
            d[:M, cols] = torch.matmul(cr, ec) - torch.matmul(ci, es)
            d[M:, cols] = torch.matmul(ci, ec) + torch.matmul(cr, es)
    return d


def stacked_columns(pair: int, wx: int) -> slice:
    """The columns of ``D`` that hold (tile, band) pair ``pair`` = tile *
    NB + band: its ``wx`` window columns, in order."""
    return slice(pair * wx, (pair + 1) * wx)


# kernel (g), csrc/ky_gemm.cu: the shifts s = 1..KY_S in its register
# tiles, the columns of its W^T (KY_S, then s = 0, then padding), its
# stages of rows of D and the stages of a slice of M
KY_S = 64
KY_WP = 68
KY_STAGE = 8
KY_SLICE_STAGES = 400


def ky_gemm_splits(M: int) -> int:
    """The slices of each half of ``D`` that kernel (g) sums apart and then
    adds in order: from M alone (5 at the scene's M = 16000, so that its
    202 blocks of 128 columns by 2 halves make 2020 blocks, near-even work
    for 132 SMs), never from the number of columns, which would change a
    column's sums with it."""
    stages = -(-M // KY_STAGE)
    return max(1, -(-stages // KY_SLICE_STAGES))


def _ky_slices(M: int):
    """Kernel (g)'s slices of a half's M rows: (k0, k1) each, in the order
    it adds them."""
    stages, splits = -(-M // KY_STAGE), ky_gemm_splits(M)
    return [(min(M, KY_STAGE * (stages * s // splits)),
             min(M, KY_STAGE * (stages * (s + 1) // splits)))
            for s in range(splits)]


def _ky_weights(M: int, win_y: int, device) -> torch.Tensor:
    """Kernel (g)'s W^T, (2M, KY_WP) float32: row k < M holds cos(2 pi k s
    / M) for s = 1..win_y and, in column KY_S, s = 0; row M + k holds sin(2
    pi k s / M); zero elsewhere.  Taken from the evaluation matrices'
    columns of s >= 0 (``cy_c[k, win_y + s]`` and ``-cy_s[k, win_y +
    s]``): they are even / odd in s to the bit, so the columns of s < 0
    are the same numbers (tests/test_torch_phasecorr.py checks)."""
    cy_c, cy_s = eval_consts(M, M, win_y, True, device)
    wt = torch.zeros((2 * M, KY_WP), dtype=torch.float32, device=device)
    wt[:M, :win_y] = cy_c[:, win_y + 1:]
    wt[:M, KY_S] = cy_c[:, win_y]
    torch.neg(cy_s[:, win_y + 1:], out=wt[M:, :win_y])
    return wt


def _ky_combine(a: torch.Tensor, b: torch.Tensor, win_y: int):
    """Window rows from kernel (g)'s sums: (KY_S + 1, C) ``a`` (rows s =
    1..KY_S, then s = 0) and ``b`` -> (2*win_y+1, C), row win_y +- s = a(s)
    +- b(s), row win_y = a(0)."""
    out = torch.empty((2 * win_y + 1, a.shape[1]), dtype=a.dtype,
                      device=a.device)
    out[win_y] = a[KY_S]
    out[win_y + 1:] = a[:win_y] + b[:win_y]
    out[:win_y] = (a[:win_y] - b[:win_y]).flip(0)
    return out


def _ky_gemm_plain(wt: torch.Tensor, d: torch.Tensor, M: int,
                   win_y: int) -> torch.Tensor:
    """Plain version of kernel (g): each half's sums ``wt[half].T @
    d[half]`` as a float32 matmul a slice of M rows, the slices added in
    order, then :func:`_ky_combine` -> (2*win_y+1, C)."""
    sums = []
    for h in (0, 1):
        acc = None
        for k0, k1 in _ky_slices(M):
            rows = slice(h * M + k0, h * M + k1)
            part = torch.matmul(wt[rows, :KY_S + 1].T, d[rows])
            acc = part if acc is None else acc + part
        sums.append(acc)
    return _ky_combine(*sums, win_y)


def _ky_gemm_cuda(wt: torch.Tensor, d: torch.Tensor, M: int,
                  win_y: int) -> torch.Tensor:
    """Kernel (g) on CUDA tensors -> (2*win_y+1, C): each column summed in
    one fixed order whatever C is."""
    cols = d.shape[1]
    if wt.shape != (2 * M, KY_WP) or d.shape[0] != 2 * M:
        raise ValueError(f"ky_gemm: W^T of shape {tuple(wt.shape)} and D of "
                         f"{tuple(d.shape)} for M {M}")
    _build.require_cuda("contract_rows_stacked", wt, d)
    if wt.dtype != torch.float32 or d.dtype != torch.float32:
        raise ValueError("ky_gemm: operands must be float32")
    wt, d = wt.contiguous(), d.contiguous()
    splits = ky_gemm_splits(M)
    ws = torch.empty((2, splits, KY_S + 1, cols), dtype=torch.float32,
                     device=d.device)
    out = torch.empty((2 * win_y + 1, cols), dtype=torch.float32,
                      device=d.device)
    _build.launch("ky_gemm", "oip_ky_gemm", wt.data_ptr(), d.data_ptr(),
                  ws.data_ptr(), out.data_ptr(), M, cols, splits, win_y,
                  _build.stream_of(d), device=d.device)
    return out


def contract_rows_stacked(d: torch.Tensor, M: int, N: int, win_y: int,
                          tiles: int, n_bands: int) -> torch.Tensor:
    """``phasecorr.contract_rows`` of every (tile, band) of ``D`` at once:
    ``D``'s rows hold ``dr`` over ``di`` (2M, T*NB*wx), so window row
    win_y + sigma of every pair is ``A(sigma) + B(sigma)``, ``A`` the cos
    rows over ``dr`` and ``B`` the sin rows over ``di`` -- ``cy_c.T @ dr``
    and ``-cy_s.T @ di`` -- / (M*N).  Since ``A(-s) = A(s)`` and ``B(-s) =
    -B(s)``, both are summed for s = 0..win_y only: half the work of the
    (2*win_y+1)-row product, in float32, with only the order of the sums
    changed.  On the card kernel (g) (``csrc/ky_gemm.cu``) sums each column
    in an order that does not depend on T, so a line-mesh shard's tiles
    read as the whole scene's; on the CPU its plain version.  ``W^T`` is
    built at each call (8.7 MB at the scene's M; microseconds), not kept,
    so that it never adds to the scene's peak memory.  -> (T, NB,
    2*win_y+1, wx)."""
    if win_y > KY_S or d.shape[0] != 2 * M:
        raise ValueError(f"ky contraction: win_y {win_y} (at most {KY_S}), "
                         f"D of {d.shape[0]} rows for M {M}")
    wt = _ky_weights(M, win_y, d.device)
    gemm = _ky_gemm_plain if d.device.type == "cpu" else _ky_gemm_cuda
    out = gemm(wt, d, M, win_y)
    out /= float(M * N)
    return out.view(2 * win_y + 1, tiles, n_bands, -1).permute(1, 2, 0, 3)


def _contract_rows_plain(d: torch.Tensor, M: int, N: int, win_y: int,
                         tiles: int, n_bands: int) -> torch.Tensor:
    """The CPU route's ky contraction: ``phasecorr.contract_rows`` pair by
    pair on ``D``'s halves copied back to (T, NB, M, wx), the order of sums
    that the benchmark's plain reference (``portbench/reference.py``)
    takes, so that a CPU run reads the reference's estimates exactly (the
    stacked order moves a small CPU scene's fit by ~1.5e-5 px)."""
    dr, di = (half.reshape(M, tiles, n_bands, -1).permute(1, 2, 0, 3)
              .contiguous() for half in (d[:M], d[M:]))
    return contract_rows(dr, di, M, N, win_y)


def pack_eval_operands(ex_c: torch.Tensor, ex_s: torch.Tensor) -> torch.Tensor:
    """The kernel's B operand: ``[Ec ; Es]`` in bfloat16, interleaved by kx
    and laid out as the wgmma descriptors of csrc/crosspower.cu read it.
    Both products read it: ``D_re = [Cr, -Ci] @ B``, ``D_im = [Ci, Cr] @
    B``.

    Shape (steps, 2, N_PAD, 8), steps = ceil(keep / KX_STEP): for k16 step
    s, K half h, window column w and element e, element [s, h, w, e] is
    real K row k = 8*h + e of the step, which holds

        Ec[kx, w] for even e, Es[kx, w] for odd e,  kx = KX_STEP*s + 2*(e//2) + h

    (K slot j = k//2 holds kx 2j for j < 4 and 2(j - 4) + 1 after: a
    thread's two kx of a step are adjacent), and 0 for kx >= keep or w >=
    wx.  Each (s, h) slab is K-major core matrices of 8 columns x 16 bytes,
    and consecutive steps are contiguous, so a stage of steps is one copy
    into shared memory."""
    keep, wx = ex_c.shape
    if wx > N_PAD:
        raise ValueError(f"crosspower: {wx} window columns above {N_PAD}")
    steps = -(-keep // KX_STEP)
    kp = steps * KX_STEP
    ecs = torch.zeros((kp, N_PAD, 2), dtype=torch.bfloat16,
                      device=ex_c.device)
    ecs[:keep, :wx, 0] = ex_c.to(torch.bfloat16)
    ecs[:keep, :wx, 1] = ex_s.to(torch.bfloat16)
    # kx = 8 s + 2 i + h -> [s, h, w, (i, Ec|Es)]
    ecs = ecs.reshape(steps, KX_STEP // 2, 2, N_PAD, 2)
    return ecs.permute(0, 2, 3, 1, 4).reshape(steps, 2, N_PAD, 8).contiguous()


def crosspower_schedule(tiles: int, n_bands: int, M: int, m: int,
                        sms: int) -> tuple[int, int, int, int]:
    """Kernel (b)'s persistent launch: (grid, items, rep_groups,
    row_blocks).

    A tile's ky rows are ``reps`` = ceil(M / m) repeats of the m band rows
    (ky = rep*m + row), and row ky reads band row ky mod m.  A work item
    takes ITEM_ROWS band rows (``row_blocks`` blocks, the last ragged
    where m is no multiple of it) of ITEM_REPS repeats (``rep_groups``
    groups) of ITEM_BANDS bands, so each band row it loads serves four ky
    rows.  ``grid`` blocks (one an SM, at most one an item) take items
    ``b, b + grid, ...`` (:func:`crosspower_item`)."""
    reps = -(-M // m)
    rep_groups = -(-reps // ITEM_REPS)
    row_blocks = -(-min(m, M) // ITEM_ROWS)
    quads = -(-n_bands // ITEM_BANDS)
    items = tiles * quads * rep_groups * row_blocks
    return max(1, min(items, sms)), items, rep_groups, row_blocks


def crosspower_item(i: int, n_bands: int, M: int, m: int, rep_groups: int,
                    row_blocks: int) -> tuple[int, int, list[int]]:
    """Item ``i`` as the kernel decodes it: (tile, first band, its ky
    rows).  Its bands are first .. first + ITEM_BANDS - 1 (those below
    n_bands); a consumer warp takes one repeat's ITEM_ROWS contiguous ky
    rows, those with a band row below m and a ky below M."""
    row0 = ITEM_ROWS * (i % row_blocks)
    i //= row_blocks
    rep0 = ITEM_REPS * (i % rep_groups)
    i //= rep_groups
    quads = -(-n_bands // ITEM_BANDS)
    rows = []
    for rep in range(rep0, rep0 + ITEM_REPS):
        ky = min(rep * m, M) + row0
        rows += range(ky, ky + min(ITEM_ROWS, m - row0, M - ky))
    return i // quads, (i % quads) * ITEM_BANDS, rows


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=16)
def packed_eval_operands(n: int, keep: int, win: int, device) -> torch.Tensor:
    """:func:`pack_eval_operands` of ``eval_consts(n, keep, win, False)``,
    packed once per (shape, device); callers must not modify it."""
    return pack_eval_operands(*eval_consts(n, keep, win, False, device))


def is_kx_major(x: torch.Tensor) -> bool:
    """Whether ``x`` (..., rows, K) is a view of contiguous (..., K, rows)
    storage, each matrix kx-major, the layout kernel (b) reads."""
    return x.transpose(-1, -2).is_contiguous()


def kx_major(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., rows, K) as kernel (b) reads it: ``x`` itself where it is
    kx-major (:func:`is_kx_major`, as ``ops/row_fft``'s spectra come), else
    a kx-major copy."""
    if is_kx_major(x):
        return x
    return x.transpose(-1, -2).contiguous().transpose(-1, -2)


def _crosspower_cuda(fpan, fband, hr, hc, ex_c, ex_s, packed):
    """Kernel (b) on CUDA tensors; ``packed`` is
    ``pack_eval_operands(ex_c, ex_s)``; the spectra must be kx-major
    (:func:`is_kx_major`).  -> ``D``, (2M, T*NB*wx) float32:
    the real parts in rows 0..M-1, the imaginary parts in rows M..2M-1,
    (tile, band) pair p = tile * NB + band in columns
    :func:`stacked_columns` (p, wx), as :func:`_crosspower_plain`."""
    tiles, n_bands, m, n = fband.shape
    M, keep = fpan.shape[-2], fpan.shape[-1]
    wx = ex_c.shape[1]
    if (fpan.shape != (tiles, M, keep) or hr.shape != (M,)
            or hc.shape != (keep,) or ex_c.shape != (keep, wx)
            or ex_s.shape != (keep, wx)):
        raise ValueError(
            f"crosspower: shapes fpan {tuple(fpan.shape)}, fband "
            f"{tuple(fband.shape)}, hr {tuple(hr.shape)}, hc "
            f"{tuple(hc.shape)}, ex {tuple(ex_c.shape)}/{tuple(ex_s.shape)}"
            " do not agree"
        )
    if fpan.device.type == "cuda" and not (is_kx_major(fpan)
                                          and is_kx_major(fband)):
        raise ValueError("crosspower: the spectra must be kx-major, views of "
                         "(..., K, rows) storage (kx_major copies them so)")
    _build.require_cuda("windowed_crosspower_fused_tiles",
                        fpan.transpose(-1, -2), fband.transpose(-1, -2), hr,
                        hc, ex_c, ex_s)
    for t in (fpan, fband, hr, hc):
        if t.dtype != torch.complex64:
            raise ValueError("crosspower: spectra must be complex64")
    if ex_c.dtype != torch.float32 or ex_s.dtype != torch.float32:
        raise ValueError("crosspower: evaluation matrices must be float32")
    steps = -(-keep // KX_STEP)
    if (packed.shape != (steps, 2, N_PAD, 8)
            or packed.dtype != torch.bfloat16 or packed.device != fpan.device
            or not packed.is_contiguous()):
        raise ValueError("crosspower: packed B is not pack_eval_operands' "
                         f"layout for keep {keep}")
    hr, hc = hr.contiguous(), hc.contiguous()
    d = torch.empty((2 * M, tiles * n_bands * wx), dtype=torch.float32,
                    device=fpan.device)
    grid, items, rep_groups, row_blocks = crosspower_schedule(
        tiles, n_bands, M, m, _sm_count(fpan.device))
    _build.launch(
        "crosspower", "oip_crosspower", fpan.data_ptr(), fband.data_ptr(),
        hr.data_ptr(), hc.data_ptr(), packed.data_ptr(), d.data_ptr(), tiles,
        n_bands, M, keep, m, n, wx, grid, items, rep_groups, row_blocks,
        _build.stream_of(fpan), device=fpan.device,
    )
    return d


def windowed_crosspower_fused_tiles(
    fpan: torch.Tensor,
    fband: torch.Tensor,
    pad_to: tuple[int, int],
    m_small: int,
    win_y: int = 64,
    win_x: int = 64,
):
    """Windowed correlation peaks of every (tile, band) pair.

    ``fpan``: (T, M, keep) complex64 PAN half spectra; ``fband``:
    (T, NB, m_small, n_small) complex64 full band spectra, with
    ``M = factor * m_small`` (on the card kx-major, as ``ops/row_fft``
    gives them: :func:`is_kx_major`; other layouts are refused).  Returns
    (dx, dy, response), each (T, NB), with the semantics of
    ``phasecorr.peak_from_spectra_windowed`` fed by
    ``phasecorr.upsampled_band_spectrum``.  The cross-power comes as
    ``D``, (2M, T*NB*wx) float32 with the real parts over the imaginary
    ones: on the card from kernel (b), taken to the windows by one
    :func:`contract_rows_stacked` (kernel (g)); on the CPU from
    :func:`_crosspower_plain`, taken to the windows pair by pair by
    :func:`_contract_rows_plain`.
    """
    M, N = pad_to
    keep = fpan.shape[-1]
    n_small = fband.shape[-1]
    factor = M // m_small
    if factor * m_small != M or fpan.shape[-2] != M:
        raise ValueError(f"PAN spectrum rows {M} != factor * {m_small}")
    if 2 * win_x + 1 > N_PAD:
        raise ValueError(f"win_x {win_x} above the kernel's {(N_PAD - 1) // 2}")
    dev = fpan.device
    hr = filter_response(m_small, factor, dev)
    hc = filter_response(n_small, factor, dev)[:keep]
    ex_c, ex_s = eval_consts(N, keep, win_x, False, dev)
    args = (fpan, fband, hr, hc, ex_c, ex_s)
    if dev.type == "cpu":
        corr = _contract_rows_plain(_crosspower_plain(*args), M, N, win_y,
                                    *fband.shape[:2])
    else:
        d = _crosspower_cuda(*args, packed_eval_operands(N, keep, win_x, dev))
        corr = contract_rows_stacked(d, M, N, win_y, *fband.shape[:2])
    return _centroid_on_window(corr, win_y, win_x)

"""Fused windowed cross-power of the fast registration: kernel (b).

Counterpart of ``opticalimageprocessor_tpu/ops/phasecorr_pallas.py``.
Per (tile, band, ky) the kernel forms the spectrally upsampled band
spectrum ``F_up = Hr*Hc*F_band[ky mod m, kx mod n]``, the whitened
cross-power ``Cn = C/|C|`` with ``C = F_pan*conj(F_up)``, and contracts kx
onto the 2*win_x+1 window columns with the TPU kernel's numerics: ``Cn``
and the evaluation matrices rounded to bfloat16, the products summed in
float32 (on the card: wgmma on the tensor cores).  The small ky ->
window-rows contraction is a batched ``torch.matmul`` and the centroid runs
in PyTorch, as the JAX package leaves both to XLA.
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

# the kernel's tiling (csrc/crosspower.cu): kx in chunks of KX_CHUNK
# complex columns (2*KX_CHUNK real K), window columns padded to N_PAD
KX_CHUNK = 16
N_PAD = 136


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
    """Plain PyTorch windowed cross-power: (T, NB, M, wx) real and
    imaginary parts of ``sum_kx Cn[ky, kx] (Ex_c + i Ex_s)[kx, w]``, with
    ``Cn``, ``Ex_c`` and ``Ex_s`` rounded to bfloat16 and the products
    summed in float32 (the TPU kernel's contract; bf16 x bf16 products are
    exact in float32), one (tile, band) at a time to bound memory."""
    tiles, n_bands = fband.shape[:2]
    M = fpan.shape[-2]
    ec, es = _bf16(ex_c), _bf16(ex_s)
    out_re = torch.empty((tiles, n_bands, M, ex_c.shape[1]),
                         dtype=torch.float32, device=fpan.device)
    out_im = torch.empty_like(out_re)
    for t in range(tiles):
        for b in range(n_bands):
            cr, ci = whitened_bf16(fpan[t], fband[t, b], hr, hc)
            out_re[t, b] = torch.matmul(cr, ec) - torch.matmul(ci, es)
            out_im[t, b] = torch.matmul(ci, ec) + torch.matmul(cr, es)
    return out_re, out_im


def pack_eval_operands(ex_c: torch.Tensor, ex_s: torch.Tensor) -> torch.Tensor:
    """The kernel's B operand: ``[[Ec, Es], [-Es, Ec]]`` in bfloat16, laid
    out as the wgmma descriptors of csrc/crosspower.cu read it.

    Shape (chunks, 2, 2*KX_CHUNK/8, N_PAD, 8), chunks = ceil(keep /
    KX_CHUNK): for chunk c, part p (0: the real output, 1: the imaginary
    one), real K index q = 8*j + e (q < KX_CHUNK: the Cr rows of kx = c*
    KX_CHUNK + q; q >= KX_CHUNK: the Ci rows of kx = c*KX_CHUNK + q -
    KX_CHUNK) and window column w, element [c, p, j, w, e] is

        p = 0: Ec[kx, w] (Cr rows), -Es[kx, w] (Ci rows)
        p = 1: Es[kx, w] (Cr rows),  Ec[kx, w] (Ci rows)

    and 0 for kx >= keep or w >= wx.  Each (c, p, j) slab is K-major
    core matrices of 8 columns x 16 bytes, so one chunk is one contiguous
    copy into shared memory."""
    keep, wx = ex_c.shape
    if wx > N_PAD:
        raise ValueError(f"crosspower: {wx} window columns above {N_PAD}")
    chunks = -(-keep // KX_CHUNK)
    kp = chunks * KX_CHUNK
    dev = ex_c.device
    ec = torch.zeros((kp, N_PAD), dtype=torch.bfloat16, device=dev)
    es = torch.zeros_like(ec)
    ec[:keep, :wx] = ex_c.to(torch.bfloat16)
    es[:keep, :wx] = ex_s.to(torch.bfloat16)
    ec = ec.reshape(chunks, KX_CHUNK, N_PAD)
    es = es.reshape(chunks, KX_CHUNK, N_PAD)
    b_re = torch.cat([ec, -es], dim=1)         # (chunks, 2*KX_CHUNK, N_PAD)
    b_im = torch.cat([es, ec], dim=1)
    b = torch.stack([b_re, b_im], dim=1)       # (chunks, 2, 2*KX_CHUNK, N)
    b = b.reshape(chunks, 2, 2 * KX_CHUNK // 8, 8, N_PAD)
    return b.permute(0, 1, 2, 4, 3).contiguous()


@functools.lru_cache(maxsize=16)
def packed_eval_operands(n: int, keep: int, win: int, device) -> torch.Tensor:
    """:func:`pack_eval_operands` of ``eval_consts(n, keep, win, False)``,
    packed once per (shape, device); callers must not modify it."""
    return pack_eval_operands(*eval_consts(n, keep, win, False, device))


def _crosspower_cuda(fpan, fband, hr, hc, ex_c, ex_s, packed):
    """Kernel (b) on CUDA tensors; ``packed`` is
    ``pack_eval_operands(ex_c, ex_s)``."""
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
    _build.require_cuda("windowed_crosspower_fused_tiles", fpan, fband, hr,
                        hc, ex_c, ex_s)
    for t in (fpan, fband, hr, hc):
        if t.dtype != torch.complex64:
            raise ValueError("crosspower: spectra must be complex64")
    if ex_c.dtype != torch.float32 or ex_s.dtype != torch.float32:
        raise ValueError("crosspower: evaluation matrices must be float32")
    chunks = -(-keep // KX_CHUNK)
    if (packed.shape != (chunks, 2, 2 * KX_CHUNK // 8, N_PAD, 8)
            or packed.dtype != torch.bfloat16 or packed.device != fpan.device
            or not packed.is_contiguous()):
        raise ValueError("crosspower: packed B is not pack_eval_operands' "
                         f"layout for keep {keep}")
    fpan, fband = fpan.contiguous(), fband.contiguous()
    hr, hc = hr.contiguous(), hc.contiguous()
    out_re = torch.empty((tiles, n_bands, M, wx), dtype=torch.float32,
                         device=fpan.device)
    out_im = torch.empty_like(out_re)
    _build.launch(
        "crosspower", "oip_crosspower", fpan.data_ptr(), fband.data_ptr(),
        hr.data_ptr(), hc.data_ptr(), packed.data_ptr(), out_re.data_ptr(),
        out_im.data_ptr(), tiles, n_bands, M, keep, m, n, wx,
        _build.stream_of(fpan), device=fpan.device,
    )
    return out_re, out_im


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
    ``M = factor * m_small``.  Returns (dx, dy, response), each (T, NB),
    with the semantics of ``phasecorr.peak_from_spectra_windowed`` fed by
    ``phasecorr.upsampled_band_spectrum``.
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
        dr, di = _crosspower_plain(*args)
    else:
        dr, di = _crosspower_cuda(
            *args, packed_eval_operands(N, keep, win_x, dev))
    return _centroid_on_window(contract_rows(dr, di, M, N, win_y),
                               win_y, win_x)

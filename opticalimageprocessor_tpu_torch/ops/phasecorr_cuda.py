"""Fused windowed cross-power of the fast registration: kernel (b).

Counterpart of ``opticalimageprocessor_tpu/ops/phasecorr_pallas.py``.
Per (tile, band, ky) the kernel forms the spectrally upsampled band
spectrum ``F_up = Hr*Hc*F_band[ky mod m, kx mod n]``, the whitened
cross-power ``C/|C|`` with ``C = F_pan*conj(F_up)``, and contracts kx onto
the 2*win_x+1 window columns; the small ky -> window-rows contraction is a
batched ``torch.matmul`` and the centroid runs in PyTorch, as the JAX
package leaves both to XLA.
"""

from __future__ import annotations

import torch

from .. import _build
from .phasecorr import (
    _centroid_on_window,
    contract_rows,
    eval_consts,
    filter_response,
    whitened_crosspower,
)


def _crosspower_plain(fpan, fband, hr, hc, ex_c, ex_s):
    """Plain PyTorch windowed cross-power: (T, NB, M, wx) real and
    imaginary parts of ``sum_kx Cn[ky, kx] (Ex_c + i Ex_s)[kx, w]``,
    one (tile, band) at a time to bound memory."""
    tiles, n_bands, m, n = fband.shape
    M, keep = fpan.shape[-2], fpan.shape[-1]
    ky = torch.arange(M, device=fpan.device) % m
    kx = torch.arange(keep, device=fpan.device) % n
    h = hr[:, None] * hc[None, :]
    out_re = torch.empty((tiles, n_bands, M, ex_c.shape[1]),
                         dtype=torch.float32, device=fpan.device)
    out_im = torch.empty_like(out_re)
    for t in range(tiles):
        for b in range(n_bands):
            fu = h * fband[t, b][ky][:, kx]
            c = whitened_crosspower(fpan[t], fu)
            cr, ci = c.real, c.imag
            out_re[t, b] = torch.matmul(cr, ex_c) - torch.matmul(ci, ex_s)
            out_im[t, b] = torch.matmul(ci, ex_c) + torch.matmul(cr, ex_s)
    return out_re, out_im


def _crosspower_cuda(fpan, fband, hr, hc, ex_c, ex_s):
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
    fpan, fband = fpan.contiguous(), fband.contiguous()
    hr, hc = hr.contiguous(), hc.contiguous()
    ex_c, ex_s = ex_c.contiguous(), ex_s.contiguous()
    out_re = torch.empty((tiles, n_bands, M, wx), dtype=torch.float32,
                         device=fpan.device)
    out_im = torch.empty_like(out_re)
    _build.launch(
        "crosspower", "oip_crosspower", fpan.data_ptr(), fband.data_ptr(),
        hr.data_ptr(), hc.data_ptr(), ex_c.data_ptr(), ex_s.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), tiles, n_bands, M, keep, m, n,
        wx, _build.stream_of(fpan),
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
    if 2 * win_x + 1 > 160:
        raise ValueError(f"win_x {win_x} above the kernel's 79")
    dev = fpan.device
    hr = filter_response(m_small, factor, dev)
    hc = filter_response(n_small, factor, dev)[:keep]
    ex_c, ex_s = eval_consts(N, keep, win_x, False, dev)
    args = (fpan, fband, hr, hc, ex_c, ex_s)
    if dev.type == "cpu":
        dr, di = _crosspower_plain(*args)
    else:
        dr, di = _crosspower_cuda(*args)
    return _centroid_on_window(contract_rows(dr, di, M, N, win_y),
                               win_y, win_x)

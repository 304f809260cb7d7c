"""The plain reference of the dual-CMOS scene: what decides ``correct``.

A frozen copy, in plain PyTorch, of the scene's mathematics as the port's
plain versions state it (RRC, the fast registration, the stt estimate, the
band alignment resample and the stitch tail), kept here so that no change
to the port can move it.  It imports nothing of the port and nothing of
the JAX package, and takes nothing the port made: it is handed the same
RAW strips and RRC tables as the port and works everything out again.

Precision, as the configurations state it (docs/NUMERICS.md of the
repository): RRC in float64 with the reference camera software's cast;
float32 FFTs; the windowed cross-power's operands rounded to bfloat16 and
their products summed in float32; float32 matmuls with TF32 off; float64
polynomial fits; the resamples' weights and sums in float32; uint16
rasters.  ``low=True`` computes every one of those a step lower (the
cross-power's operands in float8 e4m3, TF32 matmuls, float32 RRC and
fits, bfloat16 resample arithmetic): that is the control that a sound
comparison has to refuse.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

MSS_BANDS = 4
CORRELATION_LINES = 16000
_TWO31 = 2147483648.0
_EPS64_F32 = float(np.float32(np.finfo(np.float64).eps))


@dataclass(frozen=True)
class Precision:
    """The arithmetic of one reference run: the stated one, or a step
    below it everywhere (``low``)."""

    low: bool = False

    @property
    def fit(self):
        return torch.float32 if self.low else torch.float64

    def operands(self, x):
        """The windowed cross-power's GEMM operands, rounded."""
        t = torch.float8_e4m3fn if self.low else torch.bfloat16
        return x.to(t).to(torch.float32)

    @property
    def resample(self):
        return torch.bfloat16 if self.low else torch.float32

    @contextlib.contextmanager
    def matmul(self):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.low
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old


# ---------------------------------------------------------------------------
# RRC: dst = (uint16)(int32)trunc(k * src + b); |v| >= 2^31 -> 0
# ---------------------------------------------------------------------------

def rrc(src, k, b, prec: Precision = Precision()):
    """``src`` (..., rows, cols) uint16, ``k``/``b`` (..., cols) float64."""
    t = torch.float32 if prec.low else torch.float64
    v = torch.add(torch.mul(k.to(t).unsqueeze(-2), src.to(t)),
                  b.to(t).unsqueeze(-2))
    in_range = v.abs() < _TWO31
    i = torch.where(in_range, torch.trunc(v), torch.zeros_like(v))
    return (i.to(torch.int64) & 0xFFFF).to(torch.uint16)


# ---------------------------------------------------------------------------
# cubic weights (OpenCV interpolateCubic, A = -0.75, float32, in order)
# ---------------------------------------------------------------------------

def interpolate_cubic_f32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    A = np.float32(-0.75)
    f1, f5, f8, f4 = (np.float32(v) for v in (1.0, 5.0, 8.0, 4.0))
    f2, f3 = np.float32(2.0), np.float32(3.0)
    xp1 = x + f1
    c0 = ((A * xp1 - f5 * A) * xp1 + f8 * A) * xp1 - f4 * A
    c1 = ((A + f2) * x - (A + f3)) * x * x + f1
    omx = f1 - x
    c2 = ((A + f2) * omx - (A + f3)) * omx * omx + f1
    c3 = f1 - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1)


X4_W = interpolate_cubic_f32(
    np.array([0.625, 0.875, 0.125, 0.375], dtype=np.float32))
X4_BASE = (-2, -2, -1, -1)   # first tap of each x4 phase


def _cubic_weights(t):
    A = -0.75
    tp1 = t + 1.0
    w0 = ((A * tp1 - 5.0 * A) * tp1 + 8.0 * A) * tp1 - 4.0 * A
    w1 = ((A + 2.0) * t - (A + 3.0)) * t * t + 1.0
    omt = 1.0 - t
    w2 = ((A + 2.0) * omt - (A + 3.0)) * omt * omt + 1.0
    w3 = 1.0 - w0 - w1 - w2
    return w0, w1, w2, w3


# ---------------------------------------------------------------------------
# registration: (section, slice) tiles of PAN1 against the 4 MSS bands
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RegGeometry:
    slices: int
    n_sections: int
    corr_rows: int
    sec_stride: int
    cols: int
    bcols: int
    brows: int


def reg_geometry(lines: int, width: int, slices: int,
                 n_sections: int | None = None) -> RegGeometry:
    corr_rows = min(lines, CORRELATION_LINES)
    corr_rows = max(64, corr_rows - corr_rows % 64)
    if n_sections is None:
        n_sections = max(1, min(5, lines // CORRELATION_LINES))
    cols = width // slices
    if cols % MSS_BANDS:
        raise ValueError(f"slice width {cols} is not a multiple of 4")
    stride = ((lines - corr_rows) // max(1, n_sections - 1)
              if n_sections > 1 else 0)
    return RegGeometry(slices, n_sections, corr_rows, stride, cols,
                       cols // MSS_BANDS, corr_rows // MSS_BANDS)


def _tiles(strip, k, b, row0, rows, cols, slices, prec):
    blk = strip[..., row0:row0 + rows, :slices * cols]
    blk = rrc(blk, k[..., :slices * cols], b[..., :slices * cols], prec)
    t = blk.to(torch.float32).reshape(*blk.shape[:-1], slices, cols)
    return t.movedim(-2, 0)


def _upsample_filter(m: int, device, factor: int = 4):
    """DFT of the x4 cubic upsample kernel on the length ``factor*m`` grid
    (float64 trig, float32 storage), complex64."""
    big_n = factor * m
    taps = {}
    for r in range(factor):
        for c in range(4):
            taps[r - factor * (X4_BASE[r] + c)] = float(X4_W[r, c])
    k = np.arange(big_n, dtype=np.float64)
    re = np.zeros(big_n)
    im = np.zeros(big_n)
    for s, w in taps.items():
        ang = -2.0 * np.pi * k * s / big_n
        re += w * np.cos(ang)
        im += w * np.sin(ang)
    return torch.complex(torch.from_numpy(re.astype(np.float32)),
                         torch.from_numpy(im.astype(np.float32))).to(device)


def _eval_consts(n: int, keep: int, win: int, rows_axis: bool, device):
    """DFT-evaluation matrices (keep, 2*win+1) of the correlation surface
    at shifts [-win, win] (float64 trig, float32 storage)."""
    k = np.arange(keep, dtype=np.float64)
    s = np.arange(-win, win + 1, dtype=np.float64)
    ang = -2.0 * np.pi * np.outer(k, s) / n
    cos, sin = np.cos(ang), np.sin(ang)
    if not rows_axis:
        wgt = np.full(keep, 2.0)
        wgt[0] = 1.0
        if n % 2 == 0 and keep == n // 2 + 1:
            wgt[-1] = 1.0
        cos = cos * wgt[:, None]
        sin = sin * wgt[:, None]
    return (torch.from_numpy(cos.astype(np.float32)).to(device),
            torch.from_numpy(sin.astype(np.float32)).to(device))


def _clamp_win(win, shape):
    return min(win[0], (shape[0] - 1) // 2), min(win[1], (shape[1] - 1) // 2)


def _rfft2_padded(x, pad_to):
    h, w = x.shape[-2], x.shape[-1]
    M, N = pad_to
    return torch.fft.rfft2(F.pad(x.to(torch.float32), (0, N - w, 0, M - h)))


def _whitened(fpan_t, fband_tb, hr, hc, prec):
    """C/|C| rounded as the GEMM's operands, C = F_pan * conj(Hr*Hc*
    F_band[ky mod m, kx mod n]), in real float32 operations, |C|
    correctly rounded."""
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
    mag = torch.sqrt((pr * pr + pi * pi).double()).float()
    den = torch.where(mag == 0, torch.ones_like(mag), mag)
    return prec.operands(pr / den), prec.operands(pi / den)


def _argmax_centroid(corr):
    """Arg-max and the 5x5 weighted centroid around it (clipped at the
    surface's edges) of (..., H, W) surfaces -> (column, row, sum)."""
    wy, wx = corr.shape[-2], corr.shape[-1]
    batch = corr.shape[:-2]
    flat = corr.reshape(-1, wy * wx)
    peak = torch.argmax(flat, dim=1)
    py, px = peak // wx, peak % wx
    start_r = torch.clamp(py - 2, 0, wy - 5)
    start_c = torch.clamp(px - 2, 0, wx - 5)
    ar = torch.arange(5, device=corr.device)
    rr = start_r[:, None, None] + ar[None, :, None]
    cc = start_c[:, None, None] + ar[None, None, :]
    win = flat.reshape(-1, wy, wx)
    bidx = torch.arange(flat.shape[0], device=corr.device)[:, None, None]
    vals = win[bidx, rr, cc]
    valid = ((rr >= py[:, None, None] - 2) & (rr <= py[:, None, None] + 2)
             & (cc >= px[:, None, None] - 2) & (cc <= px[:, None, None] + 2))
    winm = torch.where(valid, vals, torch.zeros_like(vals))
    s = winm.sum(dim=(1, 2))
    s_eps = s + _EPS64_F32
    cxc = (winm * cc.to(winm.dtype)).sum(dim=(1, 2)) / s_eps
    cyc = (winm * rr.to(winm.dtype)).sum(dim=(1, 2)) / s_eps
    return cxc.reshape(batch), cyc.reshape(batch), s.reshape(batch)


def _window_peak(corr, win_y, win_x):
    cxc, cyc, s = _argmax_centroid(corr)
    return cxc - win_x, cyc - win_y, s


def _contract_rows(dr, di, M, N, win_y):
    cy_c, cy_s = _eval_consts(M, M, win_y, True, dr.device)
    return (torch.matmul(cy_c.T, dr) - torch.matmul(cy_s.T, di)) / float(M * N)


def _crosspower_peaks(fpan, fband, pad, m_small, win_y, win_x, prec):
    """Windowed correlation peaks of every (tile, band): the spectrally
    upsampled band spectrum, the whitened cross-power rounded to bf16, the
    kx contraction in float32, the ky contraction, the centroid."""
    M, N = pad
    keep = fpan.shape[-1]
    tiles, n_bands, _, n_small = fband.shape
    dev = fpan.device
    hr = _upsample_filter(m_small, dev)
    hc = _upsample_filter(n_small, dev)[:keep]
    ex_c, ex_s = _eval_consts(N, keep, win_x, False, dev)
    ec, es = prec.operands(ex_c), prec.operands(ex_s)
    dr = torch.empty((tiles, n_bands, M, ex_c.shape[1]), dtype=torch.float32,
                     device=dev)
    di = torch.empty_like(dr)
    for t in range(tiles):
        for b in range(n_bands):
            cr, ci = _whitened(fpan[t], fband[t, b], hr, hc, prec)
            dr[t, b] = torch.matmul(cr, ec) - torch.matmul(ci, es)
            di[t, b] = torch.matmul(ci, ec) + torch.matmul(cr, es)
    return _window_peak(_contract_rows(dr, di, M, N, win_y), win_y, win_x)


def fit_poly(cx, y, deg: int, w, prec: Precision = Precision()):
    """Weighted least squares on x / 4096 (ascending coefficients, float32
    out); a singular system gives non-finite coefficients."""
    t = prec.fit
    scale = 1.0 / 4096.0
    xn = cx.to(t) * scale
    y = y.to(t)
    w = w.to(t)
    xn, y = torch.broadcast_tensors(xn, y)
    w = w.expand_as(xn)
    powers = [torch.ones_like(xn)]
    for _ in range(deg):
        powers.append(powers[-1] * xn)
    v = torch.stack(powers, dim=-1)
    vw = v * w[..., None]
    a = vw.transpose(-1, -2) @ v
    r = (vw.transpose(-1, -2) @ y[..., None])[..., 0]
    c, _info = torch.linalg.solve_ex(a, r)
    k = torch.arange(deg + 1, dtype=t, device=c.device)
    return (c * scale ** k).to(torch.float32)


def register(pan, mss, pan_kb, mss_kb, slices: int, n_sections: int | None,
             threshold: float, prec: Precision = Precision(), win=(64, 64),
             responses=None):
    """The fast registration of RAW ``pan`` (L, W) against RAW ``mss`` (4,
    L/4, W/4) in ``n_sections`` row blocks (None: as many as the strip's
    length gives, at most 5): -> cx (4, 2), cy (4, 3), n_valid (4,).
    Every (tile, band) response is appended to the list ``responses`` when
    one is given."""
    g = reg_geometry(pan.shape[0], pan.shape[1], slices, n_sections)
    pts, bts = [], []
    for sec in range(g.n_sections):
        row0 = sec * g.sec_stride
        pts.append(_tiles(pan[row0:], *pan_kb, 0, g.corr_rows, g.cols,
                          slices, prec))
        bts.append(_tiles(mss[:, row0 // MSS_BANDS:], *mss_kb, 0, g.brows,
                          g.bcols, slices, prec))
    pad = (g.corr_rows, g.cols)
    win = _clamp_win(win, pad)
    with prec.matmul():
        fpan = _rfft2_padded(torch.cat(pts), pad)
        del pts
        fband = torch.fft.fft2(torch.cat(bts).to(torch.float32))
        del bts
        dx, dy, rs = _crosspower_peaks(fpan, fband, pad, g.brows, *win,
                                       prec)
        del fpan, fband
        if responses is not None:
            responses.append(rs)
        cx = (torch.arange(g.slices, device=dx.device) * g.cols
              + g.cols // 2).to(torch.float32).repeat(g.n_sections)
        w = (rs.T >= threshold).to(torch.float32)
        n_valid = w.sum(dim=1).to(torch.int32)
        coeff_x = fit_poly(cx, dx.T, 1, w, prec)
        coeff_y = fit_poly(cx, dy.T, 2, w, prec)
    return coeff_x, coeff_y, n_valid


# ---------------------------------------------------------------------------
# the stt estimate: PAN1's right overlap strip against PAN2's left one
# ---------------------------------------------------------------------------

def stt_offsets(lines: int, sections: int, lps: int):
    gap = (lines - sections * lps) // (sections + 1)
    return [gap + i * (gap + lps) for i in range(sections)]


def stt_estimate(pan1, pan2, sections: int, lps: int | None, overlap: int,
                 threshold: float, prec: Precision = Precision(),
                 win=(64, 64), responses=None):
    """-> (dx, dy, n_valid) 0-d tensors: the deltas averaged over
    ``sections`` windows of ``lps`` lines (None: min(16000, lines /
    sections)) whose response passes ``threshold``."""
    lines, width = pan1.shape
    lps = lps or max(64, min(16000, lines // sections))
    lps -= lps % 64
    lps = max(64, lps)
    if sections * lps > lines:
        raise ValueError("PAN line count less than sections x lines")
    offs = stt_offsets(lines, sections, lps)
    c1 = width - overlap
    t1 = torch.stack([pan1[o:o + lps, c1:c1 + overlap].to(torch.float32)
                      for o in offs])
    t2 = torch.stack([pan2[o:o + lps, :overlap].to(torch.float32)
                      for o in offs])
    shape = tuple(t1.shape[1:])
    win_y, win_x = _clamp_win(win, shape)
    M, N = shape
    with prec.matmul():
        fa, fb = _rfft2_padded(t1, shape), _rfft2_padded(t2, shape)
        far, fai, fbr, fbi = fa.real, fa.imag, fb.real, fb.imag
        pr = far * fbr + fai * fbi
        pi = fai * fbr - far * fbi
        mag = torch.sqrt(pr * pr + pi * pi)
        den = torch.where(mag == 0, torch.ones_like(mag), mag)
        cr, ci = pr / den, pi / den
        cx_c, cx_s = _eval_consts(N, fa.shape[-1], win_x, False, fa.device)
        dr = torch.matmul(cr, cx_c) - torch.matmul(ci, cx_s)
        di = torch.matmul(ci, cx_c) + torch.matmul(cr, cx_s)
        dx, dy, rs = _window_peak(_contract_rows(dr, di, M, N, win_y),
                                  win_y, win_x)
    if responses is not None:
        responses.append(rs)
    ok = (rs >= threshold).to(torch.float32)
    n = ok.sum()
    denom = torch.clamp(n, min=1.0)
    return (dx * ok).sum() / denom, (dy * ok).sum() / denom, n.to(torch.int32)


# ---------------------------------------------------------------------------
# the transform: the band alignment resample and the stitch tail
# ---------------------------------------------------------------------------

def col_block_size(width: int, block: int) -> int:
    block = min(block, width)
    return next(b for b in range(block, 0, -1) if width % b == 0)


def _col_taps(coeff_x, width: int, block: int, halo: int):
    """First tap and the 4 weights of every output column; taps outside
    the image or the column block's halo window get weight 0."""
    f32 = torch.float32
    dev = coeff_x.device
    xx = torch.arange(width, dtype=f32, device=dev) * 4.0
    mapx = (coeff_x[1] * xx + coeff_x[0] + xx) / 4.0
    fl = torch.floor(mapx)
    w = torch.stack(_cubic_weights(mapx - fl))
    tap0 = fl.to(torch.int64) - 1
    blk_start = (torch.arange(width, device=dev) // block) * block
    loc0 = tap0 - (blk_start - halo)
    b = torch.arange(4, device=dev)[:, None]
    ok = ((tap0 + b >= 0) & (tap0 + b < width)
          & (loc0 + b >= 0) & (loc0 + b < block + 2 * halo))
    return tap0, torch.where(ok, w, torch.zeros_like(w))


def _col_interp(src, tap0, w, t):
    width = src.shape[-1]
    src = src.to(t)
    acc = torch.zeros_like(src)
    for b in range(4):
        idx = torch.clamp(tap0 + b, 0, width - 1)
        acc = acc + src[..., idx] * w[b].to(t)
    return acc


def _round_u16(acc):
    return torch.clamp(torch.round(acc.to(torch.float32)), 0.0,
                       65535.0).to(torch.int32).to(torch.uint16)


def remap_band(src, coeff_x, coeff_y, row_bound: int, block: int, halo: int,
               prec: Precision = Precision()):
    """Alignment resample of one RRC'd (rows, W) band by ``mapx = (cx1*xx +
    cx0 + xx)/4``, ``mapy = y + (cy2*xx^2 + cy1*xx + cy0)/4`` (xx = 4x):
    the column cubic, then the vertical cubic with taps beyond
    ``row_bound`` dropped and rows past the strip reading 0."""
    t = prec.resample
    rows, width = src.shape
    tap0, w = _col_taps(coeff_x, width, block, halo)
    colg = _col_interp(src, tap0, w, t)
    xx = torch.arange(width, dtype=torch.float32, device=src.device) * 4.0
    g = (coeff_y[2] * xx * xx + coeff_y[1] * xx + coeff_y[0]) / 4.0
    fl = torch.floor(g)
    iy0 = fl.to(torch.int64)
    wys = _cubic_weights(g - fl)
    padded = F.pad(colg, (0, 0, row_bound + 1, row_bound + 2))
    acc = torch.zeros((rows, width), dtype=t, device=src.device)
    for v, u in enumerate(range(-row_bound - 1, row_bound + 3)):
        cu = torch.zeros_like(g)
        for a in range(4):
            cu = cu + torch.where(iy0 + a - 1 == u, wys[a],
                                  torch.zeros_like(g))
        acc = acc + padded[v:v + rows] * cu.to(t)
    return _round_u16(acc)


def stitch(pan1, pan2, kb1, kb2, dx: float, dy: float, fold: int,
           block: int, halo: int, prec: Precision = Precision(),
           rows_per_block: int = 8192):
    """RRC(PAN1)'s left ``W - fold`` columns ++ the (dx, dy) translation of
    RRC(PAN2) from column ``fold`` on (rows past the strip read 0), in
    blocks of ``rows_per_block`` output rows so a long strip fits beside
    the rasters it is judged against."""
    t = prec.resample
    rows, width = pan1.shape
    f32 = torch.float32
    dx_t = torch.tensor(dx, dtype=f32, device=pan1.device)
    dy_t = torch.tensor(dy, dtype=f32, device=pan1.device)
    tap0, w = _col_taps(torch.stack([4.0 * dx_t, torch.zeros_like(dx_t)]),
                        width, block, halo)
    fl = torch.floor(dy_t)
    iy0 = int(fl)
    wys = _cubic_weights(dy_t - fl)
    out = torch.empty((rows, 2 * (width - fold)), dtype=torch.uint16,
                      device=pan1.device)
    for r0 in range(0, rows, rows_per_block):
        r1 = min(rows, r0 + rows_per_block)
        out[r0:r1, :width - fold] = rrc(pan1[r0:r1], *kb1, prec)[
            :, :width - fold]
        # output row r reads PAN2 rows r + iy0 - 1 .. r + iy0 + 2
        s0, s1 = r0 + iy0 - 1, r1 + iy0 + 2
        a = min(max(s0, 0), rows)
        b = max(min(s1, rows), a)
        colg = _col_interp(rrc(pan2[a:b], *kb2, prec), tap0, w, t)
        padded = F.pad(colg, (0, 0, a - s0, s1 - b))
        del colg
        acc = torch.zeros((r1 - r0, width), dtype=t, device=pan1.device)
        for k in range(4):
            acc = acc + padded[k:k + r1 - r0] * wys[k].to(t)
        del padded
        out[r0:r1, width - fold:] = _round_u16(acc[:, fold:])
    return out


def clamp_stt(raw_dx: float, raw_dy: float, col_halo: int,
              prestt_row_bound: int):
    """The stt deltas clamped to the resample's supported band, as float32
    values."""
    hx, hy = col_halo - 2.0, prestt_row_bound - 2.0
    dx = min(max(float(raw_dx), -hx), hx)
    dy = min(max(float(raw_dy), -hy), hy)
    return float(np.float32(dx)), float(np.float32(dy))

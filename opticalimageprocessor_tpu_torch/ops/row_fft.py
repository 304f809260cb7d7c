"""The registration's row DFTs, kernel (i), and the column transforms that
complete the tiles' 2-D spectra on the card.

The fast registration keeps its tile width 1228 = 4 x 307 (the JAX
package's fast mode: padding changes the correlation).  cuFFT takes the
prime factor 307 by Bluestein's algorithm on 1296 / 625 points, in passes
over device memory.  Kernel (i) (``csrc/row_fft.cu``) computes the
last-axis DFTs of the two float32 tile stacks in one pass, each row read
once and its bins written once:

* a PAN row (4p real) -> ``torch.fft.rfft``'s 2p + 1 bins, by the
  Good-Thomas split 4 x p: p four-point DFTs of the row, then two complex
  p-point DFTs -- the k1 = 0 and k1 = 2 parts packed as the real and
  imaginary halves of one, the k1 = 1 part the other (k1 = 3 is its
  conjugate);
* two band rows (p real each) -> ``torch.fft.fft``'s p bins of each, packed
  into one complex p-point DFT.

A p-point DFT (p prime, 307) is Rader's: the inputs other than x[0], taken
in the order of the powers of a primitive root g, make a cyclic
convolution of length p - 1 with a fixed sequence -- a forward DFT, a
product with the sequence's DFT, an inverse DFT -- and p - 1 = f1 x f2
coprime (18 x 17) makes each of those DFTs a Good-Thomas pair of f2- and
f1-point DFTs, with no twiddles.  Every table (the index maps, the
sequence's DFT, the small DFTs' cosines and sines) is computed once on the
host in float64 and stored as float32; operands and sums are float32, and
each row's sums run in one order whatever the block or the tile count.

:func:`_pan_rows_plain` and :func:`_band_rows_plain` are the same
algorithm in plain PyTorch (the same tables and split, the small DFTs as
float32 products), the CPU route of :func:`pan_row_dft` /
:func:`band_row_dft`.

The column transforms stay on cuFFT (16000 = 2^7 5^3 and 4000 = 2^5 5^3 are
smooth): 1-D C2C transforms over dim -2 of (i)'s output.  (i) writes each
matrix's bins column-major -- the PAN spectra as (T, 615, M), the bands'
as (T, NB, 307, m) -- so that the columns are contiguous runs and the
batch one stride: ``torch.fft.fft`` over the last axis of that storage is
one cuFFT launch, with no copy (a column's bits do not depend on how many
tiles it takes); kernel (b) reads that layout.  :func:`take_spectra`,
:func:`pan_spectra` and :func:`band_spectra` give the tiles' 2-D spectra:
on CUDA tensors of (i)'s widths (i) and the column pass, as views of that
storage; on CUDA tensors of other widths (12288-pixel lines cut into
other than 10 slices) ``torch.fft.rfft2`` / ``fft2`` copied to kernel (b)'s layout
(:func:`~.phasecorr_cuda.kx_major`); on CPU tensors ``torch.fft.rfft2`` /
``fft2`` as they are.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..utils.logging import to_device
from .phasecorr_cuda import kx_major

# kernel (i) is built for this prime (csrc/row_fft.cu): band tiles of P
# columns, PAN tiles of 4 P, whose half spectrum keeps 2 P + 1 bins
P = 307
PAN_COLS = 4 * P
PAN_KEEP = 2 * P + 1
# the kernel's tables (kernel_tables): byte offsets of the PAN staging map,
# the band staging map, the output map and the sequence's DFT, and the size
TAB_STAGE, TAB_SLOT, TAB_OUT, TAB_BHAT, TAB_BYTES = 0, 2456, 3072, 3696, 6144


def _primes(n: int) -> list[int]:
    """The distinct prime factors of ``n``."""
    out, q = [], 2
    while q * q <= n:
        if n % q == 0:
            out.append(q)
            while n % q == 0:
                n //= q
        q += 1
    return out + ([n] if n > 1 else [])


def _primitive_root(p: int) -> int:
    return next(g for g in range(2, p)
                if all(pow(g, (p - 1) // q, p) != 1 for q in _primes(p - 1)))


def _coprime_split(n: int) -> tuple[int, int]:
    """``n = f1 * f2``, coprime, ``f2`` the largest prime power dividing
    ``n`` (306 -> 18 x 17)."""
    powers = []
    for q in _primes(n):
        e = q
        while n % (e * q) == 0:
            e *= q
        powers.append(e)
    f2 = max(powers, default=1)
    return n // f2, f2


@dataclass(frozen=True)
class RaderPlan:
    """Rader's p-point DFT as a length p - 1 cyclic convolution, split
    f1 x f2 by Good-Thomas.  Slot (p1, p2) of the split holds convolution
    index j = (f2 p1 + f1 p2) mod (p - 1): input ``src`` = g^j, output bin
    ``dst`` = g^-j; ``bhat`` (f1, f2) is the DFT of the convolution's
    sequence b[j] = exp(-2 pi i g^-j / p), over p - 1, at the bin of
    residues (q1, q2)."""

    p: int
    g: int
    f1: int
    f2: int
    src: np.ndarray    # (f1, f2) int64
    dst: np.ndarray    # (f1, f2) int64
    bhat: np.ndarray   # (f1, f2) complex64


@functools.lru_cache(maxsize=8)
def rader_plan(p: int) -> RaderPlan:
    """The plan of the ``p``-point DFT (``p`` an odd prime), its sequence's
    DFT computed in float64 and stored as complex64."""
    n = p - 1
    g = _primitive_root(p)
    f1, f2 = _coprime_split(n)
    j = (f2 * np.arange(f1)[:, None] + f1 * np.arange(f2)[None, :]) % n
    powg = np.array([pow(g, e, p) for e in range(n)], dtype=np.int64)
    b = np.exp(-2j * np.pi * powg[(-np.arange(n)) % n] / p)
    # bin q of residues (q1, q2): q = q1 mod f1, q = q2 mod f2
    q = (np.arange(f1)[:, None] * f2 * pow(f2, -1, f1)
         + np.arange(f2)[None, :] * f1 * pow(f1, -1, f2)) % n
    return RaderPlan(p, g, f1, f2, powg[j], powg[(-j) % n],
                     (np.fft.fft(b) / n)[q].astype(np.complex64))


def kernel_tables(p: int = P) -> np.ndarray:
    """Kernel (i)'s tables as bytes (TAB_BYTES at the offsets TAB_*):

    * stage (p, 4) uint16: float j of a PAN row's j-th four, element e
      (row index n = 4j + e: n1 = n mod 4 times p^-1, n2 = n / 4 mod p) goes
      to float ``4 slot(n2) + n1`` of the row's staged block;
    * slot (p,) uint16: the split's slot p2 f1 + p1 of input index n2 (p - 1
      for n2 = 0): a band pair's row goes to float ``2 slot(n) + parity``;
    * out (f2, f1) uint16: the output bin of slot (p1, p2), at [p2][p1];
    * bhat (f1, f2) float32 pairs: ``RaderPlan.bhat``.
    """
    plan = rader_plan(p)
    slot = np.empty(p, dtype=np.int64)
    slot[plan.src] = (np.arange(plan.f2)[None, :] * plan.f1
                      + np.arange(plan.f1)[:, None])
    slot[0] = p - 1
    n = np.arange(4 * p)
    n1 = (n % 4) * pow(p % 4, -1, 4) % 4
    n2 = n * pow(4, -1, p) % p
    stage = (4 * slot[n2] + n1).reshape(p, 4)
    out = np.zeros(TAB_BYTES, dtype=np.uint8)
    for off, arr in ((TAB_STAGE, stage.astype(np.uint16)),
                     (TAB_SLOT, slot.astype(np.uint16)),
                     (TAB_OUT, plan.dst.T.astype(np.uint16)),
                     (TAB_BHAT, plan.bhat)):
        raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        if off + raw.size > TAB_BYTES:
            raise ValueError(f"kernel (i) tables of p = {p} exceed "
                             f"{TAB_BYTES} bytes")
        out[off:off + raw.size] = raw
    return out


def kernel_consts(p: int = P) -> np.ndarray:
    """The small DFTs' cosines and sines, float64 rounded to float32:
    cos, sin(2 pi m / f2) for m < f2, then of 2 pi m / (f1 / 2) for
    m < f1 / 2 (the kernel's f1-point DFT is 2 x f1 / 2)."""
    plan = rader_plan(p)
    h = plan.f1 // 2
    a, b = 2 * np.pi * np.arange(plan.f2) / plan.f2, \
        2 * np.pi * np.arange(h) / h
    return np.concatenate([np.cos(a), np.sin(a), np.cos(b),
                           np.sin(b)]).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _dft_matrix(n: int, device) -> torch.Tensor:
    """The forward ``n``-point DFT matrix, float64 trig as complex64."""
    k = np.arange(n)
    return torch.from_numpy(
        np.exp(-2j * np.pi * np.outer(k, k) / n).astype(np.complex64)
    ).to(device)


def _rader_plain(u: torch.Tensor, p: int) -> torch.Tensor:
    """The ``p``-point DFT of complex64 rows ``u`` (..., p) by the plan's
    split, in float32: the f2-point DFTs of each p1, the f1-point DFTs of
    each q2, the product with ``bhat``, the inverses in reverse order."""
    plan = rader_plan(p)
    dev = u.device
    w1, w2 = _dft_matrix(plan.f1, dev), _dft_matrix(plan.f2, dev)
    a = u[..., torch.from_numpy(plan.src).to(dev)]        # (..., f1, f2)
    a = torch.matmul(w1, torch.matmul(a, w2))
    x0 = u[..., 0] + a[..., 0, 0]
    a = a * torch.from_numpy(plan.bhat).to(dev)
    c = torch.matmul(torch.matmul(w1.conj(), a), w2.conj())
    out = torch.empty_like(u)
    out[..., 0] = x0
    out[..., torch.from_numpy(plan.dst).to(dev).reshape(-1)] = (
        u[..., :1] + c.reshape(*c.shape[:-2], -1))
    return out


def _halves(a: torch.Tensor, b: torch.Tensor, second) -> torch.Tensor:
    """From A = Z[k] and B = Z[-k] of Z = DFT(x + i y) (x, y real): DFT(x)[k]
    = (A + conj B) / 2, or where ``second`` (a bool or a bool tensor)
    DFT(y)[k] = (A - conj B) / 2i, in the kernel's float32 operations."""
    first = torch.complex((a.real + b.real) * 0.5, (a.imag - b.imag) * 0.5)
    other = torch.complex((a.imag + b.imag) * 0.5, (b.real - a.real) * 0.5)
    if isinstance(second, bool):
        return other if second else first
    return torch.where(second, other, first)


def _pan_rows_plain(x: torch.Tensor, p: int = P) -> torch.Tensor:
    """(..., 4p) float32 rows -> their (..., 2p + 1) ``rfft`` bins by kernel
    (i)'s algorithm."""
    dev = x.device
    n = (p * torch.arange(4, device=dev)[:, None]
         + 4 * torch.arange(p, device=dev)[None, :]) % (4 * p)
    v = x[..., n]                                       # (..., 4, p)
    s, t = v[..., 0, :] + v[..., 2, :], v[..., 1, :] + v[..., 3, :]
    u = torch.stack((torch.complex(s + t, s - t),
                     torch.complex(v[..., 0, :] - v[..., 2, :],
                                   v[..., 3, :] - v[..., 1, :])), dim=-2)
    z = _rader_plain(u, p)                              # (..., 2, p)
    k = torch.arange(2 * p + 1, device=dev)
    k1, k2 = k % 4, k % p
    zp, z1 = z[..., 0, :], z[..., 1, :]
    even = _halves(zp[..., k2], zp[..., (-k2) % p], k1 == 2)
    return torch.where(k1 == 1, z1[..., k2],
                       torch.where(k1 == 3, z1[..., (-k2) % p].conj(), even))


def _band_rows_plain(x: torch.Tensor, p: int = P) -> torch.Tensor:
    """(..., rows, p) float32 rows -> their (..., rows, p) ``fft`` bins by
    kernel (i)'s algorithm: rows 2j and 2j + 1 of the flattened stack as one
    complex row (a last odd row beside zeros)."""
    rows = x.reshape(-1, p)
    n = rows.shape[0]
    if n % 2:
        rows = torch.cat((rows, rows.new_zeros(1, p)))
    z = _rader_plain(torch.complex(rows[0::2], rows[1::2]), p)
    k = torch.arange(p, device=x.device)
    ak, bk = z[:, k], z[:, (-k) % p]
    out = torch.stack((_halves(ak, bk, False), _halves(ak, bk, True)), dim=1)
    return out.reshape(-1, p)[:n].reshape(x.shape)


@functools.lru_cache(maxsize=None)
def _device_tables(device) -> torch.Tensor:
    return to_device(kernel_tables(), device)


_CONSTS = kernel_consts()
_CONSTS_PTR = _CONSTS.ctypes.data_as(ctypes.c_void_p)


def _row_dft_cuda(x: torch.Tensor, pan: bool) -> torch.Tensor:
    """Kernel (i) on a contiguous float32 stack of (..., m, W) matrices, W =
    1228 (the PAN) or 307 (the bands) -> their (..., m, K) bins, K = 615 or
    307, as a view of (..., K, m) storage: each matrix's bins column-major,
    the layout of the column pass and of kernel (b)."""
    width = PAN_COLS if pan else P
    what = "PAN" if pan else "band"
    if x.dtype != torch.float32:
        raise ValueError(f"row_dft: the {what} stack must be float32, got "
                         f"{x.dtype}")
    if x.dim() < 2 or x.shape[-1] != width:
        raise ValueError(f"row_dft: {what} rows of {width} columns, got a "
                         f"{tuple(x.shape)} stack")
    if not x.is_contiguous():
        raise ValueError("row_dft: the stack must be contiguous")
    rows, m = x.numel() // width, x.shape[-2]
    if rows * PAN_KEEP >= 2 ** 31:
        raise ValueError(f"row_dft: {rows} rows exceed the kernel's 32-bit "
                         "offsets")
    out = torch.empty((*x.shape[:-2], PAN_KEEP if pan else P, m),
                      dtype=torch.complex64, device=x.device)
    _build.require_cuda("row_dft", x)
    if x.data_ptr() % 16:
        raise ValueError("row_dft: the stack must be 16-byte aligned")
    if rows:
        _build.launch(
            "row_fft", "oip_row_fft", x.data_ptr(), out.data_ptr(),
            _device_tables(x.device).data_ptr(), _CONSTS_PTR, int(pan), rows,
            m, _build.stream_of(x), device=x.device)
    return out.transpose(-1, -2)


def pan_row_dft(x: torch.Tensor) -> torch.Tensor:
    """``torch.fft.rfft(x)`` of float32 PAN rows (..., m, 1228) -> (..., m,
    615) complex64: kernel (i) on CUDA tensors (each matrix's bins
    column-major, a view), :func:`_pan_rows_plain` on CPU tensors (any
    width 4p, p an odd prime)."""
    if x.device.type == "cpu":
        return _pan_rows_plain(x, x.shape[-1] // 4)
    return _row_dft_cuda(x, True)


def band_row_dft(x: torch.Tensor) -> torch.Tensor:
    """``torch.fft.fft(x)`` of float32 band rows (..., m, 307) -> (..., m,
    307) complex64: kernel (i) on CUDA tensors (each matrix's bins
    column-major, a view), :func:`_band_rows_plain` on CPU tensors (any odd
    prime width)."""
    if x.device.type == "cpu":
        return _band_rows_plain(x, x.shape[-1])
    return _row_dft_cuda(x, False)


def _kernel_takes(x: torch.Tensor, pan: bool) -> bool:
    """Whether kernel (i) takes the float32 stack ``x``: rows of its width
    (1228 for the PAN, 307 for the bands), within its 32-bit offsets."""
    width = PAN_COLS if pan else P
    return (x.dim() >= 2 and x.shape[-1] == width
            and x.numel() // width * PAN_KEEP < 2 ** 31)


def _columns(rows: torch.Tensor) -> torch.Tensor:
    """cuFFT's forward C2C transforms over dim -2 of (i)'s output ``rows``
    (..., m, K), a view of (..., K, m) storage: ``torch.fft.fft`` over the
    last axis of that storage, whose columns are contiguous runs and whose
    batch is one stride (one plan, no copy).  -> (..., m, K), a view of new
    (..., K, m) storage."""
    return torch.fft.fft(rows.transpose(-1, -2), dim=-1).transpose(-1, -2)


def _spectrum(stacks: list, pan: bool) -> torch.Tensor:
    """The 2-D spectrum of the stack popped from the front of ``stacks``,
    freed once its row DFTs are taken (see :func:`take_spectra`)."""
    x = stacks.pop(0)
    lib = torch.fft.rfft2 if pan else torch.fft.fft2
    if x.device.type == "cpu":
        return lib(x)
    if not _kernel_takes(x, pan):
        return kx_major(lib(x))
    rows = _row_dft_cuda(x, pan)
    del x
    return _columns(rows)


def take_spectra(stacks: list) -> tuple[torch.Tensor, torch.Tensor]:
    """The tiles' 2-D spectra of ``stacks``, [the float32 PAN tile stack
    (T, M, W), the float32 band tile stack (T, NB, m, W / 4)], emptied as
    they are taken so that each stack is freed once its row DFTs are taken
    (the column pass is out of place) -> ``(torch.fft.rfft2 of the PAN,
    torch.fft.fft2 of the bands)``, complex64.  On CUDA tensors the spectra
    come kx-major, as kernel (b) reads them: by kernel (i) and the column
    pass where W = 1228, else by cuFFT's rfft2 / fft2 and a copy; on CPU
    tensors as torch.fft gives them."""
    fpan = _spectrum(stacks, True)
    return fpan, _spectrum(stacks, False)


def pan_spectra(pan: torch.Tensor) -> torch.Tensor:
    """``torch.fft.rfft2`` of the float32 PAN tile stack (T, M, W) -> (T, M,
    W / 2 + 1) complex64, as :func:`take_spectra` gives it."""
    return _spectrum([pan], True)


def band_spectra(band: torch.Tensor) -> torch.Tensor:
    """``torch.fft.fft2`` of the float32 band tile stack (T, NB, m, w) ->
    (T, NB, m, w) complex64, as :func:`take_spectra` gives it."""
    return _spectrum([band], False)

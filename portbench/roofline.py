"""The card's peaks and the least time a kernel's work could take.

Copied from the repository's ``chip_smoke.py`` (``bound``,
``crosspower_bound``, ``stitch_bound``), so that a later change to that
script cannot move the benchmark's rooflines.  A bound counts each input
byte read once and each output byte written once at the memory rate,
against each class of operations at its peak; the larger one bounds.
The work is counted from the shapes of the scene, never from the kernel
that happens to do it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound_ms(nbytes: float, **ops) -> float:
    """``ops``: name -> (count, rate); -> the least ms."""
    times = [nbytes / HBM_BYTES_PER_S * 1e3]
    times += [count / rate * 1e3 for count, rate in ops.values()]
    return max(times)


def crosspower_bound_ms(tiles, bands, M, keep, m, n, wx) -> float:
    """The windowed cross-power of every (tile, band): the PAN and band
    spectra (complex64) and the two filter responses read, the float32
    real and imaginary (M, wx) outputs written; the kx contraction as a
    bf16 GEMM (8 FLOP a complex multiply-add of the real-ified product)
    and the whitening (~40 float32 FLOP an element)."""
    nbytes = (8 * (tiles * M * keep + tiles * bands * m * n + M + keep)
              + 2 * 4 * tiles * bands * M * wx)
    return bound_ms(nbytes,
                    operations=(8 * tiles * bands * M * keep * wx, BF16_FLOPS),
                    whitening=(40 * tiles * bands * M * keep, F32_FLOPS))


def stitch_bound_ms(rows, width, fold) -> float:
    """The stitch tail: both RAW PANs read (uint16), the (rows, 2*(W -
    fold)) raster written, four float64 RRC rows read."""
    return bound_ms(2 * 2 * rows * width + 2 * rows * 2 * (width - fold)
                    + 4 * 8 * width)

"""fft_ms.resident: profiled device ms a scene of the cuFFT kernels
(ops/phasecorr: the PAN rfft2, the band fft2, the stt transforms)."""

from portbench.readers import device_ms

PATTERNS = ("fft",)


def read(ctx):
    return device_ms(ctx, PATTERNS)

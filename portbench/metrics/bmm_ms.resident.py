"""bmm_ms.resident: profiled device ms a scene of the cuBLAS GEMM kernels
(ops/phasecorr: the ky contraction, the stt contractions)."""

from portbench.readers import device_ms

PATTERNS = ("gemm", "gemv", "xmma", "splitkreduce")


def read(ctx):
    return device_ms(ctx, PATTERNS)

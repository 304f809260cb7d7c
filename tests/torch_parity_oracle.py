"""The numpy ``cv::remap`` oracle in place of the JAX package's parity
remap, for the port's route tests (tests/test_torch_preprocessor.py,
tests/test_torch_stitcher.py): with it, JAX's parity routes give the bytes
the compiled reference gives, which the port must equal."""

import numpy as np

from opticalimageprocessor_tpu.ops import cv_exact
from opticalimageprocessor_tpu.ops import resample as jres


def use_oracle_remap(monkeypatch) -> None:
    """Make ``jres.remap_section_u16(src, plan)`` the oracle on the plan's
    section-local maps: ``build_remap_plan`` is wrapped to record each
    plan's float64 ``mapx`` and ``g``, from which the float32 maps are
    rebuilt as the reference fills them (``mapy = float32(y + g)``)."""
    inputs = {}
    build = jres.build_remap_plan

    def recording_build(mapx_cols, g, quantized_coords=False):
        plan = build(mapx_cols, g, quantized_coords)
        inputs[id(plan)] = (plan, np.asarray(mapx_cols, np.float64),
                            np.asarray(g, np.float64))
        return plan

    def oracle(src, plan):
        _, mapx_cols, g = inputs[id(plan)]
        src = np.asarray(src)
        rows = src.shape[0]
        mapx = np.tile(mapx_cols.astype(np.float32)[None, :], (rows, 1))
        mapy = (np.arange(rows, dtype=np.float64)[:, None]
                + g[None, :]).astype(np.float32)
        return cv_exact.remap_cubic_u16_exact(src, mapx, mapy,
                                              quantized_coords=plan.quantized)

    monkeypatch.setattr(jres, "build_remap_plan", recording_build)
    monkeypatch.setattr(jres, "remap_section_u16", oracle)

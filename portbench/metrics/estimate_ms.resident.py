"""estimate_ms.resident: ScenePipeline.estimate, CUDA events around the
call, ms a scene over the window."""

from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "estimate")

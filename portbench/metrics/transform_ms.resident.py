"""transform_ms.resident: ScenePipeline.transform, CUDA events around the
call, ms a scene over the window."""

from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "transform")

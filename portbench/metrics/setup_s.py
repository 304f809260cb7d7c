"""setup_s: from the start of the process to the start of the window
(imports, the CUDA context, loading or building the kernels, making the
scenes, the warm scenes)."""


def read(ctx):
    return ctx.setup_s

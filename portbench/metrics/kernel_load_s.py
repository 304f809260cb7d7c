"""kernel_load_s: the hand-written kernels' library load in set-up (its
source hash, the build on a checkout's first run, dlopen and binding),
seconds, as the port's ``_build.load_s`` records it once a process."""


def read(ctx):
    from opticalimageprocessor_tpu_torch import _build
    return getattr(_build, "load_s", None)

"""host_syncs.resident: blocking device-to-host reads a scene, the port's
``host_syncs`` counter over the traced sub-window."""

from portbench.spans import count_a_scene


def read(ctx):
    return count_a_scene(ctx, "host_syncs")

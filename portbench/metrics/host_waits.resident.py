"""host_waits.resident: the port's ``oip.sync`` spans a scene in
``resident_scene_160k`` (reads back, uploads from pageable memory, ops that
synchronize inside), from its span report over the traced sub-window."""

from portbench.waits import waits_a_scene as read  # noqa: F401

"""wait_gap_ms.parity: device idle ms a scene that the host's waits open in
``resident_parity_160k``: the traced sub-window's idle gaps whose middle falls
inside a host ``oip.scene`` and whose start inside an ``oip.sync``
(at most ``host_gap_ms``' gaps)."""

from portbench.waits import wait_gap_ms as read  # noqa: F401

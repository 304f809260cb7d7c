"""resident_gpix_s: input pixels (PAN1 + PAN2 + every MSS band, each
once) of every scene completed in the window over the whole window."""

from portbench.readers import gpix_s as read  # noqa: F401

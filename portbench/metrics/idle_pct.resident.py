"""idle_pct.resident: the profiled sub-window's share with no kernel,
copy or set on the device."""

from portbench.readers import idle_pct as read  # noqa: F401

"""Host utilities of the port (logging, stage timing and the profiler
trace; the native host library's downlink scan and LZW)."""

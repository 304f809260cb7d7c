"""Host utilities of the port (logging and stage timing, native LZW)."""

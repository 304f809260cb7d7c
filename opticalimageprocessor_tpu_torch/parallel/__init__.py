"""The line mesh: N devices over the strip's line axis (``--mesh N``),
driven by one process or spanning the processes of a multi-process launch.
``mesh`` (the device list and the line-sharded raster), ``halo``
(neighbour rows copied between devices), ``sharded`` (the file commands'
sharded steps), ``sharded_scene`` (the scene's) and ``distributed`` (the
process group, the cross-process row fetches and the offset-write
drains)."""

"""The line mesh: one process driving N devices over the strip's line axis
(``--mesh N``).  ``mesh`` (the device list and the line-sharded raster),
``halo`` (neighbour rows copied between devices), ``sharded`` (the file
commands' sharded steps), ``sharded_scene`` (the scene's) and
``distributed`` (the offset-write drains and the multi-process launch
variables' checks)."""

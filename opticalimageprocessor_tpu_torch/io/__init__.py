"""Host IO of the port: RAW strips (:mod:`.raw`), TIFF (:mod:`.tiff`) and
the double-buffered section streamer (:mod:`.streaming`)."""

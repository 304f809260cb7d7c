"""Host IO of the port: the double-buffered section streamer
(:mod:`.streaming`), and the JAX package's jax-free RAW and TIFF modules
re-exported as :mod:`raw` and :mod:`tiff`, so that the port's code and
scripts reach every file format through the port."""

from opticalimageprocessor_tpu.io import raw, tiff  # noqa: F401

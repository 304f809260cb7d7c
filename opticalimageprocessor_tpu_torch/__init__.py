"""opticalimageprocessor_tpu_torch -- the PyTorch/CUDA port for NVIDIA
Hopper (H100) of the ``scene`` pipeline and of the file commands
(``auxsep``, on the host only; ``prestitch``, the default registration +
alignment, ``stitch``), on one device or over the line mesh
(``parallel/``: one process driving N devices, ``--mesh N``).

Plain tensor code is PyTorch; every kernel the JAX package wrote in Pallas
for the TPU is a hand-written CUDA C++ kernel under ``csrc/``, built with
``nvcc`` on first use (``_build``) and launched on CUDA tensors.  CPU
tensors take each kernel's plain PyTorch version.  The JAX package
``opticalimageprocessor_tpu`` stays the reference; this package imports
nothing of it (its host modules -- constants, naming, the RRC CSV reader,
the AOS downlink formats and their separator, RAW and TIFF IO, logging,
the native host library's bindings -- have copies here) and never imports
jax.
"""

__version__ = "0.1.0"

"""opticalimageprocessor_tpu_torch -- the PyTorch/CUDA port of the
``scene`` pipeline for NVIDIA Hopper (H100).

Plain tensor code is PyTorch; every kernel the JAX package wrote in Pallas
for the TPU on this path is a hand-written CUDA C++ kernel under
``csrc/``, built with ``nvcc`` on first use (``_build``) and launched on
CUDA tensors.  CPU tensors take each kernel's plain PyTorch version.  The
JAX package ``opticalimageprocessor_tpu`` stays the reference; this
package never imports jax.
"""

__version__ = "0.1.0"

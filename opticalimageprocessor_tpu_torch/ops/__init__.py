"""Device ops of the port: RRC (kernel a), phase correlation and the fused
windowed cross-power (kernel b), band remap and stitch tail (kernels c,
d), each beside its plain PyTorch version."""

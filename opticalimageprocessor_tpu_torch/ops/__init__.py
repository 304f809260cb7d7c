"""Device ops of the port: RRC (kernel a), phase correlation and the fused
windowed cross-power (kernel b), band remap, stitch tail and the staged
remap's row pass (kernels c, d, e), each beside its plain PyTorch version;
and the host-side polynomial fit."""

"""Entry points for an outside caller: one step of the default command's
compute core on one device, and a dry run of the sharded align step.

Counterpart of the repository's ``__graft_entry__.py`` (the JAX package's
entry points of the same names): :func:`entry` returns the RRC +
band-alignment resample step and its example arguments,
:func:`dryrun_multichip` runs one sharded align step over a line mesh of
CPU shards.
"""

from __future__ import annotations

import numpy as np
import torch


def entry():
    """The RRC + alignment-resample step on one MSS band tile (512 x 3072),
    the compute core of the default command.  -> ``(fn, example_args)``.

    ``fn(band, k, b, coeff_x, coeff_y, device="cuda")``: kernel (a) with
    float64 ``(k, b)``, then ``parallel/sharded.remap_band_dynamic`` (the
    staged fast remap, kernel (e)) of the band as one shard; on the card
    unless the caller asks for ``device="cpu"`` (the plain versions).  The
    example arguments are host numpy arrays, so ``entry()`` itself does no
    device work.
    """
    from .ops.rrc import rrc_apply
    from .parallel.mesh import LineMesh, LineSharded
    from .parallel.sharded import remap_band_dynamic

    rows, width = 512, 3072
    rng = np.random.default_rng(0)
    band = rng.integers(0, 65536, (rows, width), dtype=np.uint16)
    k = 0.98 + 0.04 * rng.random(width)
    b = rng.normal(0, 20, width)
    coeff_x = np.asarray([1.5, 2.5e-4], np.float32)
    coeff_y = np.asarray([-0.75, 1.0e-4, 1.0e-8], np.float32)

    def fn(band, k, b, coeff_x, coeff_y, device="cuda"):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available")
        corrected = rrc_apply(
            torch.as_tensor(band).to(dev),
            *(torch.as_tensor(v, dtype=torch.float64).to(dev)
              for v in (k, b)))
        mesh = LineMesh([corrected.device])
        return remap_band_dynamic(LineSharded(mesh, [corrected]),
                                  coeff_x, coeff_y).shards[0]

    return fn, (band, k, b, coeff_x, coeff_y)


def dryrun_multichip(n_devices: int) -> None:
    """One sharded align step (``parallel/sharded.make_align_step``: RRC,
    the tile blocks' phase correlation, the gathered fit, the halo'd
    staged remap) over ``LineMesh([cpu] * n_devices)`` on a small
    synthetic scene, checked as JAX's dry run checks it: the fit recovers
    the constructed band rolls and the aligned bands correlate with the
    scene."""
    from .constants import MSS_BANDS
    from .ops.resample import upsample4_f32
    from .parallel.mesh import LineMesh
    from .parallel.sharded import make_align_step

    mesh = LineMesh(["cpu"] * n_devices)
    rng = np.random.default_rng(0)
    band_px = 128
    width = band_px * MSS_BANDS          # 512
    lines_mss = 64 * n_devices
    scene = rng.integers(2000, 42000, (lines_mss, band_px)).astype(np.uint16)
    up = upsample4_f32(torch.from_numpy(scene.astype(np.float32))).numpy()
    pan = np.clip(np.rint(up), 0, 65535).astype(np.uint16)
    mss = np.stack([np.roll(scene, b % 2, axis=1) for b in range(MSS_BANDS)])
    ident = (np.ones(width), np.zeros(width))
    ident_mss = (np.ones((MSS_BANDS, band_px)),
                 np.zeros((MSS_BANDS, band_px)))

    step = make_align_step(mesh, slices=MSS_BANDS * 2)
    aligned, cx, cy = step(pan, mss, ident, ident_mss)
    if aligned.shape != (lines_mss, band_px, MSS_BANDS):
        raise AssertionError(f"aligned shape {aligned.shape}")
    # the fit recovers the constructed rolls: dx = 4 * roll at PAN scale
    for b in range(MSS_BANDS):
        if not (abs(cx[b, 0] - 4.0 * (b % 2)) < 0.5
                and abs(cx[b, 1]) * width < 0.5 and abs(cy[b, 0]) < 0.5):
            raise AssertionError(f"band {b}: fit {cx[b]}, {cy[b]}")
    out = aligned.gather().numpy()
    for b in range(MSS_BANDS):
        c = float(np.corrcoef(out[4:-4, 4:-4, b].astype(np.float64).ravel(),
                              scene[4:-4, 4:-4].astype(np.float64).ravel()
                              )[0, 1])
        if c <= 0.99:
            raise AssertionError(f"band {b}: correlation {c}")
    print(f"dryrun_multichip({n_devices}): aligned {tuple(aligned.shape)} "
          f"on {len(mesh)} CPU shards, coeff_x[0]={cx[0]}")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry():", tuple(out.shape), out.dtype)
    dryrun_multichip(8)

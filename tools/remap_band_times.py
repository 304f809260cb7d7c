#!/usr/bin/env python3
"""Time kernel (c) of the PyTorch/CUDA port at the shapes its callers use.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/remap_band_times.py [--root DIR]

``--root`` names the checkout whose ``opticalimageprocessor_tpu_torch``
is timed (default: this repository), so that two versions of the kernel
can be timed in turns on one card, e.g. a parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists.  Shapes and
coefficients are those of ``chip_smoke.py`` phase 2:

* ``scene``: the 4 MSS bands of a 32768-line scene, 4 x (8192, 3072), row
  bound 3, column block 128 / halo 16, into the (8192, 3072, 4) raster --
  one ``_remap_bands_cuda`` launch where the package has it, else what its
  ``ScenePipeline.transform`` did: one ``_remap_band_cuda`` a band and a
  strided copy into the interleaved raster;
* ``scene_band``: one of those bands alone through ``_remap_band_cuda``;
* ``prestitch``: PAN2 of a 16384-line prestitch, (16384, 12288), row bound
  4, 512 / 32;
* ``align``: one band of the 16384-line file align, (4096, 3072), row
  bound 6, 512 / 32.

Each time is CUDA events around 20 calls after a warm-up call.  Prints one
JSON line with the card's name and power limit (nvidia-smi), the times in
ms and the package's root.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def time_ms(torch, fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false")
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from opticalimageprocessor_tpu_torch.ops import resample

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)

    def u16(*shape):
        return torch.from_numpy(
            rng.integers(0, 65536, shape, dtype=np.uint16)).to(dev)

    def f32(*rows):
        return torch.tensor(rows, dtype=torch.float32, device=dev)

    out = {}
    bands = u16(4, 8192, 3072)
    cx = f32(*([4.0 * (b - 1) + 0.3, -2.1e-4] for b in range(4)))
    cy = f32(*([4.0 * (b % 2) - 0.4, 6.5e-4, -3.0e-7] for b in range(4)))
    kw = dict(row_bound=3, block=128, halo=16)
    if hasattr(resample, "_remap_bands_cuda"):
        def scene():
            resample._remap_bands_cuda(bands, cx, cy, **kw)
    else:
        aligned = torch.empty((8192, 3072, 4), dtype=torch.uint16,
                              device=dev)

        def scene():
            for i in range(4):
                aligned[:, :, i].copy_(
                    resample._remap_band_cuda(bands[i], cx[i], cy[i], **kw))
    out["scene_ms"] = time_ms(torch, scene)
    out["scene_band_ms"] = time_ms(
        torch, lambda: resample._remap_band_cuda(bands[0], cx[0], cy[0], **kw))
    del bands
    pan = u16(16384, 12288)
    cxp, cyp = f32(-12.0, 0.0), f32(10.4, 0.0, 0.0)
    out["prestitch_ms"] = time_ms(torch, lambda: resample._remap_band_cuda(
        pan, cxp, cyp, row_bound=4, block=512, halo=32))
    del pan
    band = u16(4096, 3072)
    cxa, cya = f32(4.3, -2.1e-4), f32(3.6, 6.5e-4, -3.0e-7)
    out["align_ms"] = time_ms(torch, lambda: resample._remap_band_cuda(
        band, cxa, cya, row_bound=6, block=512, halo=32))
    print(json.dumps({"card": card, "root": args.root, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time kernel (d), the stitch tail, at its callers' shapes.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/stitch_tail_times.py [--root DIR] [--iters N]

``--root`` names the checkout whose ``opticalimageprocessor_tpu_torch``
is timed (default: this repository), so that two versions can be timed in
turns on one card.  The shapes, each a pair of uint16 noise PANs of 12288
columns with fold 100, block 128, halo 16 and the scene's translation (dx
-2.7, dy +1.6):

* ``scene32k``: 32768 rows, the stitched raster alone;
* ``section``: 4116 rows (a streamed section of 4096 rows and its halo),
  with the prestitched PAN2 written too (``scene --stream --mss2``);
* ``scene160k``: 160000 rows, the benchmark's scene (``resident_scene_160k``);
* ``dual160k``: 160000 rows with the prestitched PAN2 (``resident_dual_160k``).

Each time is CUDA events around ``--iters`` calls of
``ops.resample._stitch_tail_cuda`` after a warm-up call, beside its bound:
both PANs read once, the stitched raster (and prestt) written once, at
3.35 TB/s.  Prints one JSON line with the card's name and power limit
(nvidia-smi) and the package's root.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

W, FOLD, BLOCK, HALO, DX, DY = 12288, 100, 128, 16, -2.7, 1.6
SHAPES = (("scene32k", 32768, False), ("section", 4116, True),
          ("scene160k", 160000, False), ("dual160k", 160000, True))
HBM_BYTES_PER_S = 3.35e12


def time_ms(torch, fn, iters: int) -> float:
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


def bound_ms(rows: int, want_prestt: bool) -> float:
    """Both PANs read, the stitched raster and prestt written (uint16),
    four float64 parameter rows read."""
    nbytes = (2 * 2 * rows * W + 2 * rows * 2 * (W - FOLD)
              + (2 * rows * W if want_prestt else 0) + 4 * 8 * W)
    return nbytes / HBM_BYTES_PER_S * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=10)
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
    gen = torch.Generator(device=dev).manual_seed(0)
    k1, k2 = (0.98 + 0.04 * torch.rand(W, generator=gen, device=dev,
                                       dtype=torch.float64)
              for _ in range(2))
    b1, b2 = (20.0 * torch.randn(W, generator=gen, device=dev,
                                 dtype=torch.float64) for _ in range(2))
    out = {}
    for name, rows, want_prestt in SHAPES:
        pan1, pan2 = (torch.randint(0, 65536, (rows, W), generator=gen,
                                    device=dev, dtype=torch.int32)
                      .to(torch.uint16) for _ in range(2))

        def run():
            resample._stitch_tail_cuda(pan1, pan2, k1, b1, k2, b2, DX, DY,
                                       FOLD, BLOCK, HALO, want_prestt)

        out[f"{name}_ms"] = time_ms(torch, run, args.iters)
        out[f"{name}_bound_ms"] = bound_ms(rows, want_prestt)
        del pan1, pan2
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "root": args.root, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

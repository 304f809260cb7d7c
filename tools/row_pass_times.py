#!/usr/bin/env python3
"""Time kernel (e) of the PyTorch/CUDA port, alone and inside the staged
remap that launches it.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/row_pass_times.py [--root DIR]

``--root`` names the checkout whose ``opticalimageprocessor_tpu_torch``
is timed (default: this repository), so that two versions of the kernel
can be timed in turns on one card, e.g. a parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists.  Timed, with
CUDA events around repeated calls after a warm-up call:

* ``row_pass_U{18,24,36}_ms``: ``_fast_row_pass_cuda`` on the staged
  remap's 8192-row chunk at the camera width, padded (8192 + U - 1, 12288)
  float32, row bounds 7, 10 and 16, G's floor running over 3 values;
* ``staged_ms``: ``remap_band_fast`` on a (16384, 12288) uint16 strip, row
  bound 10, in 8192-row chunks (the PAN2 resample of a ``prestitch --fast``
  whose |dy| is 9: dx -3, dy 9.1), and its second chunk's stages one by one
  (``chunk_*_ms``): the column cubic (uint16 -> float32 and 4 taps), the
  zero pad, the row pass, the rounding to uint16 and the copy into the
  strip.

Prints one JSON line with the card's name and power limit (nvidia-smi),
the times in ms and the package's root.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROWS, WIDTH, CHUNK = 8192, 12288, 8192
ROW_BOUNDS = (7, 10, 16)


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
    import torch.nn.functional as F

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
    out = {}
    x = torch.arange(WIDTH, dtype=torch.float32, device=dev)
    for rb in ROW_BOUNDS:
        u = 2 * rb + 4
        padded = torch.from_numpy(
            rng.random((ROWS + u - 1, WIDTH), dtype=np.float32)
            * 65535.0).to(dev)
        cu = resample._row_pass_coeffs(
            (rb - 1.5) + 1.4 * torch.sin(x * (6.0 / WIDTH)), rb)
        out[f"row_pass_U{u}_ms"] = time_ms(
            torch, lambda: resample._fast_row_pass_cuda(padded, cu, ROWS))
        del padded
        torch.cuda.empty_cache()

    src = torch.from_numpy(
        rng.integers(0, 65536, (2 * CHUNK, WIDTH), dtype=np.uint16)).to(dev)
    cx, cy, rb = (-12.0, 0.0), (36.4, 0.0, 0.0), 10
    out["staged_ms"] = time_ms(torch, lambda: resample.remap_band_fast(
        src, cx, cy, rb, chunk_rows=CHUNK), 5)
    # the second chunk's stages, as remap_band_fast runs them
    rows = src.shape[0]
    a, b = CHUNK, 2 * CHUNK
    lo, hi = a - rb - 1, b + rb + 2
    tap0, w = resample._col_taps(torch.tensor(cx, device=dev), WIDTH,
                                 resample.col_block_size(WIDTH, None),
                                 resample.COL_HALO)
    cu = resample._row_pass_coeffs(
        resample._band_g(torch.tensor(cy, device=dev), WIDTH), rb)
    colg = resample._col_interp(src[lo:min(hi, rows)].to(torch.float32),
                                tap0, w)
    padded = F.pad(colg, (0, 0, 0, hi - rows))
    acc = resample.fast_row_pass(padded, cu, b - a)
    rounded = resample._round_u16(acc)
    res = torch.empty_like(src)
    out.update(
        chunk_col_cubic_ms=time_ms(torch, lambda: resample._col_interp(
            src[lo:min(hi, rows)].to(torch.float32), tap0, w), 10),
        chunk_pad_ms=time_ms(torch, lambda: F.pad(
            colg, (0, 0, 0, hi - rows)), 10),
        chunk_row_pass_ms=time_ms(torch, lambda: resample.fast_row_pass(
            padded, cu, b - a), 10),
        chunk_round_ms=time_ms(torch, lambda: resample._round_u16(acc), 10),
        chunk_copy_ms=time_ms(torch, lambda: res[a:b].copy_(rounded), 10),
    )
    print(json.dumps({"card": card, "root": args.root, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

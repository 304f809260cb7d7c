#!/usr/bin/env python3
"""Time kernel (f) of the PyTorch/CUDA port at the shapes its callers use.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/remap_section_times.py [--root DIR] [--sass]

``--root`` names the checkout whose ``opticalimageprocessor_tpu_torch``
is timed (default: this repository), so that two versions of the kernel
can be timed in turns on one card, e.g. a parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists.  Shapes and
maps are those of ``chip_smoke.py`` phase 7, each in both coordinate
modes (``remap_section_u16`` on a random uint16 section):

* ``section``: a (30000, 12288) prestitch section at the constant shift
  ``PARITY_SHIFT`` (-3.3, +3.4);
* ``band_section``: a (20000, 3072) section at the band polynomial
  ``PARITY_POLY``;
* ``align_section``: a (5200, 3072) default-action section, the same
  polynomial;
* ``mesh_call``: a line mesh's call on that polynomial, a 5000-row window,
  output rows [7, 4993), map row 20000 at its row 0 (``MESH_CALL``).

Each time is CUDA events around 10 calls after a warm-up call.  Prints one
JSON line with the card's name and power limit (nvidia-smi), the times in
ms and the package's root.  ``--sass`` adds, for each kernel (f)
instance in the built library, its SASS instruction count and its FFMA
count (``cuobjdump -sass``; the kernel must hold no FFMA).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

PARITY_POLY = ((4.3, -2.1e-5), (3.6, 6.5e-5, -3.0e-9))
PARITY_SHIFT = (-3.3, 3.4)
MESH_CALL = dict(rows=5000, first=7, count=4986, origin=20000)
ITERS = 10


def time_ms(torch, fn, iters: int = ITERS) -> float:
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


def sass_counts(library: Path) -> dict:
    """{kernel (f) instance: (instructions, FFMA)} from ``cuobjdump``."""
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    text = subprocess.run(
        [str(cuobjdump) if cuobjdump.exists() else "cuobjdump", "-sass",
         str(library)], capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "remap_section_kernel" in m.group(1) else None
            if name:
                counts[name] = [0, 0]
            continue
        if name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name][0] += 1
            counts[name][1] += " FFMA" in line
    return {k: tuple(v) for k, v in counts.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false")
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from opticalimageprocessor_tpu_torch import _build
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

    out = {}
    m = MESH_CALL
    cases = (("section", 30000, 12288, "shift", (0, None, 0)),
             ("band_section", 20000, 3072, "band", (0, None, 0)),
             ("align_section", 5200, 3072, "band", (0, None, 0)),
             ("mesh_call", m["rows"], 3072, "band",
              (m["first"], m["count"], m["origin"])))
    for tag, rows, width, kind, call in cases:
        sec = u16(rows, width)
        for quantized, mode in ((False, "continuous"), (True, "quantized")):
            if kind == "shift":
                plan = resample.plan_for_constant_shift(
                    *PARITY_SHIFT, width, quantized)
            else:
                plan = resample.plan_for_band_alignment(
                    *PARITY_POLY, width, quantized)
            out[f"{tag}_{mode}_ms"] = time_ms(
                torch, lambda: resample.remap_section_u16(sec, plan, *call))
        del sec
        torch.cuda.empty_cache()
    if args.sass:
        out["sass"] = sass_counts(_build._library_path())
    print(json.dumps({"card": card, "root": args.root, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

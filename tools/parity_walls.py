#!/usr/bin/env python3
"""Time the parity file commands of the PyTorch/CUDA port on one card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/parity_walls.py [--root DIR] [--dir TMP]

``--root`` names the checkout whose ``opticalimageprocessor_tpu_torch``
runs (default: this repository), so that two versions can be timed in
turns on one card, e.g. a parent commit unpacked with ``git archive`` into
a directory that ``.gitignore`` lists.  ``--dir`` keeps the input files
between runs (default: a temporary directory, removed at the end); they
are made once, like ``chip_smoke.py`` phase 7's: a 40960-line scene of RAW
files (bench.py's synthesis, PAN2 3 rows below PAN1, seed 5) and random
RRC tables.

Through the package's ``cli.main``, each without ``--fast``:
``prestitch -s 1 -l 16000`` (two 30000-row sections and the bottom cut)
and the default action (``--slices 10 --ibc-sections 1 --lines-section
5200 --overlap-lines 100``: two sections of 5200 MSS lines), each in both
``--coord-mode``s, after one untimed quantized prestitch that pays the
process's CUDA start (context, kernel build, first allocations), which
would otherwise fall on the first timed command.  Prints one JSON line
with the card's name and power limit (nvidia-smi), the package that ran,
each command's wall s (host clock, ending in ``torch.cuda.synchronize``)
and its ``prestitch`` / ``alignment`` stage s from the log.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
LINES = 40960


def _smoke():
    """This repository's ``chip_smoke.py`` (its scene synthesis)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_files(torch, cs, tmp: Path) -> dict:
    """Phase 7's scene files in ``tmp`` (made if missing): -> paths."""
    files = {n: tmp / f"{n}.RAW" for n in ("CMOS1.PAN", "CMOS2.PAN",
                                           "CMOS1.MSS")}
    csv = {n: tmp / f"{n}.csv" for n in ("pan1", "pan2", "msb1", "msb2",
                                         "msb3", "msb4")}
    if all(p.exists() for p in (*files.values(), *csv.values())):
        return {**files, **csv}
    rng = np.random.default_rng(cs.SEED + 5)
    pan1, pan2, mss = cs.synth_scene(torch, rng, LINES,
                                     torch.device("cuda", 0), dy=3)
    pan1.cpu().numpy().tofile(files["CMOS1.PAN"])
    pan2.cpu().numpy().tofile(files["CMOS2.PAN"])
    mss.cpu().numpy().transpose(1, 0, 2).tofile(files["CMOS1.MSS"])
    for name, path in csv.items():
        cs._write_csv(str(path), *cs.rand_params(
            rng, cs.W if name.startswith("pan") else cs.BW))
    return {**files, **csv}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--dir", default=None)
    args = ap.parse_args()
    tmp = Path(args.dir or tempfile.mkdtemp(prefix="oip_parity_"))
    tmp.mkdir(parents=True, exist_ok=True)
    log = tmp / "oip.log"
    os.environ["LOGFILE"] = str(log)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from opticalimageprocessor_tpu_torch import cli

    cs = _smoke()
    f = make_files(torch, cs, tmp)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = {"card": card, "package": str(Path(cli.__file__).parent),
           "lines": LINES}
    prestitch = ["prestitch", "--pan1", str(f["CMOS1.PAN"]), "--pan2",
                 str(f["CMOS2.PAN"]), "--rrc1", str(f["pan1"]), "--rrc2",
                 str(f["pan2"]), "-s", "1", "-l", "16000",
                 "--stitch-overlap", str(cs.FOLD_COLS), "--device", "cuda"]
    align = ["--pan", str(f["CMOS1.PAN"]), "--mss", str(f["CMOS1.MSS"]),
             "--do-rrc4pan", "--rrc-pan", str(f["pan1"]), "--slices", "10",
             "--ibc-sections", "1", "--lines-section", "5200",
             "--overlap-lines", "100", "--device", "cuda"]
    for b in range(1, 5):
        align += [f"--rrc-msb{b}", str(f[f"msb{b}"])]
    warm = tmp / "out_warm_up"
    warm.mkdir()
    cli.main(prestitch + ["--coord-mode", "quantized", "--out-dir",
                          str(warm)])
    shutil.rmtree(warm)
    for tag, argv, stage in (("prestitch", prestitch, "prestitch"),
                             ("align", align, "alignment")):
        for mode in ("continuous", "quantized"):
            out = tmp / f"out_{tag}_{mode}"
            out.mkdir()
            mark = log.stat().st_size if log.exists() else 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(argv + ["--coord-mode", mode, "--out-dir",
                                  str(out)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            text = log.read_bytes()[mark:].decode()
            m = re.search(rf"\] \[{stage}\] .* in (\S+) seconds", text)
            res[f"{tag}_{mode}"] = dict(
                rc=rc, wall_s=wall, stage_s=float(m.group(1)) if m else None)
            shutil.rmtree(out)
    print(json.dumps(res))
    if args.dir is None:
        shutil.rmtree(tmp)
    return 0 if all(v["rc"] == 0 for v in res.values()
                    if isinstance(v, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())

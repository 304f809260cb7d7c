"""The readings that the comparison's limits are set from, at a cell's
own sizes on the card (the configuration's judge, ``judges/<judge>.py``,
says what is compared).

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        [--sides program,control]

For every seed: ``program`` runs the cell's route on each scene of the
seed's pool and judges the outputs as a run does; ``control`` puts the
reference, a precision step below the configuration's everywhere
(``reference.Precision(low=True)``, through the judge's
``reference_estimate`` and ``reference_rasters``), in the program's
place.  A limit lies above every sound reading of the program and below
the control's.  One JSON line a seed and side, with the reference's least
distance of a response from its threshold (how near a valid count came
to changing) and the seconds the reference took.  The benchmark's runs
never run the control.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell: str, seed: int, side: str, device="cuda",
             overrides: dict | None = None) -> dict:
    import torch

    from portbench import harness, judge, scenes
    from portbench import reference as ref

    _cell, cfg, traffic, _e2e, _layer = harness.load_cell(cell, overrides)
    jmod = judge.find(cfg["judge"])
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    width, overlap = cfg["pixels_per_line"], cfg["fold_cols"]
    n_pool = traffic["pool"]

    outs = {}
    if side == "program":
        import importlib

        route_mod = importlib.import_module(
            f"portbench.routes.{cfg['route']}")
        tables, pool = scenes.make_pool(seed, traffic, width, overlap, dev)
        route = route_mod.Route(cfg, tables, pool, dev,
                                harness.Timer(dev, False))
        del tables, pool
        for j in range(n_pool):
            est = route.run(j, j)
            outs[j] = (est, route.rasters(j))
        route.release()
        del route
    tables, pool = scenes.make_pool(seed, traffic, width, overlap, dev)
    low = ref.Precision(low=True)
    res = {}
    margin = float("inf")
    t0 = time.perf_counter()
    for j, scene in enumerate(pool):
        rs = []
        r_est = jmod.reference_estimate(scene, tables, cfg, responses=rs)
        margin = min(margin, jmod.response_margin(rs, cfg))
        if side == "program":
            est, rasters = outs.pop(j)
        else:
            est = jmod.reference_estimate(scene, tables, cfg, low)
            rasters = jmod.reference_rasters(scene, tables, cfg, est, low)
        judge.worst(res, jmod.estimate_gaps(est, r_est, width))
        judge.worst(res, jmod.raster_gaps(scene, tables, cfg, est, rasters))
        del rasters
    if dev.type == "cuda":
        torch.cuda.synchronize()
    res.update(workload=cell, seed=seed, side=side,
               least_response_margin=margin,
               reference_s=time.perf_counter() - t0)
    return res


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides", default="program,control")
    args = ap.parse_args()
    fd, log = tempfile.mkstemp(prefix="portbench-", suffix=".log")
    os.close(fd)
    os.environ["LOGFILE"] = log
    sys.path[0] = str(ROOT)     # not portbench/, which would shadow trace
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            for side in args.sides.split(","):
                print(json.dumps(readings(args.workload, seed, side)),
                      flush=True)
    finally:
        os.unlink(log)
    return 0


if __name__ == "__main__":
    sys.exit(main())

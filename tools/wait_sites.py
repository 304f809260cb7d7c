#!/usr/bin/env python3
"""Where the scene forwards wait for the card, and what each wait costs.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/wait_sites.py [--cells a,b,c] [--seed N] [--scenes K]
                                [--timed N] [--out FILE]

For each benchmark cell (default: the three of ``BENCHMARK.json``), built
as ``portbench/run.py`` builds it (the cell's scenes made on the card
from ``--seed``, one warm scene a pool entry):

* ``unspanned``: one scene under a CPU profiler (the spans on) and
  ``torch.cuda.set_sync_debug_mode("warn")``; each synchronizing torch
  operation outside an ``oip.sync`` span warns, and its Python stack's
  last frames in the port are listed with their count.  Empty where every
  wait torch can see is a span.
* ``sites``: ``--scenes`` scenes under ``torch.profiler`` (CPU and CUDA
  activity, as the benchmark's traced sub-window): for each site (the
  ``oip.*`` span that encloses an ``oip.sync``), its waits a scene, their
  host ms a scene and the device idle ms a scene they open (gaps whose
  middle lies in an ``oip.scene`` and whose start in one of the site's
  waits, as ``portbench/waits.wait_gap_ms`` counts them); beside them
  ``host_gap_ms`` and ``wait_gap_ms`` a scene, the runtime synchronize
  calls inside a scene and outside every ``oip.sync`` (``runtime_syncs``),
  and the idle that opens outside a wait by the innermost host event at
  the gap's start (``behind``, the largest 8; the traced window's first
  gap, from its start to the first scene's first kernel, apart).
* ``p95``: ``--timed`` scenes untraced, ``--timed`` traced, twice in
  turns, each timed by CUDA events around the call as the benchmark times
  it: the p95 (nearest rank) and median, ms, with tracing off and on.

Prints one JSON line a cell with the card's name and power limit
(nvidia-smi), and with ``--out FILE`` also writes them all to FILE.
"""

from __future__ import annotations

import argparse
import collections
import gc
import importlib
import json
import math
import statistics
import subprocess
import sys
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402,E501

from opticalimageprocessor_tpu_torch.utils import logging as tlog  # noqa: E402,E501
from portbench import harness, scenes, trace, waits  # noqa: E402

CELLS = ("resident_scene_160k", "resident_dual_160k", "resident_parity_160k")
# the runtime calls that block the host (cudaMemcpyAsync blocks only from
# pageable memory, and torch then synchronizes the stream after it)
RUNTIME_SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D"}
PORT = str(ROOT / "opticalimageprocessor_tpu_torch")


def card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=30)
    return res.stdout.strip()


def build(cell: str, seed: int):
    """The cell's route on the card, warm, as ``harness.run`` sets it up:
    -> (route, pool size)."""
    _c, cfg, traffic, _e, _l = harness.load_cell(cell)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = importlib.import_module(f"portbench.routes.{cfg['route']}")
    tables, pool = scenes.make_pool(seed, traffic, cfg["pixels_per_line"],
                                    cfg["fold_cols"], dev)
    route = mod.Route(cfg, tables, pool, dev, harness.Timer(dev, False))
    del tables
    for j in range(traffic["pool"]):
        route.run(j, None)
    torch.cuda.synchronize()
    return route, traffic["pool"]


def unspanned(route, pool: int) -> list:
    """The port's frames of each synchronizing operation outside a span,
    one scene, with their counts."""
    found = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(PORT)][-3:]
        found["  <  ".join(f"{Path(f.filename).name}:{f.lineno} {f.name}"
                           for f in reversed(frames))] += 1

    tlog.reset_span_report()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            with profile(activities=[ProfilerActivity.CPU]):
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    route.run(0, None)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    finally:
        tlog.reset_span_report()
    return [[k, n] for k, n in found.most_common()]


def _innermost(tr, t0, t1, keep):
    """The shortest host event that ``keep(name)`` admits and that holds
    [t0, t1]."""
    best = None
    for name, ts, dur in tr.host:
        if keep(name) and ts <= t0 and t1 <= ts + dur and (
                best is None or dur < best[1]):
            best = (name, dur)
    return best[0] if best else "(none)"


def sites(route, pool: int, k: int) -> dict:
    def run():
        for i in range(k):
            with record_function("portbench.scene"):
                route.run(i % pool, None)
                torch.cuda.synchronize()

    tlog.reset_span_report()
    tr = trace.profile(run, k)
    rep = tlog.span_report()
    tlog.reset_span_report()
    scene_r = waits.ranges(tr, tlog.SCENE_SPAN)
    n = len(scene_r)

    def in_scene(t):
        return any(a <= t < b for a, b in scene_r)

    def is_site(name):
        return name.startswith(("oip.", "portbench.")) and \
            name != tlog.SYNC_SPAN

    syncs = [(a, b, _innermost(tr, a, b, is_site))
             for a, b in waits.ranges(tr, tlog.SYNC_SPAN)]
    out = collections.defaultdict(lambda: {"waits": 0, "host_ms": 0.0,
                                           "idle_ms": 0.0})
    for a, b, site in syncs:
        if in_scene(a):
            out[site]["waits"] += 1
            out[site]["host_ms"] += (b - a) / 1e3
    behind = collections.Counter()
    for s, e in trace.idle_gaps(tr):
        if not in_scene((s + e) / 2):
            continue
        owner = next((site for a, b, site in syncs if a <= s <= b), None)
        if owner is None:
            at = ("(the window's first gap)" if s == tr.t0
                  else _innermost(tr, s, s, lambda _n: True))
            behind[at] += (e - s) / 1e3
        else:
            out[owner]["idle_ms"] += (e - s) / 1e3
    runtime = collections.Counter()
    for name, ts, dur in tr.host:
        if name in RUNTIME_SYNCS and in_scene(ts) and not any(
                a <= ts <= b for a, b, _s in syncs):
            runtime[f"{name} in {_innermost(tr, ts, ts + dur, is_site)}"] \
                += 1
    ctx = type("Ctx", (), {"trace": tr})()
    return {
        "scenes": n,
        "sites": {site: {key: v / n for key, v in d.items()}
                  for site, d in sorted(out.items(),
                                        key=lambda kv: -kv[1]["idle_ms"])},
        "host_gap_ms": harness.reader("host_gap_ms.resident")(ctx),
        "wait_gap_ms": waits.wait_gap_ms(ctx),
        "host_waits": (rep[tlog.SYNC_SPAN]["calls"]
                       / rep[tlog.SCENE_SPAN]["calls"]),
        "host_syncs": rep.get("host_syncs", {}).get("count", 0) / n,
        "idle_pct": 100.0 * (1.0 - tr.busy_s / tr.window_s),
        "runtime_syncs": {k: v / n for k, v in runtime.items()},
        "behind": [[k, v / n] for k, v in behind.most_common(8)],
    }


def timed(route, pool: int, n: int, traced: bool) -> list[float]:
    ms = []

    def scenes_():
        for i in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            route.run(i % pool, None)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))

    if traced:
        tlog.reset_span_report()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            scenes_()
        tlog.reset_span_report()
    else:
        scenes_()
    return ms


def p95(values):
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--seed", type=int, default=2147483000)
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--timed", type=int, default=20)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    results = []
    for cell in args.cells.split(","):
        route, pool = build(cell, args.seed)
        res = {"cell": cell, "card": card(), "seed": args.seed,
               "unspanned": unspanned(route, pool),
               **sites(route, pool, args.scenes)}
        off, on = [], []
        for _ in range(2):
            off += timed(route, pool, args.timed, False)
            on += timed(route, pool, args.timed, True)
        res["p95"] = {"off_ms": p95(off), "on_ms": p95(on),
                      "off_median_ms": statistics.median(off),
                      "on_median_ms": statistics.median(on),
                      "scenes_each": len(off)}
        print(json.dumps(res), flush=True)
        results.append(res)
        route.release()
        del route
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark's run of one cell: set-up, the measured window, the
traced sub-window, the check, the metrics.

Everything is found by name.  ``BENCHMARK.json`` names the cell's
configuration (``configs/<config>.json``, whose ``route`` names the
module under ``routes/`` that drives the program and whose ``judge`` names
the module under ``judges/`` that compares its outputs with the plain
reference) and its traffic mix (``traffic/<traffic>.json``, read by
``scenes.py``); each metric is read by ``metrics/<metric>.py``; the
comparison's limits are ``limits/<config>.json``.  A cell, configuration,
traffic mix or metric is added by adding files and entries, never by
editing this one.

The window is a closed loop: one scene in flight, the pool's scenes in
turn, back to back, each timed from its call to its outputs being
complete (CUDA events around the call; the loop synchronizes after each
scene), until ``seconds`` have passed.  A ``--trace 1`` run also wraps
the calls into the program's layers in spans and, after the window,
profiles a few more scenes.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch
from torch.profiler import record_function

from . import judge, scenes, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
KEPT = 2                 # scenes of the window whose rasters are judged
FORBIDDEN = ("jax", "jaxlib", "flax", "opticalimageprocessor_tpu")


class Timer:
    """Per-scene spans: CUDA events around a call on the card (the host
    clock on the CPU)."""

    def __init__(self, device, spans: bool):
        self.cuda = device.type == "cuda"
        self.spans = spans
        self._events: dict[str, list] = {}
        self._ms: dict[str, list[float]] = {}

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, name, start):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.setdefault(name, []).append((start, ev))
        else:
            self._ms.setdefault(name, []).append(
                (time.perf_counter() - start) * 1e3)

    def wrap(self, name, fn):
        """``fn`` timed, and named in a profiler's trace."""
        def timed(*args, **kw):
            with record_function(f"portbench.{name}"):
                t = self.start()
                out = fn(*args, **kw)
                self.stop(name, t)
            return out
        return timed

    def reset(self):
        self._events.clear()
        self._ms.clear()

    def ms(self) -> dict[str, list[float]]:
        """Every span's ms, scene by scene (call after a synchronize)."""
        out = {k: list(v) for k, v in self._ms.items()}
        for name, pairs in self._events.items():
            out.setdefault(name, []).extend(a.elapsed_time(b)
                                            for a, b in pairs)
        return out


@dataclass
class Context:
    """What a metric's reader reads."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    scenes: int
    pixels_per_scene: int
    scene_ms: list[float]
    spans: dict[str, list[float]]
    shapes: dict
    memory_peak_bytes: int
    trace: trace.Trace | None = None


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_entries(bench: dict, name: str):
    """The cell's workload entry, its configuration entry and the metrics
    it reports: (cell, config, end_to_end, per_layer)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return cell, conf, e2e, layer


def load_cell(name: str, overrides: dict | None = None):
    """The cell's entries, its configuration file and its traffic file:
    (cell, cfg, traffic, end_to_end, per_layer).  ``overrides``
    ({"config": {...}, "traffic": {...}}) shrinks a cell for the CPU
    tests."""
    cell, conf, e2e, layer = cell_entries(load_benchmark(), name)
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    overrides = overrides or {}
    cfg.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return cell, cfg, traffic, e2e, layer


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip() or None


def run(name: str, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda", overrides: dict | None = None):
    """One run of cell ``name``: -> (result dict, check lines).  The
    caller has found the card; ``overrides`` as :func:`load_cell`."""
    cell, cfg, traffic, e2e, layer = load_cell(name, overrides)
    limits = judge.load_limits(cell["config"])
    jmod = judge.find(cfg["judge"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    # the kx / ky contractions and the stt matmuls are float32 matmuls, as
    # run_scene runs them: never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    route_mod = importlib.import_module(f"portbench.routes.{cfg['route']}")
    width, overlap = cfg["pixels_per_line"], cfg["fold_cols"]

    # ---- set-up: the scenes, the program, one warm scene a pool entry
    tables, pool = scenes.make_pool(seed, traffic, width, overlap, dev)
    pixels = pool[0].pixels
    timer = Timer(dev, traced)
    route = route_mod.Route(cfg, tables, pool, dev, timer)
    del tables, pool
    for j in range(traffic["pool"]):
        route.run(j, None)
    timer.sync()
    timer.reset()                    # the warm scenes' spans are set-up
    shapes = route.shapes
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # ---- the measured window
    keep = judge.Reservoir(seed, KEPT)
    estimates = []
    n = 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        j = n % traffic["pool"]
        t = timer.start()
        estimates.append((j, route.run(j, keep.offer(n))))
        timer.stop("scene", t)
        timer.sync()
        n += 1
        t1 = time.perf_counter()
        if t1 - t0 >= seconds:
            break
    window_s = t1 - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    spans = timer.ms()
    scene_ms = spans.pop("scene")

    # ---- the traced sub-window
    tr = None
    if traced and cuda:
        k = traffic["traced_scenes"]

        def traced_scenes():
            # as the window runs them: each scene ends in a synchronize
            for i in range(k):
                with record_function("portbench.scene"):
                    route.run((n + i) % traffic["pool"], None)
                    timer.sync()

        tr = trace.profile(traced_scenes, k)

    # ---- the check, once the program's state is freed
    route.release()
    kept = {slot: route.rasters(slot) for slot in keep.kept}
    kept_scene = dict(keep.kept)
    del route
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    _tables, pool = scenes.make_pool(seed, traffic, width, overlap, dev)
    ref_est = [jmod.reference_estimate(s, _tables, cfg) for s in pool]
    readings = {}
    for j, est in estimates:
        judge.worst(readings, jmod.estimate_gaps(est, ref_est[j], width))
    for slot, rasters in kept.items():
        j, est = estimates[kept_scene[slot]]
        judge.worst(readings, jmod.raster_gaps(pool[j], _tables, cfg, est,
                                               rasters))
    correct, checks = judge.verdict(readings, limits, jmod.NUMBERS)

    # ---- the metrics
    ctx = Context(cell, cfg, traffic, setup_s, window_s, n, pixels,
                  scene_ms, spans, shapes, peak, tr)
    chosen = layer if traced else e2e
    metrics = {}
    for m in chosen:
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": n,
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell["chips"],
            "memory_peak_bytes": int(peak),
        },
    }
    if cuda:
        result["device"]["power_limit"] = power_limit()
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = trace.breakdown(tr)
    result["checks"] = checks
    lines = [f"check {k}: {c['value']} (limit {c['limit']})"
             for k, c in checks.items()]
    return result, lines

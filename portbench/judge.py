"""The comparison that decides ``correct``: what every judge shares.

A configuration's file names its judge (``"judge": "scene"``), the module
``judges/<judge>.py`` that knows the configuration's outputs.  It holds
``NUMBERS``, the names of the numbers it compares, and the functions that
compare them: ``reference_estimate`` (the plain reference's estimate of a
scene), ``reference_rasters`` (the reference's rasters at an estimate),
``estimate_gaps`` (a scene's estimate against the reference's),
``raster_gaps`` (a kept scene's rasters, as its route's ``rasters``
returns them, against the reference's) and ``response_margin``.  The
harness and the control hand a route's estimates and rasters to them
whole, and :func:`verdict` holds the readings to
``limits/<config>.json``: a number of the judge's without a limit, or a
limit of a number the judge does not name, fails the check, so no output
that the judge names goes unjudged.
"""

from __future__ import annotations

import importlib
import json
import math
import random
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


class Reservoir:
    """A uniform sample of ``k`` of the window's scenes, drawn from the
    seed as they arrive: :meth:`offer` -> the slot (0..k-1) scene ``i``
    is kept in, or ``None``."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(seed)
        self.k = k
        self.kept: dict[int, int] = {}    # slot -> scene index

    def offer(self, i: int):
        if i < self.k:
            slot = i
        else:
            j = self.rng.randrange(i + 1)
            if j >= self.k:
                return None
            slot = j
        self.kept[slot] = i
        return slot


def load_limits(config: str) -> dict:
    return json.loads((HERE / "limits" / f"{config}.json").read_text())[
        "limits"]


def find(name: str):
    """The judge ``judges/<name>.py``."""
    return importlib.import_module(f"portbench.judges.{name}")


def dn_gap(a: torch.Tensor, b: torch.Tensor, rows: int = 4096) -> int:
    """The largest DN difference of two uint16 rasters (a shape mismatch
    reads as 65536)."""
    if tuple(a.shape) != tuple(b.shape):
        return 65536
    gap = 0
    for r in range(0, a.shape[0], rows):
        d = (a[r:r + rows].to(torch.int32) - b[r:r + rows].to(torch.int32))
        gap = max(gap, int(d.abs().max()))
    return gap


def worst(readings: dict, more: dict) -> None:
    """Fold ``more`` into ``readings``, keeping the larger of each."""
    for k, v in more.items():
        readings[k] = max(readings.get(k, 0), v)


def verdict(readings: dict, limits: dict, numbers):
    """-> (correct, checks): each of the judge's ``numbers`` read and within
    its limit.  A number with no reading or no limit, or a limit of a
    number that is not the judge's, is a check that fails (its missing
    side reads None)."""
    names = list(numbers) + sorted(set(limits) - set(numbers))
    checks = {k: {"value": readings.get(k), "limit": limits.get(k)}
              for k in names}
    ok = all(k in numbers and c["value"] is not None
             and c["limit"] is not None and math.isfinite(c["value"])
             and c["value"] <= c["limit"] for k, c in checks.items())
    return ok, checks

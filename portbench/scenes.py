"""The traffic generator: synthetic dual-CMOS scenes from a seed.

One general generator for every traffic mix: a mix is a data file under
``traffic/`` (scene length, PAN2's mounting offset, the MSS band rolls,
optionally CMOS2's MSS band rolls, the noise range, the RRC tables'
spread, the pool size) and this module turns it into scenes on the
device.  The recipe is bench.py's (lines 217-259 of the repository's
JAX-era benchmark): a uniform-noise scene of band pixels; PAN1 is its x4
cubic upsample (``cv::resize`` INTER_CUBIC, float32), PAN2 PAN1 rolled so
that its left ``overlap`` columns see PAN1's right edge shifted by the
mounting offset, band b the scene rolled by the mix's band roll.  A mix
with ``mss2_rolls`` also makes CMOS2's MSS: band b the scene rolled by
``mss2_rolls[b]`` under the prestitched PAN2, with its own RRC table
drawn after the whole pool, so that the rest of the run is byte for byte
the same mix's without the key.  Everything is drawn on the device from
one ``torch.Generator`` seeded with the run's seed, in a few large calls,
so a seed gives the same scenes on every run.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .reference import X4_BASE, X4_W


@dataclass
class Scene:
    """One scene's RAW strips: ``pan1``/``pan2`` (L, W), ``mss`` (4, L/4,
    W/4) and, where the mix has ``mss2_rolls``, CMOS2's ``mss2`` (4, L/4,
    W/4), uint16."""

    pan1: torch.Tensor
    pan2: torch.Tensor
    mss: torch.Tensor
    mss2: torch.Tensor | None = None

    @property
    def pixels(self) -> int:
        """Input pixels: PAN1 + PAN2 + every band of each MSS, each once."""
        n = self.pan1.numel() + self.pan2.numel() + self.mss.numel()
        return n + (0 if self.mss2 is None else self.mss2.numel())


@dataclass
class Tables:
    """The camera's RRC tables, float64 ``(k, b)``: PAN1's and PAN2's (W,),
    the MSS bands' (4, W/4) and, with CMOS2's MSS, its bands' (4, W/4)."""

    pan1: tuple[torch.Tensor, torch.Tensor]
    pan2: tuple[torch.Tensor, torch.Tensor]
    mss: tuple[torch.Tensor, torch.Tensor]
    mss2: tuple[torch.Tensor, torch.Tensor] | None = None


def _upsample4_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    phases = []
    for r in range(4):
        g = [x.index_select(axis, torch.clamp(idx + X4_BASE[r] + c, 0, n - 1))
             for c in range(4)]
        w = [float(v) for v in X4_W[r]]
        phases.append(((g[0] * w[0] + g[1] * w[1]) + g[2] * w[2]) + g[3] * w[3])
    ax = axis % x.dim()
    shape = list(x.shape)
    shape[ax] = 4 * n
    return torch.stack(phases, dim=ax + 1).reshape(shape)


def upsample4(x: torch.Tensor) -> torch.Tensor:
    """x4 cubic upsample, horizontal pass then vertical, float32."""
    x = x.to(torch.float32)
    return _upsample4_axis(_upsample4_axis(x, x.dim() - 1), x.dim() - 2)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_table(g: torch.Generator, traffic: dict, shape: tuple, device):
    """One RRC table ``(k, b)``: gains uniform in ``rrc_gain``, biases
    normal with sd ``rrc_bias_sd``."""
    lo, hi = traffic["rrc_gain"]
    f64 = torch.float64
    k = lo + (hi - lo) * torch.rand(shape, generator=g, dtype=f64,
                                    device=device)
    b = traffic["rrc_bias_sd"] * torch.randn(shape, generator=g, dtype=f64,
                                             device=device)
    return k, b


def make_tables(g: torch.Generator, traffic: dict, width: int, device):
    return Tables(make_table(g, traffic, (width,), device),
                  make_table(g, traffic, (width,), device),
                  make_table(g, traffic, (4, width // 4), device))


def make_scene(g: torch.Generator, traffic: dict, width: int, overlap: int,
               device) -> Scene:
    lines = traffic["scene_lines"]
    bw = width // 4
    lo, hi = traffic["noise_dn"]
    scene = torch.randint(lo, hi, (lines // 4, bw), generator=g,
                          dtype=torch.int32, device=device)
    up = torch.clamp(torch.round(upsample4(scene)), 0, 65535).to(torch.int32)
    pan1 = up.to(torch.uint16)
    dx, dy = traffic["pan2_offset"]
    pan2 = torch.roll(up, (dy, overlap + dx - width), (0, 1)).to(torch.uint16)
    del up
    mss = torch.stack([torch.roll(scene, tuple(r), (0, 1))
                       for r in traffic["band_rolls"]]).to(torch.uint16)
    mss2 = None
    if "mss2_rolls" in traffic:
        # CMOS2's bands lie under PAN2, which the prestitch shifts by the
        # overlap less the width: (overlap - width) / 4 band columns
        shift = (overlap - width) // 4
        mss2 = torch.stack([torch.roll(scene, (r, shift + c), (0, 1))
                            for r, c in traffic["mss2_rolls"]]).to(
                                torch.uint16)
    return Scene(pan1, pan2, mss, mss2)


def make_pool(seed: int, traffic: dict, width: int, overlap: int, device):
    """The run's RRC tables and its pool of ``traffic["pool"]`` distinct
    scenes, in that order from one generator; with ``mss2_rolls``, CMOS2's
    MSS table last."""
    g = generator(seed, device)
    tables = make_tables(g, traffic, width, device)
    pool = [make_scene(g, traffic, width, overlap, device)
            for _ in range(traffic["pool"])]
    if "mss2_rolls" in traffic:
        tables.mss2 = make_table(g, traffic, (4, width // 4), device)
    return tables, pool

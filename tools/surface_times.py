#!/usr/bin/env python3
"""Time the full-surface cv::phaseCorrelate's pieces at the parity
route's shapes.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/surface_times.py [--root DIR] [--iters N]

``--root`` names the checkout whose ``opticalimageprocessor_tpu_torch``
is timed (default: this repository), so that two versions can be timed in
turns on one card; a checkout without kernels (j) and (k) times the plain
chain alone.  Two shapes: a parity registration tile (one PAN spectrum
(1, 1, 16000, 626) against 4 band spectra (1, 4, 16000, 626), surfaces of
16000 x 1250), one of 50 a scene, and the stt's 10 windows pair for pair
((10, 16000, 101), surfaces of 16000 x 200), one group a scene; the
spectra are those of uint16 noise.  Times, each CUDA events around
``--iters`` calls after a warm-up call:

* ``<shape>.crosspower_ms``: kernel (j), ``phasecorr.surface_crosspower``;
  ``<shape>.crosspower_plain_ms``: ``whitened_crosspower``, the plain
  passes it replaces;
* ``<shape>.irfft2_ms``: cuFFT's inverse, which both chains run;
* ``<shape>.peak_ms``: kernel (k) alone, ``phasecorr.surface_peak``;
  ``<shape>.peak_plain_ms``: its plain version, ``_surface_peak_plain``;
  ``<shape>.shifted_argmax_ms``: ``fftshift`` and ``torch.argmax`` on the
  shifted copy, the chain (k) replaces;
* ``<shape>.peak_centroid_ms``: (k) and the centroid gathered from the
  unshifted surfaces (``_peak_and_centroid``);
  ``<shape>.shifted_centroid_ms``: ``fftshift``, ``torch.argmax`` and the
  centroid on the shifted copy;
* ``<shape>.peak_from_spectra_ms``: the whole of ``peak_from_spectra``;
  ``<shape>.replaced_chain_ms``: the plain chain it replaced; with
  ``<shape>.peak_from_spectra_gb`` and ``<shape>.replaced_chain_gb``, the
  device memory each allocates at its peak beyond its inputs.

Beside them the bounds at 3.35 TB/s: (j) reads each spectrum once and
writes each cross-power once (``crosspower_bound_ms``), (k) reads each
surface once (``peak_bound_ms``); and whether both chains' (dx, dy,
response) are the same bits (``same_bits``).  Prints one JSON line with
the card's name and power limit (nvidia-smi) and the package's root.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
# (name, fa's shape, fb's shape, the padded surface)
SHAPES = (
    ("tile", (1, 1, 16000, 1228), (1, 4, 16000, 1228), (16000, 1250)),
    ("stt", (10, 16000, 200), (10, 16000, 200), (16000, 200)),
)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false")
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from opticalimageprocessor_tpu_torch.ops import phasecorr as pc

    kernels = hasattr(pc, "surface_crosspower")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(0)

    def spectra(shape, pad):
        x = torch.randint(0, 65536, shape, generator=gen, device=dev,
                          dtype=torch.int32).to(torch.float32)
        return pc.rfft2_padded(x, pad)

    def replaced(fa, fb, pad):
        corr = torch.fft.irfft2(pc.whitened_crosspower(fa, fb), s=pad)
        shifted = torch.fft.fftshift(corr, dim=(-2, -1))
        cxc, cyc, s = pc._argmax_centroid(shifted)
        return pad[1] / 2.0 - cxc, pad[0] / 2.0 - cyc, s

    out = {}
    it = args.iters
    for name, sa, sb, pad in SHAPES:
        fa, fb = spectra(sa, pad), spectra(sb, pad)
        c = pc.whitened_crosspower(fa, fb)
        surf = torch.fft.irfft2(c, s=pad)
        t = {
            "crosspower_plain_ms": lambda: pc.whitened_crosspower(fa, fb),
            "irfft2_ms": lambda: torch.fft.irfft2(c, s=pad),
            "shifted_argmax_ms": lambda: torch.argmax(
                torch.fft.fftshift(surf, dim=(-2, -1)).reshape(
                    -1, pad[0] * pad[1]), dim=1),
            "shifted_centroid_ms": lambda: pc._argmax_centroid(
                torch.fft.fftshift(surf, dim=(-2, -1))),
            "replaced_chain_ms": lambda: replaced(fa, fb, pad),
        }
        if kernels:
            t.update({
                "crosspower_ms": lambda: pc.surface_crosspower(fa, fb),
                "peak_ms": lambda: pc.surface_peak(surf),
                "peak_plain_ms": lambda: pc._surface_peak_plain(surf),
                "peak_centroid_ms": lambda: pc._peak_and_centroid(surf),
                "peak_from_spectra_ms": lambda: pc.peak_from_spectra(
                    fa, fb, pad),
            })
        for key, fn in t.items():
            out[f"{name}.{key}"] = time_ms(torch, fn, it)
        chains = {"replaced_chain": lambda: replaced(fa, fb, pad)}
        if kernels:
            chains["peak_from_spectra"] = lambda: pc.peak_from_spectra(
                fa, fb, pad)
        for key, fn in chains.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            out[f"{name}.{key}_gb"] = \
                (torch.cuda.max_memory_allocated() - base) / 1e9
        if kernels:
            got = pc.peak_from_spectra(fa, fb, pad)
            want = replaced(fa, fb, pad)
            out[f"{name}.same_bits"] = all(
                torch.equal(g.contiguous().view(torch.int32),
                            w.contiguous().view(torch.int32))
                for g, w in zip(got, want))
        # fa once, each band's fb once, each cross-power once; each surface
        # once
        nbytes = (fa.numel() + 2 * fb.numel()) * 8
        out[f"{name}.crosspower_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        out[f"{name}.peak_bound_ms"] = \
            surf.numel() * 4 / HBM_BYTES_PER_S * 1e3
        del fa, fb, c, surf
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "root": args.root,
                      "shapes": {n: [list(a), list(b), list(p)]
                                 for n, a, b, p in SHAPES},
                      "launches_a_parity_scene": {"tile": 50, "stt": 1},
                      **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

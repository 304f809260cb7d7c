#!/usr/bin/env python3
"""Time the fast registration's spectra at the scene's shapes.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/row_fft_times.py [--root DIR] [--iters N]

``--root`` names the checkout whose ``opticalimageprocessor_tpu_torch``
is timed (default: this repository), so that two versions can be timed in
turns on one card; a checkout without ``ops/row_fft`` times cuFFT alone.
The shapes are the 160000-line scene's registration: T = 50 PAN tiles of
(16000, 1228) and 50 band quads of (4, 4000, 307), uint16 noise as float32.
Times, each CUDA events around ``--iters`` calls after a warm-up call:

* ``pan_rows_ms``, ``band_rows_ms``: kernel (i), the row DFTs alone
  (``row_fft.pan_row_dft`` / ``band_row_dft``);
* ``pan_cols_ms``, ``band_cols_ms``: cuFFT's column pass alone on (i)'s
  output (``torch.fft.fft`` over the last axis of its column-major
  storage: one plan, out of place);
* ``pan_spectra_ms``, ``band_spectra_ms``: (i) and the column pass, as
  ``correlate_tiles`` takes them (``row_fft.pan_spectra`` /
  ``band_spectra``);
* ``rfft2_ms``, ``fft2_ms``: ``torch.fft.rfft2`` of the PAN stack and
  ``torch.fft.fft2`` of the band stack (with its real -> complex cast),
  the cuFFT route the port took before (i);
* ``rfft_rows_ms``, ``fft_rows_ms``: cuFFT's row transforms alone
  (``torch.fft.rfft`` / ``fft`` over the last axis).

Beside them (i)'s bounds, each row read once and its bins written once at
3.35 TB/s (``pan_bound_ms``, ``band_bound_ms``), and (i)'s largest relative
RMS error a tile over four tiles against the float64 FFT of the same rows,
with cuFFT's float32 one.  Prints one JSON line with the card's name and
power limit (nvidia-smi) and the package's root.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

T, M, COLS, NB, BM, P = 50, 16000, 1228, 4, 4000, 307
KEEP = COLS // 2 + 1
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


def rel_rms(torch, got, want) -> float:
    got, want = got.to(torch.complex128), want.to(torch.complex128)
    return float((got - want).abs().pow(2).mean().sqrt()
                 / want.abs().pow(2).mean().sqrt())


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
    try:
        from opticalimageprocessor_tpu_torch.ops import row_fft
    except ImportError:
        row_fft = None

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(0)

    def noise(*shape):
        return torch.randint(0, 65536, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.float32)

    out = {}
    it = args.iters
    for kind, shape in (("pan", (T, M, COLS)), ("band", (T, NB, BM, P))):
        x = noise(*shape)
        pan = kind == "pan"
        lib2d = (lambda: torch.fft.rfft2(x)) if pan else \
            (lambda: torch.fft.fft2(x))
        out["rfft2_ms" if pan else "fft2_ms"] = time_ms(torch, lib2d, it)
        lib1d = (lambda: torch.fft.rfft(x)) if pan else \
            (lambda: torch.fft.fft(x))
        out["rfft_rows_ms" if pan else "fft_rows_ms"] = time_ms(torch, lib1d,
                                                                it)
        if row_fft is not None:
            rows = row_fft.pan_row_dft if pan else row_fft.band_row_dft
            spectra = row_fft.pan_spectra if pan else row_fft.band_spectra
            out[f"{kind}_rows_ms"] = time_ms(torch, lambda: rows(x), it)
            y = rows(x)
            out[f"{kind}_cols_ms"] = time_ms(
                torch, lambda: row_fft._columns(y), it)
            del y
            out[f"{kind}_spectra_ms"] = time_ms(torch, lambda: spectra(x), it)
            got = rows(x)
            fn = torch.fft.rfft if pan else torch.fft.fft
            errs, lib = [], []
            for t in (0, 17, 33, 49):
                want = fn(x[t].double())
                errs.append(rel_rms(torch, got[t], want))
                lib.append(rel_rms(torch, fn(x[t]), want))
                del want
            out[f"{kind}_rel_rms"] = max(errs)
            out[f"{kind}_cufft_rel_rms"] = max(lib)
            del got
        # a row in, its bins out (the bands' real -> complex: 4 + 8 bytes)
        nbytes = x.numel() * 4 + (x.numel() // COLS * KEEP * 8 if pan
                                  else x.numel() * 8)
        out[f"{kind}_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        del x
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "root": args.root,
                      "shape": f"T={T} PAN ({M}, {COLS}), bands ({NB}, {BM}, "
                               f"{P})", **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

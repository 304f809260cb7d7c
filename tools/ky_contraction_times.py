#!/usr/bin/env python3
"""Time the fast registration's ky contraction at the scene's shapes.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/ky_contraction_times.py [--root DIR]

``--root`` names the checkout whose ``opticalimageprocessor_tpu_torch``
is timed (default: this repository), so that two versions can be timed in
turns on one card, e.g. a parent commit unpacked with ``git archive`` into
a directory that ``.gitignore`` lists.  The shape is the 160000-line
scene's: T = 50 tiles x NB = 4 bands, M = 16000 ky rows, wx = 129 window
columns, N = 1228, win_y = 64, random float32 surfaces.  Times, each CUDA
events around 20 calls after a warm-up call, float32 with TF32 off:

* ``pairs_ms``: ``phasecorr.contract_rows`` on (T, NB, M, wx) ``dr`` /
  ``di``, 200 broadcast (129, M) x (M, wx) products a part;
* ``stacked_ms``: ``phasecorr_cuda.contract_rows_stacked`` on the same
  values in kernel (b)'s layout ``D`` (2M, T*NB*wx), where the package has
  it (kernel (g), ``csrc/ky_gemm.cu``);
* ``gemm_129_ms``, ``gemm_128_gemv_ms``: the stacked product in cuBLAS,
  all 129 rows in one GEMM, and 128 rows in one GEMM and the last in a
  GEMV, each divided by M*N;
* ``operand_ms``: building kernel (g)'s weights from the cached
  evaluation matrices, as ``contract_rows_stacked`` does at each call.

Beside them the bounds: the 129-row product's 2 x 129 x 2M x T*NB*wx
float32 FLOP at 67 TFLOP/s (``bound_ms``), and kernel (g)'s half of it,
each of the 129 window rows over M rows of ``D`` (``bound_g_ms``), each
against ``D`` read once at 3.35 TB/s; and each result's largest gap to
``pairs``, relative to its largest magnitude.  Prints one JSON line with
the card's name and power limit (nvidia-smi) and the package's root.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

T, NB, M, WX, N, WIN_Y = 50, 4, 16000, 129, 1228, 64
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


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

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(Path(args.root).resolve()))
    from opticalimageprocessor_tpu_torch.ops import phasecorr
    from opticalimageprocessor_tpu_torch.ops import phasecorr_cuda as pcc

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    dr = torch.randn((T, NB, M, WX), generator=gen, device=dev)
    di = torch.randn((T, NB, M, WX), generator=gen, device=dev)
    # D: rows ky the real parts, M + ky the imaginary ones; column
    # (t * NB + b) * wx + w
    d = torch.cat((dr, di), dim=2).permute(2, 0, 1, 3).reshape(2 * M, -1)
    cy_c, cy_s = phasecorr.eval_consts(M, M, WIN_Y, True, dev)
    scale = float(M * N)

    def operand():
        return pcc._ky_weights(M, WIN_Y, dev)

    w = torch.cat((cy_c.T, -cy_s.T), dim=1)

    def gemm_129():
        return (torch.matmul(w, d) / scale).view(-1, T, NB, WX).permute(
            1, 2, 0, 3)

    def gemm_128_gemv():
        out = torch.empty((w.shape[0], d.shape[1]), device=dev)
        torch.matmul(w[:-1], d, out=out[:-1])
        torch.mv(d.T, w[-1], out=out[-1])
        out /= scale
        return out.view(-1, T, NB, WX).permute(1, 2, 0, 3)

    def pairs():
        return phasecorr.contract_rows(dr, di, M, N, WIN_Y)

    runs = {"pairs": pairs, "gemm_129": gemm_129,
            "gemm_128_gemv": gemm_128_gemv}
    if hasattr(pcc, "contract_rows_stacked"):
        runs["stacked"] = lambda: pcc.contract_rows_stacked(
            d, M, N, WIN_Y, T, NB)
    want = pairs()
    out = {}
    for name, fn in runs.items():
        got = fn()
        out[f"{name}_rel_err"] = float(
            (got - want).abs().max() / want.abs().max())
        del got
        out[f"{name}_ms"] = time_ms(torch, fn)
    if hasattr(pcc, "_ky_weights"):
        out["operand_ms"] = time_ms(torch, operand)
    flop = 2 * w.shape[0] * 2 * M * T * NB * WX
    read_s = 4 * d.numel() / HBM_BYTES_PER_S
    out["bound_ms"] = max(flop / F32_FLOPS, read_s) * 1e3
    out["bound_g_ms"] = max(flop / 2 / F32_FLOPS, read_s) * 1e3
    print(json.dumps({"card": card, "root": args.root,
                      "shape": f"T={T} NB={NB} M={M} wx={WX} win_y={WIN_Y}",
                      **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (opticalimageprocessor_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

or, to see where one forward's device time goes (torch.profiler at 32768
and 65536 lines: device ms per class, busy time as the union of all device
intervals, idle share; no other phase runs):

    python3 chip_smoke.py --profile

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit, torch/CUDA versions, and the build of
   the five hand-written kernels from ``opticalimageprocessor_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, with its stated tolerance, both timed
   with CUDA events, beside the kernel's bound (the bytes it must move at
   3.35 TB/s against its operations at the card's peak for their type);
   kernel (c) at the scene's 4 interleaved bands, the prestitch of PAN2
   and a file-align band, kernels (b) and (d) also at the 32768-line
   scene's shapes (20 tiles; a 32768-row pair), and (b) beside cuBLAS's
   bare bf16 GEMM of the same real-ified product ("GEMM only, no
   whitening"), which the port never calls; kernel (e) at 9 shapes (U 18
   to 100, 8189 rows, widths 1000 / 1001 / 3072), at 0 ulp, beside cuDNN's
   depthwise conv1d of the same sum (also never called by the port);
   kernel (c) also at MSS2's row bound 6 on the scene's 4 bands, and (d)
   at a streamed section's shape (4116 rows) with the prestitched PAN2
   written out;
3. the CLI entry (``cli.main(["scene", "--mss2", ...])``: the whole
   sample-task workflow) on a 16384-line scene of RAW files built like
   bench.py's synthesis plus a CMOS2 MSS, checking the outputs' shapes,
   the recovered band shifts of both CMOS and the stt translation, that
   the stitched left half is RRC(PAN1) and the stitched MSS the two
   ALIGNED.TIFFs byte for byte -- with every kernel's launch count read
   around this run;
4. ``ScenePipeline`` on device-resident tensors at 32768 lines: kernel
   path against the plain path with pinned estimates, then timed;
5. the file workflow through ``cli.main`` on 16384-line RAW files:
   ``prestitch --fast`` on a CMOS pair 3 rows apart (kernel (c)'s route)
   and on one 9 rows apart (the staged route, kernel (e)), the default
   ``--fast`` registration + alignment, and ``stitch`` -- checking the
   recovered translations and band rolls, the RRC files against a numpy
   oracle byte for byte, the PRESTT files and the ALIGNED.TIFF against the
   plain route at 0 DN, and the stitched raster's left half against PAN1,
   with the launch counts read around each command;
6. the streamed route: ``scene --stream --mss2`` and the resident
   ``scene --mss2`` through ``cli.main`` on one 34816-line RAW scene in
   4096-line sections, every output byte-identical and the streamed
   PRESTT.RAW equal to the resident prestitched PAN2, with the launches a
   section; each route's estimate and transform called directly for its
   peak device memory (the streamed transform below a quarter of the
   resident one), and one streamed transform under torch.profiler (copy
   and kernel ms, their union);
7. the parity route: ``remap_section_u16`` (plain PyTorch, no kernel of
   its own) at 0 DN against a numpy copy of the ``cv::remap`` oracle in
   both coordinate modes on a 2048 x 3072 band section and a 1024 x 12288
   constant-shift section, its ms a 30000 x 12288 section and a 20000 x
   3072 band section beside its bound and its peak device memory; then
   ``prestitch`` and the default action through ``cli.main`` without
   ``--fast`` in each ``--coord-mode`` and with ``--fast``, on 40960-line
   RAW files (two 30000-row prestitch sections with the rolling-buffer
   bottom cut; two 5200-line alignment sections): SectionaryRemap's line
   count, each parity output at 0 DN against the oracle on row windows at
   every section edge and the bottom cut, > 1 DN from the ``--fast`` one
   on < 1% of each section's first 1024 rows (continuous mode), the modes
   different, kernel (a) launched;
8. docs/sample-task.sh from the raw downlink: phase 5's 16384-line scene
   framed into two downlinks (CMOS1: PAN1 and the MSS; CMOS2: PAN2), 16
   image frames each with random AUX blocks, leading junk, empty frames,
   frames flagged invalid and CRC-corrupted duplicates; ``auxsep`` through
   ``cli.main`` on each (the native host library required), its .IMDT,
   .PAN.RAW, .MSS.RAW and .AUX byte for byte what was framed, its stages'
   s and MB/s; ``prestitch --fast --profile``, the default ``--fast`` and
   ``stitch`` on the separated files, their outputs at phase 5's SHA-256;
   from the profile's trace the kernel events of (a) and (c), the stage
   spans, and the h2d / d2h / kernel ms and their union; the golden
   downlinks of tests/golden through ``auxsep`` (the JPEG2000 one gives
   rc 2 with the JAX package's diagnostic where no codec imports);
9. the line mesh (``--mesh``), as N shards on the one card
   (``LineMesh([cuda:0] * 4)``): after phase 4, the sharded scene and
   MSS2 align through the module API at 32780 lines (uneven shards), the
   estimates within 1e-5 px (fit) and 1e-3 px (stt) of the resident
   route's and, pinned, every raster byte for byte the resident one, one
   sharded forward's ms and peak memory beside the resident forward's;
   after phase 5, ``run_sharded_align`` (both ``--coord-mode``s) and
   ``run_sharded_prestitch`` on its files, 4 shards and 1 byte for byte
   alike, 0 DN against the plain staged remap (continuous, the prestitch)
   and against the cv::remap oracle at every shard seam (quantized), and
   ``prestitch --mesh 1`` / the default ``--mesh 1`` through ``cli.main``;
   after phase 6, ``scene --mesh 1 --mss2`` and ``scene --stream --mesh 1
   --mss2`` at phase 6's SHA-256, ``scene --mesh 2`` refused on one card
   (rc 2), and a partial ``OIP_DIST_*`` env refused in a subprocess.

The last two lines of standard output are the kernels' JSON record
(launches over phases 3, 5, 6, 7, 8 and 9, error, kernel, plain and bound ms at
phase 2's shapes, plus the scene shapes' ms and bound for (b) and (d), the
streamed section's for (d), the file commands' and MSS2's shapes' ms and
bound for (c), and each of (e)'s shapes' ms and bound) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gzip
import hashlib
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

ROOT = Path(__file__).resolve().parent
W = 12288            # PAN pixels per line (camera geometry)
BW = W // 4          # MSS band pixels per line
FOLD_COLS = 200
SEED = 0


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def rrc_oracle(src: np.ndarray, k: np.ndarray, b: np.ndarray) -> np.ndarray:
    """numpy float64 RRC with the reference's cast (imageop.h:129-138):
    trunc toward zero through int32, low 16 bits, |v| >= 2^31 -> 0."""
    v = k[..., None, :] * src.astype(np.float64) + b[..., None, :]
    t = np.trunc(v)
    bad = ~(np.abs(v) < 2147483648.0)
    i = np.where(bad, 0.0, t).astype(np.int64)
    return (i & 0xFFFF).astype(np.uint16)


def time_ms(fn, iters: int) -> float:
    import torch

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


# the card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): memory
# bytes/s, bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound(nbytes: float, **ops) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, against each class of
    operations at its peak (``ops``: name -> (count, rate)); the larger
    one bounds."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    for name, (count, rate) in ops.items():
        times[name] = count / rate * 1e3
    by = max(times, key=times.get)
    return dict(bound_ms=times[by], bound_by=by)


def crosspower_bound(tiles, bands, M, keep, m, n, wx) -> dict:
    """Kernel (b): the PAN and band spectra (complex64) and Hr, Hc read, the
    float32 real and imaginary outputs written; the bf16 GEMM (2 FLOP a
    multiply-add of the (T*NB*M, 2*keep) x (2*keep, 2*wx) real product)
    and the float32 whitening (~40 FLOP an element)."""
    nbytes = 8 * (tiles * M * keep + tiles * bands * m * n + M + keep) \
        + 2 * 4 * tiles * bands * M * wx
    r = bound(nbytes,
              operations=(8 * tiles * bands * M * keep * wx, BF16_FLOPS),
              whitening=(40 * tiles * bands * M * keep, F32_FLOPS))
    if r["bound_by"] != "bytes":
        r["bound_by"] = "operations"
    return r


def stitch_bound(rows, width, fold, want_prestt=False) -> dict:
    """Kernel (d): both PANs read (uint16), the (rows, 2*(W - fold)) raster
    written (and with ``want_prestt`` the (rows, W) prestitched PAN2), four
    float64 parameter rows."""
    return bound(2 * 2 * rows * width + 2 * rows * 2 * (width - fold)
                 + (2 * rows * width if want_prestt else 0) + 4 * 8 * width)


def crosspower_vs_plain(tag, kargs, packed, M, N, win_y, win_x):
    """Kernel (b) against ``_crosspower_plain`` on the same operands
    ``kargs`` (fpan, fband, hr, hc, ex_c, ex_s): the peaks within 1e-3 px
    and 1e-4 of response, the surfaces within 1e-4 relative.  -> (max |d
    shift| px, max |d response|, surface rel err, window rel err, the
    kernel's peaks)."""
    import torch

    from opticalimageprocessor_tpu_torch.ops import phasecorr
    from opticalimageprocessor_tpu_torch.ops import phasecorr_cuda as pcc

    dr_k, di_k = pcc._crosspower_cuda(*kargs, packed)
    dr_p, di_p = pcc._crosspower_plain(*kargs)
    torch.cuda.synchronize()
    corr_k = phasecorr.contract_rows(dr_k, di_k, M, N, win_y)
    corr_p = phasecorr.contract_rows(dr_p, di_p, M, N, win_y)
    peak_k = phasecorr._centroid_on_window(corr_k, win_y, win_x)
    peak_p = phasecorr._centroid_on_window(corr_p, win_y, win_x)
    d_shift = max(float((peak_k[i] - peak_p[i]).abs().max()) for i in (0, 1))
    d_resp = float((peak_k[2] - peak_p[2]).abs().max())
    # every (tile, band, ky, window column) of the kernel's output, real and
    # imaginary, and the whole contracted 129 x 129 window, relative to the
    # plain version's largest magnitude: a column block or a share of the
    # kx sum that the kernel got wrong shows here even away from the peak
    # (one zeroed window column, or kx >= 512 left out of the sum, reads
    # 0.12-0.17 on a 1-tile 4000 x 1228 case; the kernel reads ~2e-6)
    surf = max(float((k - p).abs().max() / p.abs().max())
               for k, p in ((dr_k, dr_p), (di_k, di_p)))
    window = float((corr_k - corr_p).abs().max() / corr_p.abs().max())
    say(f"{tag}: max |d shift| {d_shift:.3g} px, |d response| "
        f"{d_resp:.3g}, surface rel err {surf:.3g}, window rel err "
        f"{window:.3g}; dx {peak_k[0].tolist()} dy {peak_k[1].tolist()} "
        f"resp {peak_k[2].tolist()}")
    check(d_shift <= 1e-3 and d_resp <= 1e-4, f"{tag}: peaks vs plain")
    check(surf <= 1e-4 and window <= 1e-4,
          f"{tag}: surface {surf:.3g} / window {window:.3g} vs plain "
          "above 1e-4")
    return d_shift, d_resp, surf, window, peak_k


def dn_diff(a, b):
    import torch

    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return int(d.max()), float((d > 0).double().mean())


def rand_params(rng, *shape):
    k = 0.98 + 0.04 * rng.random(shape)
    b = rng.normal(0, 20, shape)
    return k, b


def mss2_rolls():
    """Band b of the synthetic CMOS2 MSS is the scene rolled by these
    (rows, columns): its own roll ((b + 1) mod 2, 1 - b) plus the columns
    that put it under the prestitched PAN2 ((FOLD_COLS - W) / 4 band px)."""
    return [((b + 1) % 2, (FOLD_COLS - W) // 4 + 1 - b) for b in range(4)]


def synth_scene(torch, rng, lines_pan, dev, dy=2, mss2=False):
    """bench.py:217-233's synthesis with the port's upsample4_f32: PAN1 =
    x4 cubic upsample of a noise scene, PAN2 = PAN1 rolled by (dy, dx -3)
    so its left 200 columns see PAN1's right edge, band b = the scene
    rolled by (b mod 2, b - 1); with ``mss2`` also CMOS2's MSS, the scene
    rolled by :func:`mss2_rolls`.  bench.py's dy is +2; at that offset (half
    a scene pixel) the upsampled content's correlation peak is flat-topped
    and the 5x5 centroid reads ~1.66 in the JAX package and the port
    alike, so the run that checks the recovered translation uses +3."""
    from opticalimageprocessor_tpu_torch.ops.resample import upsample4_f32

    scene = torch.from_numpy(
        rng.integers(2000, 42000, (lines_pan // 4, BW), dtype=np.int32)
    ).to(dev)
    up = torch.clamp(torch.round(upsample4_f32(scene)), 0, 65535).to(
        torch.int32)
    pan1 = up.to(torch.uint16)
    pan2 = torch.roll(up, (dy, FOLD_COLS - 3 - W), (0, 1)).to(torch.uint16)
    del up
    mss = torch.stack(
        [torch.roll(scene, (b % 2, b - 1), (0, 1)) for b in range(4)]
    ).to(torch.uint16)
    if not mss2:
        return pan1, pan2, mss
    return pan1, pan2, mss, torch.stack(
        [torch.roll(scene, r, (0, 1)) for r in mss2_rolls()]
    ).to(torch.uint16)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(dev, records):
    import torch

    from opticalimageprocessor_tpu_torch.ops import phasecorr, rrc
    from opticalimageprocessor_tpu_torch.ops import phasecorr_cuda as pcc
    from opticalimageprocessor_tpu_torch.ops import resample

    rng = np.random.default_rng(SEED)

    # (a) RRC: all 65536 values x 9 (k, b) cases, and a random strip
    cases = [(1.0, 0.0), (0.5, 0.5), (2.0, -65536.0),
             (0.9987654321, 12.3456789), (1.0123456789, -17.25),
             (3.14159265358979, -100000.5), (-0.75, 30000.0),
             (1e-9, 0.999999999), (70000.0, 0.0)]
    src = np.tile(np.arange(65536, dtype=np.uint16), (len(cases), 1, 1))
    k = np.array([[c[0]] * 65536 for c in cases])
    b = np.array([[c[1]] * 65536 for c in cases])
    want = rrc_oracle(src, k, b)
    args = [torch.from_numpy(x).to(dev) for x in (src, k, b)]
    got = rrc.rrc_apply(*args)
    plain = rrc._rrc_plain(*args)
    torch.cuda.synchronize()
    check(np.array_equal(got.cpu().numpy(), want), "rrc sweep vs oracle")
    check(np.array_equal(plain.cpu().numpy(), want), "rrc plain vs oracle")
    strip = rng.integers(0, 65536, (2048, W), dtype=np.uint16)
    ks, bs = rand_params(rng, W)
    args = [torch.from_numpy(x).to(dev) for x in (strip, ks, bs)]
    got = rrc.rrc_apply(*args).cpu().numpy()
    check(np.array_equal(got, rrc_oracle(strip, ks, bs)), "rrc strip")
    # main-path shape: the 4 MSS bands of a 32768-line scene
    mss = torch.from_numpy(
        rng.integers(0, 65536, (4, 8192, BW), dtype=np.uint16)).to(dev)
    km, bm = (torch.from_numpy(x).to(dev) for x in rand_params(rng, 4, BW))
    dmax = dn_diff(rrc.rrc_apply(mss, km, bm), rrc._rrc_plain(mss, km, bm))[0]
    check(dmax == 0, "rrc bands vs plain")
    records["rrc"] = dict(
        max_abs_err=float(dmax),
        ms=time_ms(lambda: rrc.rrc_apply(mss, km, bm), 20),
        plain_ms=time_ms(lambda: rrc._rrc_plain(mss, km, bm), 5),
        library_ms=None,
        shape="(4, 8192, 3072) u16",
        # uint16 in and out, float64 (k, b) per column
        **bound(4 * mss.numel() + 16 * km.numel()),
    )
    del mss
    say(f"[a] rrc: byte-exact; {records['rrc']}")

    # (b) windowed cross-power: 2 tiles x 4 bands at the registration shapes
    M, N, m, n, win = 16000, 1228, 4000, 307, 64
    keep = N // 2 + 1
    base = torch.from_numpy(
        rng.integers(2000, 42000, (2, m, n), dtype=np.int32)).to(dev)
    pan = resample.upsample4_f32(base)
    bands = torch.stack(
        [torch.roll(base, (b % 2, b - 1), (1, 2)) for b in range(4)], dim=1)
    fpan = phasecorr.rfft2_padded(pan, (M, N))
    fband = phasecorr.band_full_spectrum_small(bands)
    hr = phasecorr.filter_response(m, 4, dev)
    hc = phasecorr.filter_response(n, 4, dev)[:keep]
    ex_c, ex_s = phasecorr.eval_consts(N, keep, win, False, dev)
    kargs = (fpan, fband, hr, hc, ex_c, ex_s)
    packed = pcc.packed_eval_operands(N, keep, win, dev)
    d_shift, d_resp, surf, window, peak_k = crosspower_vs_plain(
        "[b] crosspower", kargs, packed, M, N, win, win)
    check(bool((peak_k[2] >= 0.4).all()), "crosspower responses below 0.4")
    wx = 2 * win + 1
    records["crosspower"] = dict(
        max_abs_err=d_shift, surface_rel_err=surf, window_rel_err=window,
        ms=time_ms(lambda: pcc._crosspower_cuda(*kargs, packed), 5),
        plain_ms=time_ms(lambda: pcc._crosspower_plain(*kargs), 2),
        library_ms=None,
        shape="T=2 tiles x 4 bands, M=16000 keep=615 m=4000 n=307 win=64",
        **crosspower_bound(2, 4, M, keep, m, n, wx),
    )
    del fpan, fband, pan, bands
    torch.cuda.empty_cache()
    say(f"[b] {records['crosspower']}")
    # the scene's shape: 20 tiles (2 sections x 10 slices of a 32768-line
    # scene) x 4 bands, kernel only
    tiles = 20
    base = torch.from_numpy(
        rng.integers(2000, 42000, (tiles, m, n), dtype=np.int32)).to(dev)
    bands = torch.stack(
        [torch.roll(base, (b % 2, b - 1), (1, 2)) for b in range(4)], dim=1)
    fpan = phasecorr.rfft2_padded(resample.upsample4_f32(base), (M, N))
    fband = phasecorr.band_full_spectrum_small(bands)
    del base, bands
    kargs = (fpan, fband, hr, hc, ex_c, ex_s)
    scene = dict(
        ms=time_ms(lambda: pcc._crosspower_cuda(*kargs, packed), 5),
        shape="T=20 tiles x 4 bands, M=16000 keep=615 m=4000 n=307 win=64",
        **crosspower_bound(tiles, 4, M, keep, m, n, wx))
    del fpan, fband
    torch.cuda.empty_cache()
    say(f"[b] scene shape: {json.dumps(scene)}")
    records["crosspower"].update(scene_ms=scene["ms"],
                                 scene_bound_ms=scene["bound_ms"])
    # yardstick for the product alone: cuBLAS's bf16 GEMM of the real-ified
    # operands, (T*4*M, 2*624) x (2*624, 272), no whitening, at both shapes
    # (the port never calls it)
    kp2 = 2 * pcc.KX_CHUNK * (-(-keep // pcc.KX_CHUNK))
    gemm = {}
    for t in (2, tiles):
        a = torch.randn((t * 4 * M, kp2), device=dev).to(torch.bfloat16)
        bm_ = torch.randn((kp2, 2 * pcc.N_PAD), device=dev).to(torch.bfloat16)
        gemm[t] = time_ms(lambda: torch.matmul(a, bm_), 5)
        del a, bm_
        torch.cuda.empty_cache()
    say(f"[b] GEMM only, no whitening (torch.matmul bf16 ({tiles}*4*{M}, "
        f"{kp2}) x ({kp2}, {2 * pcc.N_PAD})): T=2 {gemm[2]:.4f} ms, "
        f"T={tiles} {gemm[tiles]:.4f} ms")
    records["crosspower"].update(gemm_only_ms=gemm[2],
                                 scene_gemm_only_ms=gemm[tiles])

    phase_remap(dev, rng, records)
    torch.cuda.empty_cache()
    say(f"[c] {records['remap_band']}")

    # (d) stitch tail: 4096 x 12288, pinned and clamp-edge translations
    rows = 4096
    p1 = torch.from_numpy(
        rng.integers(0, 65536, (rows, W), dtype=np.uint16)).to(dev)
    p2 = torch.from_numpy(
        rng.integers(0, 65536, (rows, W), dtype=np.uint16)).to(dev)
    k1, b1, k2, b2 = (torch.from_numpy(x).to(dev)
                      for x in (*rand_params(rng, W), *rand_params(rng, W)))
    fold = FOLD_COLS // 2
    skw = dict(block=128, halo=16, want_prestt=False)
    worst = 0
    for dx, dy in ((-2.7, 1.6), (14.0, 6.0), (-14.0, -6.0), (14.0, -6.0)):
        a = (p1, p2, k1, b1, k2, b2, dx, dy, fold)
        got = resample._stitch_tail_cuda(*a, **skw)
        plain = resample._stitch_tail_plain(*a, **skw)
        torch.cuda.synchronize()
        left = W - fold
        check(bool((got[:, :left].to(torch.int32)
                    == plain[:, :left].to(torch.int32)).all()),
              f"stitch left half not byte-exact at {(dx, dy)}")
        dmax, share = dn_diff(got[:, left:], plain[:, left:])
        say(f"[d] stitch_tail dx {dx} dy {dy}: left exact, right max "
            f"{dmax} DN on {share:.4%}")
        check(dmax == 0, "stitch right half vs plain")
        worst = max(worst, dmax)
    a = (p1, p2, k1, b1, k2, b2, -2.7, 1.6, fold)
    records["stitch_tail"] = dict(
        max_abs_err=float(worst),
        ms=time_ms(lambda: resample._stitch_tail_cuda(*a, **skw), 20),
        plain_ms=time_ms(lambda: resample._stitch_tail_plain(*a, **skw), 3),
        library_ms=None,
        shape="(4096, 12288) u16 pair -> (4096, 24376)",
        **stitch_bound(rows, W, fold),
    )
    del p1, p2
    torch.cuda.empty_cache()
    say(f"[d] {records['stitch_tail']}")
    # the scene's shape: a 32768-line pair, block 128, halo 16
    rows = 32768
    p1 = torch.from_numpy(
        rng.integers(0, 65536, (rows, W), dtype=np.uint16)).to(dev)
    p2 = torch.from_numpy(
        rng.integers(0, 65536, (rows, W), dtype=np.uint16)).to(dev)
    a = (p1, p2, k1, b1, k2, b2, -2.7, 1.6, fold)
    got = resample._stitch_tail_cuda(*a, **skw)
    plain = resample._stitch_tail_plain(*a, **skw)
    torch.cuda.synchronize()
    dmax = dn_diff(got, plain)[0]
    del got, plain
    check(dmax == 0, "stitch tail at 32768 rows vs plain")
    scene = dict(
        ms=time_ms(lambda: resample._stitch_tail_cuda(*a, **skw), 10),
        max_abs_err=float(dmax),
        shape="(32768, 12288) u16 pair -> (32768, 24376)",
        **stitch_bound(rows, W, fold))
    del p1, p2
    torch.cuda.empty_cache()
    say(f"[d] scene shape: {json.dumps(scene)}")
    records["stitch_tail"].update(scene_ms=scene["ms"],
                                  scene_bound_ms=scene["bound_ms"])
    # a streamed section's shape: 4096 rows + the 2 x 10 halo rows of the
    # prestitch's row bound 8, with the prestitched PAN2 written out (--mss2)
    rows = 4096 + 20
    p1 = torch.from_numpy(
        rng.integers(0, 65536, (rows, W), dtype=np.uint16)).to(dev)
    p2 = torch.from_numpy(
        rng.integers(0, 65536, (rows, W), dtype=np.uint16)).to(dev)
    skw = dict(block=128, halo=16, want_prestt=True)
    for dx, dy in ((-2.7, 1.6), (14.0, -6.0)):
        a = (p1, p2, k1, b1, k2, b2, dx, dy, fold)
        got = resample._stitch_tail_cuda(*a, **skw)
        plain = resample._stitch_tail_plain(*a, **skw)
        torch.cuda.synchronize()
        d = [dn_diff(g, q)[0] for g, q in zip(got, plain)]
        say(f"[d] section (4116, 12288) with prestt, dx {dx} dy {dy}: "
            f"stitched max {d[0]} DN, prestt max {d[1]} DN")
        check(d == [0, 0], "stitch tail with prestt vs plain")
    a = (p1, p2, k1, b1, k2, b2, -2.7, 1.6, fold)
    section = dict(
        ms=time_ms(lambda: resample._stitch_tail_cuda(*a, **skw), 20),
        shape="(4116, 12288) u16 pair -> (4116, 24376) + prestt (4116, "
              "12288)",
        **stitch_bound(rows, W, fold, want_prestt=True))
    del p1, p2, got, plain
    torch.cuda.empty_cache()
    say(f"[d] streamed section shape: {json.dumps(section)}")
    records["stitch_tail"].update(section_ms=section["ms"],
                                  section_bound_ms=section["bound_ms"])

    phase_row_pass(dev, rng, records)


def row_pass_bound(rows, width, n_taps) -> dict:
    """Kernel (e): the padded strip and the weights read, the output written
    (float32); U multiplies and U adds an output at the float32 peak."""
    return bound(4 * ((rows + n_taps - 1) * width + n_taps * width
                      + rows * width),
                 operations=(2 * n_taps * rows * width, F32_FLOPS))


def phase_row_pass(dev, rng, records):
    """Kernel (e) at 0 ulp against its plain version: the staged remap's
    8192-row chunk at the camera width for row bounds 10, 7 and 16 (U 24,
    18, 36), row bound 30 (U 64) on 2048 rows, 8189 rows (no K or row tile
    divides it), the widths 3072, 1000 and 1001 (odd: one column a thread)
    and row bound 48 (U 100: the weights staged in chunks of taps); each
    timed beside its bound.  Yardstick at U 18 / 24 / 36: the same sum as
    cuDNN's depthwise conv1d (``groups=W``) on a channels-major copy made
    outside the timing, within 1e-5 of the plain version's largest
    magnitude (it rounds in its own order)."""
    import torch
    import torch.nn.functional as F

    from opticalimageprocessor_tpu_torch.ops import resample

    cases = (  # tag, rows, width, row bound; the first is the main shape
        ("U24", 8192, W, 10), ("U18", 8192, W, 7), ("U36", 8192, W, 16),
        ("U64", 2048, W, 30), ("rows 8189", 8189, W, 10),
        ("width 3072", 8192, BW, 10), ("width 1000", 8192, 1000, 10),
        ("width 1001", 8192, 1001, 10), ("U100", 1024, W, 48))
    shapes = []
    for tag, rows, width, rb in cases:
        u = 2 * rb + 4
        padded = torch.from_numpy(
            rng.random((rows + u - 1, width), dtype=np.float32)
            * 65535.0).to(dev)
        x = torch.arange(width, dtype=torch.float32, device=dev)
        g = (rb - 1.5) + 1.4 * torch.sin(x * (6.0 / width))
        check(set(torch.floor(g).int().unique().tolist())
              == {rb - 3, rb - 2, rb - 1}, f"row pass {tag}: G floors")
        cu = resample._row_pass_coeffs(g, rb)
        got = resample._fast_row_pass_cuda(padded, cu, rows)
        plain = resample._fast_row_pass_plain(padded, cu, rows)
        torch.cuda.synchronize()
        ulp = int((got.view(torch.int32) - plain.view(torch.int32))
                  .abs().max())
        check(ulp == 0, f"row_pass {tag} vs plain: {ulp} ulp")
        rec = dict(
            case=tag, shape=f"padded ({rows + u - 1}, {width}) f32, U {u} "
                            f"-> ({rows}, {width})",
            max_ulp=ulp,
            ms=time_ms(lambda: resample._fast_row_pass_cuda(padded, cu,
                                                            rows), 20),
            **row_pass_bound(rows, width, u))
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        if tag in ("U24", "U18", "U36"):
            # cuDNN's depthwise conv1d: out[c, y] = sum_v w[c, v] x[c, y + v]
            xt = padded.t().contiguous()[None]
            wt = cu.t().contiguous()[:, None, :]
            lib = F.conv1d(xt, wt, groups=width)[0].t()
            err = float((lib - plain).abs().max())
            scale = float(plain.abs().max())
            check(err <= 1e-5 * scale,
                  f"conv1d yardstick {tag}: max |d| {err} vs plain")
            rec.update(library_ms=time_ms(
                lambda: F.conv1d(xt, wt, groups=width), 10),
                library_max_abs_err=err)
            del xt, wt, lib
        if tag == "U24":
            rec["plain_ms"] = time_ms(
                lambda: resample._fast_row_pass_plain(padded, cu, rows), 3)
        say(f"[e] row_pass {json.dumps(rec)}")
        shapes.append(rec)
        del padded, got, plain
        torch.cuda.empty_cache()
    main = shapes[0]
    records["row_pass"] = dict(
        max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
        library_ms=main["library_ms"],
        library="torch.nn.functional.conv1d(groups=W), cuDNN's depthwise "
                "form of the same sum, on a channels-major copy",
        shape=main["shape"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"],
        shapes=[{k: r[k] for k in ("case", "ms", "bound_ms", "bound_share",
                                   "library_ms") if k in r}
                for r in shapes])
    say(f"[e] {json.dumps(records['row_pass'])}")


def f32(dev, *rows):
    import torch

    return torch.tensor(rows, dtype=torch.float32, device=dev)


# the dropped-tap cases of tests/test_torch_resample.py: a horizontal shift
# crossing col_halo mid-strip, and G beyond the row bound
PAST_COL_HALO = ([40.0, 5.0e-3], [1.2, 0.0, 0.0])
PAST_ROW_BOUND = ([-2.5, 0.0], [22.0, 0.0, 0.0])


def phase_remap(dev, rng, records):
    """Kernel (c) at 0 DN against its plain version at the three shapes the
    main paths give it, each timed beside its bound (uint16 in and out: 4
    bytes a pixel and band): the scene's 4 bands into the interleaved
    raster (rb 3, block 128 / halo 16), the prestitch of PAN2 (rb 4, 512 /
    32) and a band of the file align (rb 6, 512 / 32); also the dropped-tap
    coefficients and a row count that is no multiple of a row tile."""
    import torch

    from opticalimageprocessor_tpu_torch.ops import resample

    def held(tag, src, cx, cy, row_bound, block, halo):
        rb = row_bound
        if src.dim() == 3:
            got = resample._remap_bands_cuda(src, cx, cy, rb, block, halo)
            plain = resample._remap_bands_plain(src, cx, cy, rb, block, halo)
        else:
            got = resample._remap_band_cuda(src, cx, cy, rb, block, halo)
            plain = resample._remap_band_plain(src, cx, cy, rb, block, halo)
        torch.cuda.synchronize()
        dmax, share = dn_diff(got, plain)
        say(f"[c] {tag}: max {dmax} DN, {share:.4%} of pixels differ")
        check(dmax == 0, f"remap_band {tag} vs plain")
        return dmax

    # the scene: the 4 MSS bands of a 32768-line scene, the fitted shifts
    # of bench.py's synthesis (band b rolled by (b mod 2, b - 1) px)
    bands = torch.from_numpy(
        rng.integers(0, 65536, (4, 8192, BW), dtype=np.uint16)).to(dev)
    cx = f32(dev, *([4.0 * (b - 1) + 0.3, -2.1e-4] for b in range(4)))
    cy = f32(dev, *([4.0 * (b % 2) - 0.4, 6.5e-4, -3.0e-7]
                    for b in range(4)))
    kw = dict(row_bound=3, block=128, halo=16)
    worst = held("scene 4 x (8192, 3072) rb 3", bands, cx, cy, **kw)
    # the dropped-tap cases side by side, and 8115 rows (no tile multiple)
    cx_d = f32(dev, [3.7, -2.1e-4], PAST_COL_HALO[0], PAST_ROW_BOUND[0],
               [-60.0, -4.0e-3])
    cy_d = f32(dev, [-1.9, 6.5e-4, -3.0e-7], PAST_COL_HALO[1],
               PAST_ROW_BOUND[1], [-30.0, 1.0e-3, 0.0])
    worst = max(worst, held("dropped taps, scene shape", bands, cx_d, cy_d,
                            **kw))
    worst = max(worst, held("dropped taps, 8115 rows",
                            bands[:, :8115].contiguous(), cx_d, cy_d, **kw))
    rec = dict(
        ms=time_ms(lambda: resample._remap_bands_cuda(bands, cx, cy, **kw),
                   20),
        plain_ms=time_ms(
            lambda: resample._remap_bands_plain(bands, cx, cy, **kw), 5),
        library_ms=None,
        shape="4 x (8192, 3072) u16 -> (8192, 3072, 4), row_bound 3, "
              "block 128, halo 16",
        **bound(4 * bands.numel()),
    )
    # CMOS2's MSS (MssAlign): the same interleaved shape at row bound 6,
    # the fitted shifts of MSS2_ROLLS plus a prestitch residue in G
    cx2 = f32(dev, *([4.0 * (1 - b) + 0.2, 1.3e-4] for b in range(4)))
    cy2 = f32(dev, *([4.0 * ((b + 1) % 2) + 0.35, -4.1e-4, 2.0e-7]
                     for b in range(4)))
    kw = dict(row_bound=6, block=128, halo=16)
    worst = max(worst, held("mss2 4 x (8192, 3072) rb 6", bands, cx2, cy2,
                            **kw))
    worst = max(worst, held("dropped taps, rb 6", bands, cx_d, cy_d, **kw))
    rec.update(
        mss2_ms=time_ms(
            lambda: resample._remap_bands_cuda(bands, cx2, cy2, **kw), 20),
        **{f"mss2_{k}": v for k, v in bound(4 * bands.numel()).items()})
    del bands
    # the prestitch of PAN2: a constant (dx, dy) = (-3, 2.6) shift
    pan = torch.from_numpy(
        rng.integers(0, 65536, (16384, W), dtype=np.uint16)).to(dev)
    cx, cy = f32(dev, -12.0, 0.0), f32(dev, 10.4, 0.0, 0.0)
    kw = dict(row_bound=4, block=512, halo=32)
    worst = max(worst, held("prestitch (16384, 12288) rb 4", pan, cx, cy,
                            **kw))
    rec.update(
        prestitch_ms=time_ms(
            lambda: resample._remap_band_cuda(pan, cx, cy, **kw), 10),
        **{f"prestitch_{k}": v for k, v in bound(4 * pan.numel()).items()})
    del pan
    # a band of the file align, with the dropped-tap cases too
    band = torch.from_numpy(
        rng.integers(0, 65536, (4096, BW), dtype=np.uint16)).to(dev)
    kw = dict(row_bound=6, block=512, halo=32)
    cx, cy = f32(dev, 4.3, -2.1e-4), f32(dev, 3.6, 6.5e-4, -3.0e-7)
    worst = max(worst, held("align (4096, 3072) rb 6", band, cx, cy, **kw))
    # (the cases scaled to halo 32 and rb 6: the shift crosses 32 px near
    # x = 1100, G = 8.5)
    for tag, (cxd, cyd) in (("past_col_halo", ([40.0, 2.0e-2], [1.2, 0, 0])),
                            ("past_row_bound", ([-2.5, 0.0], [34.0, 0, 0]))):
        worst = max(worst, held(f"align {tag}", band[:4001].contiguous(),
                                f32(dev, *cxd), f32(dev, *cyd), **kw))
    rec.update(
        align_ms=time_ms(
            lambda: resample._remap_band_cuda(band, cx, cy, **kw), 20),
        **{f"align_{k}": v for k, v in bound(4 * band.numel()).items()})
    del band
    records["remap_band"] = dict(max_abs_err=float(worst), **rec)


# ---------------------------------------------------------------------------
# phase 3: the CLI on RAW files
# ---------------------------------------------------------------------------

def _write_csv(path, k, b):
    with open(path, "w") as f:
        f.write(f"1\n{k.shape[0]}\n0\n")
        for kk, bb in zip(k, b):
            f.write(f"{float(kk)!r} , {float(bb)!r}\n")


def _tiff_shape(path):
    """(width, height, samples) of a TIFF, through the port's host IO."""
    from opticalimageprocessor_tpu_torch.io import tiff

    info = tiff.read_tiff_info(str(path))
    return info.width, info.height, info.samples


def write_scene_files(torch, rng, lines, dev, tmp: Path, dy):
    """A synthetic scene with CMOS2's MSS as RAW files in ``tmp``, and
    random RRC CSVs: -> (files, RRC (k, b) by name, PAN1 on the host)."""
    pan1, pan2, mss, mss2 = synth_scene(torch, rng, lines, dev, dy=dy,
                                        mss2=True)
    files = {n: tmp / f"{n}.RAW" for n in ("PAN1", "PAN2", "MSS", "MSS2")}
    pan1_h = pan1.cpu().numpy()
    pan1_h.tofile(files["PAN1"])
    pan2.cpu().numpy().tofile(files["PAN2"])
    mss.cpu().numpy().transpose(1, 0, 2).tofile(files["MSS"])
    mss2.cpu().numpy().transpose(1, 0, 2).tofile(files["MSS2"])
    del pan1, pan2, mss, mss2
    csv = {"pan1": rand_params(rng, W), "pan2": rand_params(rng, W)}
    for b in range(1, 5):
        csv[f"msb{b}"] = rand_params(rng, BW)
    for b in range(1, 5):
        csv[f"m2b{b}"] = rand_params(rng, BW)
    for name, (k, b) in csv.items():
        _write_csv(tmp / f"{name}.csv", k, b)
    return files, csv, pan1_h


def scene_argv(files, tmp: Path, out: Path, dev, *extra):
    """``cli.main``'s argv of ``scene --mss2`` on :func:`write_scene_files`'
    files, writing into ``out``."""
    argv = ["scene", "--pan1", str(files["PAN1"]), "--pan2",
            str(files["PAN2"]), "--mss", str(files["MSS"]), "--mss2",
            str(files["MSS2"]), "-c", str(FOLD_COLS), "--out-dir", str(out),
            "-o", str(out / "STITCHED.RAW"), "--out-mss",
            str(out / "STITCHED_MSS.TIFF"), "--device", dev.type]
    for name in ("pan1", "pan2", *(f"msb{b}" for b in range(1, 5)),
                 *(f"m2b{b}" for b in range(1, 5))):
        argv += [f"--rrc-{name}", str(tmp / f"{name}.csv")]
    return argv + list(extra)


def run_cli(tag, argv, prefix, want_rc=0):
    """``cli.main(argv)`` with the launch counts set to 0 just before it and
    read just after: -> (launches, wall s, this run's log text).  Prints
    each stage() span of the run (seconds, MB/s)."""
    import torch

    from opticalimageprocessor_tpu_torch import _build, cli

    log = Path(os.environ["LOGFILE"])
    mark = log.stat().st_size if log.exists() else 0
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    say(f"[{prefix}] {tag}: rc {rc} in {secs:.3f} s; launches {launches}")
    check(rc == want_rc, f"{tag} exit code {rc}, want {want_rc}")
    text = log.read_bytes()[mark:].decode()
    for m in re.finditer(r"\] \[([^\]]+)\] (.*(?:MBps\)|seconds))\.$",
                         text, re.M):
        say(f"[{prefix}] {tag} stage {m.group(1)}: {m.group(2)}")
    return launches, secs, text


def fitted_shifts(text):
    """Every band fit's [0] coefficients (cx0, cy0) in a run's log, in
    order (CMOS1's 4 bands, then MSS2's)."""
    cx0 = [float(x) for x in re.findall(r"deltaX coeff: .*\[0\] (\S+)",
                                        text)]
    cy0 = [float(x) for x in re.findall(r"deltaY coeff: .*\[0\] (\S+)",
                                        text)]
    return cx0, cy0


def same_file(a: Path, b: Path, block: int = 1 << 26) -> bool:
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(block)
            if x != fb.read(block):
                return False
            if not x:
                return True


def phase_cli(dev, tmp: Path, lines: int = 16384):
    """``scene --mss2`` through ``cli.main`` on a 16384-line scene: the
    outputs' shapes, the recovered band shifts of both CMOS and the stt
    translation, the stitched left half against RRC(PAN1), the stitched
    MSS against the two ALIGNED.TIFFs, and the launches."""
    import torch

    from opticalimageprocessor_tpu_torch.io import tiff

    rng = np.random.default_rng(SEED + 1)
    files, csv, pan1_h = write_scene_files(torch, rng, lines, dev, tmp, dy=3)
    k1, b1 = csv["pan1"]
    launches, _, text = run_cli("scene --mss2", scene_argv(files, tmp, tmp,
                                                           dev), "cli")
    check(all(launches[k] > 0 for k in
              ("rrc", "crosspower", "remap_band", "stitch_tail"))
          and launches["row_pass"] == 0,
          f"the scene path's kernels (a)-(d) did not all launch: {launches}")
    check(launches["crosspower"] == 2 and launches["remap_band"] == 2,
          "the scene's 2 registrations and 2 x 4 band remaps took "
          f"{launches['crosspower']} kernel-(b) and {launches['remap_band']} "
          "kernel-(c) launches, not 2 and 2")

    shape = _tiff_shape(tmp / "MSS.ALIGNED.TIFF")
    check(shape == (BW, lines // 4, 4), f"aligned TIFF shape {shape}")
    shape = _tiff_shape(tmp / "MSS2.ALIGNED.TIFF")
    check(shape == (BW, lines // 4, 4), f"aligned2 TIFF shape {shape}")
    fh = max(1, FOLD_COLS // 8)
    shape = _tiff_shape(tmp / "STITCHED_MSS.TIFF")
    check(shape == (2 * (BW - fh), lines // 4, 4),
          f"stitched MSS TIFF shape {shape}")
    al1 = tiff.read_tiff(str(tmp / "MSS.ALIGNED.TIFF"))
    al2 = tiff.read_tiff(str(tmp / "MSS2.ALIGNED.TIFF"))
    check(np.array_equal(tiff.read_tiff(str(tmp / "STITCHED_MSS.TIFF")),
                         np.concatenate([al1[:, :BW - fh], al2[:, fh:]], 1)),
          "stitched MSS != the two ALIGNED.TIFFs cut at the MSS fold")
    del al1, al2
    say(f"[cli] stitched MSS == ALIGNED[:, :{BW - fh}] ++ ALIGNED2[:, {fh}:] "
        "byte for byte")
    out_w = 2 * (W - FOLD_COLS // 2)
    st = np.fromfile(tmp / "STITCHED.RAW", dtype="<u2")
    check(st.size == lines * out_w, f"stitched size {st.size}")
    st = st.reshape(lines, out_w)
    left = W - FOLD_COLS // 2
    for a in range(0, lines, 2048):
        check(np.array_equal(st[a:a + 2048, :left],
                             rrc_oracle(pan1_h[a:a + 2048, :left],
                                        k1[:left], b1[:left])),
              "stitched left half != RRC(PAN1)")
    say("[cli] stitched left half == RRC(PAN1) byte for byte")

    cx0, cy0 = fitted_shifts(text)
    stt = re.findall(r"everage value: dx: (\S+), dy: (\S+)", text)
    say(f"[cli] cx0 {cx0} cy0 {cy0} stt {stt}")
    check(len(cx0) == 8 and len(cy0) == 8 and len(stt) == 1, "log parse")
    for b in range(4):
        check(abs(cx0[b] - 4 * (b - 1)) < 0.3, f"band {b + 1} cx0 {cx0[b]}")
        check(abs(cy0[b] - 4 * (b % 2)) < 0.3, f"band {b + 1} cy0 {cy0[b]}")
    for b, (dr, dc) in enumerate(mss2_rolls()):
        own = dc - (FOLD_COLS - W) // 4
        check(abs(cx0[4 + b] - 4 * own) < 0.3,
              f"MSS2 band {b + 1} cx0 {cx0[4 + b]}")
        check(abs(cy0[4 + b] - 4 * dr) < 0.3,
              f"MSS2 band {b + 1} cy0 {cy0[4 + b]}")
    dx, dy = (float(v) for v in stt[0])
    check(abs(dx + 3) < 0.2 and abs(dy - 3) < 0.2, f"stt {dx}, {dy}")
    return launches


# ---------------------------------------------------------------------------
# phase 4: the resident pipeline at 32768 lines
# ---------------------------------------------------------------------------

def plain_transform(pipe, pan1, pan2, mss, cx, cy, raw_dx, raw_dy,
                    want_prestt=False):
    """ScenePipeline.transform through the kernels' plain versions: ->
    (aligned, stitched[, prestt])."""
    import torch

    from opticalimageprocessor_tpu_torch.ops import resample, rrc

    mss_c = rrc._rrc_plain(mss, pipe.mss_k, pipe.mss_b)
    aligned = torch.stack(
        [resample._remap_band_plain(
            mss_c[i], cx[i], cy[i], pipe.row_bound, pipe.col_block,
            pipe.col_halo).to(torch.int32) for i in range(4)], dim=-1)
    dxs, dys = pipe.clamp_stt(raw_dx, raw_dy)
    stitched = resample._stitch_tail_plain(
        pan1, pan2, pipe.pan1_k, pipe.pan1_b, pipe.pan2_k, pipe.pan2_b,
        float(np.float32(dxs)), float(np.float32(dys)), pipe.fold,
        pipe.col_block, pipe.col_halo, want_prestt)
    if want_prestt:
        return (aligned, *stitched)
    return aligned, stitched


def phase_pipeline(dev, power, lines: int = 32768):
    import torch

    from opticalimageprocessor_tpu_torch.models.device_pipeline import (
        ScenePipeline,
        check_registration_valid,
        check_stt_valid,
    )

    rng = np.random.default_rng(SEED + 2)
    pan1, pan2, mss = synth_scene(torch, rng, lines, dev)
    pipe = ScenePipeline(
        rand_params(rng, W), rand_params(rng, W), rand_params(rng, 4, BW),
        fold=FOLD_COLS // 2, overlap_cols=FOLD_COLS,
    ).to(dev)
    cx, cy, n_valid, raw_dx, raw_dy, n_stt = pipe.estimate(pan1, pan2, mss)
    check_registration_valid(n_valid.cpu())
    check_stt_valid(n_stt)
    say(f"[pipe] n_valid {n_valid.tolist()} n_stt {int(n_stt)} "
        f"cx0 {cx[:, 0].tolist()} cy0 {cy[:, 0].tolist()} "
        f"stt ({float(raw_dx):.5f}, {float(raw_dy):.5f})")
    aligned, stitched = pipe.transform(pan1, pan2, mss, cx, cy, raw_dx,
                                       raw_dy)
    al_p, st_p = plain_transform(pipe, pan1, pan2, mss, cx, cy, raw_dx,
                                 raw_dy)
    torch.cuda.synchronize()
    dmax, share = dn_diff(aligned, al_p)
    say(f"[pipe] aligned kernel vs plain: max {dmax} DN on {share:.4%}")
    check(dmax == 0, "aligned vs plain")
    left = W - pipe.fold
    check(bool((stitched[:, :left].to(torch.int32)
                == st_p[:, :left].to(torch.int32)).all()),
          "pipeline stitched left half not byte-exact")
    dmax, share = dn_diff(stitched[:, left:], st_p[:, left:])
    say(f"[pipe] stitched right half kernel vs plain: max {dmax} DN on "
        f"{share:.4%}")
    check(dmax == 0, "stitched vs plain")
    del al_p, st_p, aligned, stitched

    def step():
        out = pipe(pan1, pan2, mss)
        return int(out[0][0, 0, 0])           # forced readback

    def estimate():
        return int(pipe.estimate(pan1, pan2, mss)[2][0])

    est = pipe.estimate(pan1, pan2, mss)

    def transform():
        out = pipe.transform(pan1, pan2, mss, *est[:2], *est[3:5])
        return int(out[0][0, 0, 0])

    torch.cuda.reset_peak_memory_stats()
    step()
    ms = time_ms(step, 3)
    ms_est = time_ms(estimate, 3)
    ms_tr = time_ms(transform, 3)
    px = 2 * lines * W + 4 * (lines // 4) * BW
    res = dict(lines=lines, ms=ms, estimate_ms=ms_est, transform_ms=ms_tr,
               gpix_per_s=px / (ms * 1e-3) / 1e9, card=power,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    say(f"[pipe] {json.dumps(res)}")


# ---------------------------------------------------------------------------
# phase 5: the file workflow (prestitch, default align, stitch) on RAW files
# ---------------------------------------------------------------------------

def _spy_remaps(resample):
    """Record (cx, cy, row_bound) of every remap_band_fast_chunked call the
    file commands make (the models call it through the module); returns
    the record list and a function that restores the original."""
    calls = []
    real = resample.remap_band_fast_chunked

    def spy(src, coeff_x, coeff_y, row_bound=resample.ROW_OFF_BOUND_FAST,
            **kw):
        calls.append((np.asarray(coeff_x, np.float32).copy(),
                      np.asarray(coeff_y, np.float32).copy(), row_bound))
        return real(src, coeff_x, coeff_y, row_bound, **kw)

    resample.remap_band_fast_chunked = spy
    return calls, lambda: setattr(resample, "remap_band_fast_chunked", real)


def _plain_remap(resample, src, cx, cy, row_bound):
    """The plain PyTorch route of a remap_band_fast_chunked call: the
    column cubic, the U vertical multiply-adds over the whole zero-bordered
    strip, rint -- for either route the kernels take."""
    import torch

    dev = src.device
    block = resample.col_block_size(src.shape[1], None)
    return resample._remap_band_plain(
        src, torch.from_numpy(cx).to(dev), torch.from_numpy(cy).to(dev),
        row_bound, block, resample.COL_HALO)


def _raw(path, width=None):
    return np.fromfile(path, dtype="<u2").reshape(-1, width or W)


def files_scene(torch, dev, lines):
    """Phase 5's scene, which phase 8 frames into downlinks: PAN1, PAN2 3
    rows apart, CMOS1's MSS (4, lines / 4, BW), and the RRC (k, b) by
    CSV name."""
    rng = np.random.default_rng(SEED + 3)
    pan1, pan2, mss = synth_scene(torch, rng, lines, dev, dy=3)
    kb = {"pan1": rand_params(rng, W), "pan2": rand_params(rng, W)}
    for b in range(1, 5):
        kb[f"msb{b}"] = rand_params(rng, BW)
    return pan1, pan2, mss, kb


def sha256_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def phase_files(dev, tmp: Path, lines: int = 16384):
    """-> (launches over the commands, the SHA-256 of the outputs that
    phase 8 remakes from downlinks: PRESTT.RAW of the dy = 3 pair,
    ALIGNED.TIFF, the stitched RAW)."""
    import torch

    from opticalimageprocessor_tpu_torch import _build, cli
    from opticalimageprocessor_tpu_torch.io import tiff
    from opticalimageprocessor_tpu_torch.ops import resample

    pan1, pan2a, mss, kb = files_scene(torch, dev, lines)
    pan2b = torch.roll(pan1.to(torch.int32), (9, FOLD_COLS - 3 - W),
                       (0, 1)).to(torch.uint16)
    files = {n: tmp / f"{n}.RAW" for n in
             ("CMOS1.PAN", "CMOS2A.PAN", "CMOS2B.PAN", "CMOS1.MSS")}
    pan1_h = pan1.cpu().numpy()
    pan1_h.tofile(files["CMOS1.PAN"])
    pan2a.cpu().numpy().tofile(files["CMOS2A.PAN"])
    pan2b.cpu().numpy().tofile(files["CMOS2B.PAN"])
    mss_h = mss.cpu().numpy()
    mss_h.transpose(1, 0, 2).tofile(files["CMOS1.MSS"])
    del pan1, pan2a, pan2b, mss
    csv = {}
    for name, (k, b) in kb.items():
        csv[name] = str(tmp / f"{name}.csv")
        _write_csv(csv[name], k, b)

    log = Path(os.environ["LOGFILE"])
    launches, calls_by = {}, {}
    calls, restore = _spy_remaps(resample)

    def run(tag, argv):
        calls.clear()
        mark = log.stat().st_size if log.exists() else 0
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[tag] = dict(_build.LAUNCHES)
        calls_by[tag] = list(calls)
        say(f"[files] {tag}: rc {rc} in {secs:.3f} s; launches "
            f"{launches[tag]}")
        check(rc == 0, f"{tag} exit code {rc}")
        text = log.read_bytes()[mark:].decode()
        # each stage() span of this command: seconds and MB/s
        for m in re.finditer(r"\] \[([^\]]+)\] (.*(?:MBps\)|seconds))\.$",
                             text, re.M):
            say(f"[files] {tag} stage {m.group(1)}: {m.group(2)}")
        return text

    try:
        # 1. prestitch of two pairs: 3 rows apart (kernel (c)'s route) and
        #    9 rows apart (row bound 10-11: the staged route, kernel (e))
        for tag, pan2, dy in (("prestitch_dy3", "CMOS2A.PAN", 3),
                              ("prestitch_dy9", "CMOS2B.PAN", 9)):
            out = tmp / tag
            out.mkdir()
            text = run(tag, [
                "prestitch", "--fast", "--pan1", str(files["CMOS1.PAN"]),
                "--pan2", str(files[pan2]), "--rrc1", csv["pan1"],
                "--rrc2", csv["pan2"], "-s", "1", "-l", "16000",
                "--stitch-overlap", str(FOLD_COLS), "--out-dir", str(out),
                "--device", dev.type])
            got = re.findall(r"everage value: dx: (\S+), dy: (\S+), r:", text)
            check(len(got) == 1, f"{tag}: stt log parse")
            sdx, sdy = (float(v) for v in got[0])
            say(f"[files] {tag}: stt ({sdx}, {sdy})")
            check(abs(sdx + 3) < 0.05 and abs(sdy - dy) < 0.05,
                  f"{tag}: stt ({sdx}, {sdy}) vs (-3, {dy})")
            (cx, cy, rb), = calls_by[tag]
            staged = rb > resample.ROW_OFF_BOUND_FAST
            n = launches[tag]
            check(staged == (dy == 9), f"{tag}: row bound {rb}")
            check(n["rrc"] == 2 and n["crosspower"] == 0
                  and n["stitch_tail"] == 0, f"{tag}: launches {n}")
            check((n["row_pass"] > 0, n["remap_band"]) ==
                  ((True, 0) if staged else (False, 1)),
                  f"{tag}: route launches {n}")
            for src, par in (("CMOS1.PAN", "pan1"), (pan2, "pan2")):
                rrc_h = _raw(out / f"{src}.RRC.RAW")
                raw_h = _raw(files[src])
                for a in range(0, lines, 4096):
                    check(np.array_equal(
                        rrc_h[a:a + 4096],
                        rrc_oracle(raw_h[a:a + 4096], *kb[par])),
                        f"{tag}: {src}.RRC.RAW != numpy oracle")
            src = torch.from_numpy(rrc_h).to(dev)
            plain = _plain_remap(resample, src, cx, cy, rb).cpu().numpy()
            prestt = _raw(out / f"{pan2}.RRC.PRESTT.RAW")
            check(prestt.shape == (lines, W), f"{tag}: PRESTT shape")
            dmax = int(np.abs(prestt.astype(np.int32)
                              - plain.astype(np.int32)).max())
            say(f"[files] {tag}: row bound {rb}, RRC.RAW == oracle, "
                f"PRESTT vs plain route max {dmax} DN")
            check(dmax == 0, f"{tag}: PRESTT vs plain route")
            del src, plain, prestt
            torch.cuda.empty_cache()
            if dy == 9:                  # stitch takes the dy = 3 pair
                shutil.rmtree(out)
                files[pan2].unlink()

        # 2. registration + alignment (the default command)
        out = tmp / "align"
        out.mkdir()
        argv = ["--fast", "--pan", str(files["CMOS1.PAN"]), "--mss",
                str(files["CMOS1.MSS"]), "--do-rrc4pan", "--rrc-pan",
                csv["pan1"], "--slices", "10", "--ibc-sections", "1",
                "--out-dir", str(out), "--device", dev.type]
        for b in range(1, 5):
            argv += [f"--rrc-msb{b}", csv[f"msb{b}"]]
        run("align", argv)
        n = launches["align"]
        check(n["remap_band"] == 4 and n["rrc"] > 0 and n["row_pass"] == 0
              and n["crosspower"] == 0, f"align: launches {n}")
        check(len(calls_by["align"]) == 4, "align: 4 band remaps")
        xs = np.arange(0.0, W + 1, 64.0)
        worst = 0.0
        for b, (cx, cy, rb) in enumerate(calls_by["align"]):
            fx = cx[0] + cx[1] * xs
            fy = cy[0] + cy[1] * xs + cy[2] * xs * xs
            err = max(np.abs(fx - 4 * (b - 1)).max(),
                      np.abs(fy - 4 * (b % 2)).max())
            worst = max(worst, float(err))
            check(rb == resample.ROW_OFF_BOUND_FAST, f"align rb {rb}")
        # the rolls are whole band pixels (4 PAN px each); the fits are in
        # PAN px over the strip
        say(f"[files] align: fitted band rolls within {worst:.5f} PAN px "
            f"= {worst / 4:.5f} band px")
        check(worst / 4 < 0.01, f"align: band rolls off by {worst} PAN px")
        path = out / "CMOS1.MSS.ALIGNED.TIFF"
        rows = lines // 4 - 520      # --overlap-lines default trims 520
        check(_tiff_shape(path) == (BW, rows, 4),
              f"aligned TIFF shape {_tiff_shape(path)}")
        img = tiff.read_tiff(str(path))
        for b, (cx, cy, rb) in enumerate(calls_by["align"]):
            src = torch.from_numpy(
                rrc_oracle(mss_h[b], *kb[f"msb{b + 1}"])).to(dev)
            plain = _plain_remap(resample, src, cx, cy, rb)[520:].cpu()
            ch = [2, 1, 0, 3].index(b)       # cv::imwrite's BGRA order
            check(np.array_equal(img[..., ch], plain.numpy()),
                  f"align: TIFF channel {ch} != plain remap of band {b + 1}")
        say("[files] align: ALIGNED.TIFF channels [2,1,0,3] == plain route "
            "of bands 1-4 (0 DN)")
        del img

        # 3. stitch PAN1 with the dy = 3 pair's prestitched PAN2
        st_path = tmp / "STITCHED.RAW"
        run("stitch", ["stitch", "--image1", str(files["CMOS1.PAN"]),
                       "--image2", str(tmp / "prestitch_dy3"
                                       / "CMOS2A.PAN.RRC.PRESTT.RAW"),
                       "-o", str(st_path), "-c", str(FOLD_COLS)])
        half = W - FOLD_COLS // 2
        st = _raw(st_path, 2 * half)
        check(st.shape == (lines, 2 * half), f"stitched shape {st.shape}")
        check(np.array_equal(st[:, :half], pan1_h[:, :half]),
              "stitched left half != PAN1")
        check(all(v == 0 for v in launches["stitch"].values()),
              "stitch launched a kernel")
        say(f"[files] stitch: width {2 * half}, left half == PAN1 byte for "
            "byte")
        shas = {"prestt": sha256_file(tmp / "prestitch_dy3"
                                      / "CMOS2A.PAN.RRC.PRESTT.RAW"),
                "aligned": sha256_file(path), "stitched": sha256_file(st_path)}
        say(f"[files] SHA-256 {json.dumps(shas)}")
    finally:
        restore()
    check(launches["prestitch_dy3"]["row_pass"] == 0
          and launches["align"]["row_pass"] == 0,
          "kernel (e) launched outside the dy = 9 prestitch")
    return {k: sum(n[k] for n in launches.values())
            for k in _build.LAUNCHES}, shas


# ---------------------------------------------------------------------------
# phase 6: the streamed scene against the resident one
# ---------------------------------------------------------------------------

def _stream_writers(out: Path, lines):
    """Writers of a streamed transform's three outputs into ``out`` (the
    CLI's: aligned TIFF in BGRA order, stitched and prestt RAW)."""
    from opticalimageprocessor_tpu_torch.io import raw, tiff

    aligned = tiff.TiffStripWriter(str(out / "A.TIFF"), BW, lines // 4,
                                   samples=4)
    stitched = raw.RawStripWriter(str(out / "S.RAW"),
                                  2 * (W - FOLD_COLS // 2))
    prestt = raw.RawStripWriter(str(out / "P.RAW"), W)
    sinks = (lambda blk: aligned.write_rows(blk[:, :, [2, 1, 0, 3]]),
             stitched.write_lines, prestt.write_lines)
    return sinks, (aligned, stitched, prestt)


def _peak_gb(fn):
    """Run ``fn`` after resetting the peak: -> (its result, the peak device
    memory allocated during it in GB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 1e9


def _copy_class(name: str) -> str:
    low = name.lower()
    if "htod" in low:
        return "h2d"
    if "dtoh" in low:
        return "d2h"
    return "d2d" if "memcpy" in low else "kernels"


def phase_stream(dev, power, tmp: Path, lines: int = 34816,
                 section: int = 4096):
    """``scene --stream --mss2`` and the resident ``scene --mss2`` through
    ``cli.main`` on one 34816-line RAW scene (8 whole 4096-line sections
    and one of 2048): every output byte-identical, the streamed PRESTT.RAW
    equal to ScenePipeline(return_prestt=True)'s, the launches a section;
    then each route's estimate and transform called directly for their
    peak device memory (the streamed transform's below a quarter of the
    resident one's), and one streamed transform under torch.profiler:
    host->device and device->host copy ms, kernel ms, their union."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from opticalimageprocessor_tpu_torch.io.raw import RawStrip
    from opticalimageprocessor_tpu_torch.models import scene, scene_stream

    rng = np.random.default_rng(SEED + 4)
    files, _, pan1_h = write_scene_files(torch, rng, lines, dev, tmp, dy=3)
    del pan1_h
    n_secs = -(-lines // section)
    res = {"lines": lines, "section_lines": section, "sections": n_secs,
           "card": power}
    outs = {}
    for route, extra in (("stream", ["--stream", "--stream-section-lines",
                                     str(section)]), ("resident", [])):
        out = tmp / route
        out.mkdir()
        launches, secs, text = run_cli(
            route, scene_argv(files, tmp, out, dev, *extra), "stream")
        res[f"{route}_wall_s"] = secs
        res[f"{route}_launches"] = launches
        outs[route] = out
        # (c): one launch a section for each CMOS; (d): one a section
        want_c, want_d = ((2 * n_secs, n_secs) if route == "stream"
                          else (2, 1))
        check(launches["remap_band"] == want_c
              and launches["stitch_tail"] == want_d
              and launches["crosspower"] == 2 and launches["row_pass"] == 0
              and launches["rrc"] > 0,
              f"{route}: launches {launches}, want (c) {want_c}, (d) "
              f"{want_d}, (b) 2, (e) 0")
        check(len(fitted_shifts(text)[0]) == 8, f"{route}: log parse")
    for name in ("MSS.ALIGNED.TIFF", "STITCHED.RAW", "MSS2.ALIGNED.TIFF",
                 "STITCHED_MSS.TIFF"):
        check(same_file(outs["stream"] / name, outs["resident"] / name),
              f"streamed {name} != resident {name}")
    say("[stream] ALIGNED, stitched, ALIGNED2 and stitched MSS: streamed == "
        "resident byte for byte")
    shutil.rmtree(outs["resident"])

    # each route's phases called directly, with their peak device memory
    csv = lambda n: str(tmp / f"{n}.csv")  # noqa: E731
    pipe = scene.scene_pipeline(
        csv("pan1"), csv("pan2"), [csv(f"msb{b}") for b in range(1, 5)], W,
        10, None, FOLD_COLS, 10, 0.4, 0.4, 0.0, return_prestt=True).to(dev)
    strips = [RawStrip(str(files[n]), W) for n in ("PAN1", "PAN2", "MSS")]
    # the streamed estimate first, while no strip is on the card
    est_s, res["stream_estimate_peak_gb"] = _peak_gb(
        lambda: scene_stream.estimate_streamed(pipe, *strips, dev))
    torch.cuda.empty_cache()
    pan1, pan2 = (torch.from_numpy(np.array(s._mm)).to(dev)
                  for s in strips[:2])
    mss = scene.load_bands(strips[2], dev)
    est, res["resident_estimate_peak_gb"] = _peak_gb(
        lambda: pipe.estimate(pan1, pan2, mss))
    check(all(torch.equal(a, b) for a, b in zip(est, est_s)),
          "estimate_streamed != ScenePipeline.estimate")
    say("[stream] estimate_streamed == ScenePipeline.estimate bit for bit")
    params = (*est[:2], *est[3:5])
    outs_r, res["resident_transform_peak_gb"] = _peak_gb(
        lambda: pipe.transform(pan1, pan2, mss, *params))
    prestt = outs_r[2]
    del pan1, pan2, mss, outs_r
    got = np.memmap(outs["stream"] / "PAN2.PRESTT.RAW", dtype="<u2",
                    mode="r").reshape(lines, W)
    for a in range(0, lines, 4096):
        check(np.array_equal(got[a:a + 4096], prestt[a:a + 4096].cpu().numpy()),
              "streamed PRESTT.RAW != ScenePipeline's prestitched PAN2")
    del got, prestt
    torch.cuda.empty_cache()
    say("[stream] PRESTT.RAW == ScenePipeline(return_prestt=True)'s prestt")
    # phase 9 runs the same scene with --mesh 1 against these
    shas = {name: sha256_file(outs["stream"] / name)
            for name in SCENE_OUTPUTS + ("PAN2.PRESTT.RAW",)}
    shutil.rmtree(outs["stream"])

    def streamed(out):
        out.mkdir()
        sinks, writers = _stream_writers(out, lines)
        t0 = time.perf_counter()
        scene_stream.transform_streamed(pipe, *strips, *params, *sinks,
                                        section_rows=section, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for w in writers:
            w.close()
        shutil.rmtree(out)
        return wall

    res["stream_transform_wall_s"], res["stream_transform_peak_gb"] = \
        _peak_gb(lambda: streamed(tmp / "direct"))
    say("[stream] peak device memory (GB): " + json.dumps(
        {k: v for k, v in res.items() if k.endswith("peak_gb")}))
    check(res["stream_transform_peak_gb"]
          < res["resident_transform_peak_gb"] / 4,
          "the streamed transform's peak device memory is not below a "
          "quarter of the resident transform's")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = streamed(tmp / "profiled")
    with tempfile.TemporaryDirectory(prefix="oip_prof_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev_ev = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e]
    check(bool(dev_ev), "the profiler recorded no device time")
    spans: dict[str, list] = {}
    for e in dev_ev:
        spans.setdefault(_copy_class(e["name"]), []).append(
            (e["ts"], e["ts"] + e["dur"]))
    prof_res = {f"{k}_ms": _union_ms(v) for k, v in sorted(spans.items())}
    prof_res.update(
        profiled_wall_ms=wall * 1e3,
        union_ms=_union_ms(iv for v in spans.values() for iv in v),
        summed_ms=sum(e["dur"] for e in dev_ev) / 1e3,
        copies_union_ms=_union_ms(spans.get("h2d", []) + spans.get("d2h",
                                                                    [])))
    res["profile"] = prof_res
    say(f"[stream] {json.dumps(res)}")
    launches = {k: res["stream_launches"][k] + res["resident_launches"][k]
                for k in res["stream_launches"]}
    return launches, shas


# ---------------------------------------------------------------------------
# phase 7: the parity route (prestitch and the default align without --fast)
# ---------------------------------------------------------------------------

def _cubic_weights_np(x):
    """OpenCV ``interpolateCubic`` (A = -0.75) in float32, reference
    expression order (copied from
    ``opticalimageprocessor_tpu/ops/cv_exact.py::interpolate_cubic_f32``)."""
    x = np.asarray(x, dtype=np.float32)
    A = np.float32(-0.75)
    f1, f5, f8, f4 = (np.float32(v) for v in (1.0, 5.0, 8.0, 4.0))
    f2, f3 = np.float32(2.0), np.float32(3.0)
    xp1 = x + f1
    c0 = ((A * xp1 - f5 * A) * xp1 + f8 * A) * xp1 - f4 * A
    c1 = ((A + f2) * x - (A + f3)) * x * x + f1
    omx = f1 - x
    c2 = ((A + f2) * omx - (A + f3)) * omx * omx + f1
    c3 = f1 - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1)


def remap_oracle(src, mapx, mapy, quantized):
    """``cv::remap(src16U, mapx32F, mapy32F, INTER_CUBIC, BORDER_CONSTANT,
    0)`` in numpy: quantized (OpenCV <= 4.x) or continuous (5.x)
    coordinates, ``W[a, b] = f32(wy[a] * wx[b])``, each tap row summed
    left to right and the rows in order, rint half to even and clamp; a
    pixel whose whole support is outside is 0.  Copied from
    ``opticalimageprocessor_tpu/ops/cv_exact.py:103-206``
    (``remap_cubic_u16_exact`` with its map conversions and
    ``_remap_interior_order``)."""
    src = np.asarray(src, dtype=np.uint16)
    h, w = src.shape
    mapx = np.asarray(mapx, np.float32)
    mapy = np.asarray(mapy, np.float32)
    if quantized:
        sx = np.rint(mapx * np.float32(32)).astype(np.int32)
        sy = np.rint(mapy * np.float32(32)).astype(np.int32)
        ix = np.clip(sx >> 5, -32768, 32767).astype(np.int32)
        iy = np.clip(sy >> 5, -32768, 32767).astype(np.int32)
        tab = _cubic_weights_np(np.arange(32, dtype=np.float32)
                                * np.float32(1.0 / 32))
        wx, wy = tab[sx & 31], tab[sy & 31]
    else:
        ix = np.floor(mapx).astype(np.int32)
        iy = np.floor(mapy).astype(np.int32)
        wx = _cubic_weights_np((mapx - ix).astype(np.float32))
        wy = _cubic_weights_np((mapy - iy).astype(np.float32))
    sx0, sy0 = ix - 1, iy - 1
    padded = np.zeros((h + 8, w + 8), dtype=np.float32)
    padded[4:4 + h, 4:4 + w] = src.astype(np.float32)
    py = np.clip(sy0 + 4, 0, h + 4)
    px = np.clip(sx0 + 4, 0, w + 4)
    outside = (sx0 >= w) | (sx0 + 4 <= 0) | (sy0 >= h) | (sy0 + 4 <= 0)
    acc = np.zeros(px.shape, dtype=np.float32)
    for a in range(4):
        ya = py + a
        wa = wy[..., a]
        t = padded[ya, px] * (wa * wx[..., 0])
        t = t + padded[ya, px + 1] * (wa * wx[..., 1])
        t = t + padded[ya, px + 2] * (wa * wx[..., 2])
        t = t + padded[ya, px + 3] * (wa * wx[..., 3])
        acc = acc + t
    out = np.clip(np.rint(acc).astype(np.int32), 0, 65535).astype(np.uint16)
    out[outside] = 0
    return out


def poly_cols(cx, cy, width):
    """The reference's alignment maps (preproc.h:443-450) in double: ->
    (mapx of each column, G(x)) with mapx = (cX1*xx + cX0 + xx)/4, G =
    (cY2*xx^2 + cY1*xx + cY0)/4, xx = 4x."""
    xx = np.arange(width, dtype=np.float64) * 4.0
    return ((float(cx[1]) * xx + float(cx[0]) + xx) / 4.0,
            (float(cy[2]) * xx * xx + float(cy[1]) * xx + float(cy[0]))
            / 4.0)


def shift_cols(dx, dy, width):
    """The prestitch maps (stitcher.h:93-99) in double: mapx = x + dx,
    G = dy."""
    return (np.arange(width, dtype=np.float64) + float(dx),
            np.full(width, float(dy)))


def maps_for_rows(mapx_cols, g, y0, y1):
    """The float32 maps of a section's rows [y0, y1): mapx per column,
    mapy = float32(y + G(x)) with y the row's index in the section."""
    return (np.tile(mapx_cols.astype(np.float32), (y1 - y0, 1)),
            (np.arange(y0, y1, dtype=np.float64)[:, None] + g).astype(
                np.float32))


def oracle_rows(rows, origin, l0, l1, mapx_cols, g, quantized):
    """Rows [l0, l1) of the oracle's remap of a section, given only its
    rows [origin, origin + len(rows)): each mapy less ``origin`` (exact in
    float32) addresses the slice.  The slice must reach the section's edge
    or beyond the taps of [l0, l1) on both sides."""
    mapx, mapy = maps_for_rows(mapx_cols, g, origin, origin + len(rows))
    out = remap_oracle(rows, mapx, mapy - np.float32(origin), quantized)
    return out[l0 - origin:l1 - origin]


# a fitted-size band polynomial (~1 band px of shift, slope and curvature
# of real fits) and the constant-shift gate's translation
PARITY_POLY = ((4.3, -2.1e-5), (3.6, 6.5e-5, -3.0e-9))
PARITY_SHIFT = (-3.3, 3.4)


def parity_function_gate(dev, rng, res):
    """``remap_section_u16`` on the card at 0 DN against the numpy oracle
    in both coordinate modes, on a 2048 x 3072 band section and a 1024 x
    12288 constant-shift section; then its ms a section (CUDA events) at
    30000 x 12288 and at a 20000 x 3072 band section beside its bound
    (uint16 in and out at the memory rate), and the peak device memory of
    one 30000 x 12288 section."""
    import torch

    from opticalimageprocessor_tpu_torch.ops import resample

    def plan(kind, width, quantized):
        if kind == "band":
            return resample.plan_for_band_alignment(*PARITY_POLY, width,
                                                    quantized)
        return resample.plan_for_constant_shift(*PARITY_SHIFT, width,
                                                quantized)

    for kind, rows, width in (("band", 2048, BW), ("shift", 1024, W)):
        src = rng.integers(0, 65536, (rows, width), dtype=np.uint16)
        cols = (poly_cols(*PARITY_POLY, width) if kind == "band"
                else shift_cols(*PARITY_SHIFT, width))
        dsrc = torch.from_numpy(src).to(dev)
        for quantized in (False, True):
            mode = "quantized" if quantized else "continuous"
            got = resample.remap_section_u16(
                dsrc, plan(kind, width, quantized)).cpu().numpy()
            want = remap_oracle(src, *maps_for_rows(*cols, 0, rows),
                                quantized)
            dmax = int(np.abs(got.astype(np.int32)
                              - want.astype(np.int32)).max())
            say(f"[parity] remap_section_u16 {kind} ({rows}, {width}) "
                f"{mode}: max {dmax} DN against the oracle")
            check(dmax == 0, f"remap_section_u16 {kind} {mode} vs oracle: "
                             f"{dmax} DN")
            res[f"oracle_{kind}_{mode}_max_dn"] = dmax
        del dsrc

    for tag, rows, width, kind in (("section", 30000, W, "shift"),
                                   ("band_section", 20000, BW, "band")):
        sec = torch.from_numpy(
            rng.integers(0, 65536, (rows, width), dtype=np.uint16)).to(dev)
        p = plan(kind, width, False)
        if tag == "section":
            # the section itself (0.74 GB) is on the card before the call
            _, res["section_peak_gb"] = _peak_gb(
                lambda: resample.remap_section_u16(sec, p))
        res[f"{tag}_ms"] = time_ms(lambda: resample.remap_section_u16(sec, p),
                                   2)
        res[f"{tag}_bound_ms"] = bound(4 * sec.numel())["bound_ms"]
        res[f"{tag}_shape"] = f"({rows}, {width}) u16, {kind}"
        del sec
        torch.cuda.empty_cache()
    say("[parity] remap_section_u16: " + json.dumps(
        {k: v for k, v in res.items() if not k.startswith("oracle")}))


def sectionary_remap(lines, dy, section_rows=30000):
    """SectionaryRemap's bookkeeping (imageop.h:230-275): -> (ucut, bcut,
    [(offset, rows) of each section], its returned row offset)."""
    ucut = 0 if dy >= 0 else int(-dy) + 1
    bcut = int(dy) + 1 if dy >= 0 else 0
    off, sections = 0, []
    while True:
        rows = min(section_rows, lines - off)
        if rows <= ucut + bcut:
            break
        sections.append((off, rows))
        off += rows - ucut - bcut
    return ucut, bcut, sections, off


def check_prestitch_oracle(path, raw, k, b, dx, dy, quantized, lines,
                           win=64, halo=16, section_rows=30000):
    """The PRESTT.RAW at 0 DN against the oracle on windows of ``win``
    rows: the top and bottom of each section's kept rows (the seams
    between them) and the bottom cut.  Where the strip has 2 or more
    sections the bottom cut comes from the reference's rolling buffer,
    whose rows past the final section's fresh read hold the previous
    section's: its last ``2 * bcut + 8`` rows are rebuilt and remapped as
    a section of their own (local y from 0, the JAX package's window,
    models/stitcher.py:298-317).  The oracle reads RRC(``raw``) through the
    numpy RRC.  -> (max DN, lines written, [(offset, rows)] of the
    sections)."""
    ucut, bcut, sections, offset = sectionary_remap(lines, dy, section_rows)
    got = np.memmap(path, dtype="<u2", mode="r")
    written = offset + ucut + bcut
    check(got.size == written * W,
          f"{path.name}: {got.size // W} lines, SectionaryRemap's {written}")
    got = got.reshape(written, W)
    cols = shift_cols(dx, dy, W)
    worst = 0

    def held(f0, want):
        nonlocal worst
        d = int(np.abs(got[f0:f0 + len(want)].astype(np.int32)
                       - want.astype(np.int32)).max())
        worst = max(worst, d)

    for i, (o, rows) in enumerate(sections):
        lo = 0 if i == 0 else ucut       # the section's kept local rows
        hi = rows - bcut
        for l0 in (lo, hi - win):
            a, e = max(0, l0 - halo), min(rows, l0 + win + halo)
            held(o + l0, oracle_rows(rrc_oracle(raw[o + a:o + e], k, b), a,
                                     l0, l0 + win, *cols, quantized))
    if bcut and len(sections) > 1:
        (o_prev, _), (o_last, rows_last) = sections[-2:]
        j = np.arange(max(0, section_rows - 2 * bcut - 8), section_rows)
        src = np.where((j < rows_last)[:, None],
                       raw[np.minimum(o_last + j, lines - 1)],
                       raw[np.minimum(o_prev + j, lines - 1)])
        n = len(j)
        held(written - bcut, oracle_rows(rrc_oracle(src, k, b), 0, n - bcut,
                                         n, *cols, quantized))
    elif bcut:                   # one section: its fresh tail
        o, rows = sections[0]
        a = max(0, rows - bcut - halo)
        held(written - bcut, oracle_rows(rrc_oracle(raw[o + a:o + rows], k,
                                                    b), a, rows - bcut, rows,
                                         *cols, quantized))
    return worst, written, sections


def check_align_oracle(img, raw_mss, kb, fits, sec_lines, overlap,
                       quantized, win=64, halo=16, min_lines=1500):
    """The ALIGNED.TIFF (channels [2, 1, 0, 3]) at 0 DN against the oracle
    on windows of ``win`` rows at the top and bottom of each section's
    kept rows, for every band: the oracle reads RRC(band) through the
    numpy RRC, with the band's fitted polynomials ``fits``."""
    lines = raw_mss.shape[0]
    worst, out0, off = 0, 0, 0
    while True:
        n = min(lines - off, sec_lines)
        if n < min_lines:
            break
        for l0 in (overlap, n - win):
            a, e = max(0, l0 - halo), min(n, l0 + win + halo)
            for band in range(4):
                want = oracle_rows(
                    rrc_oracle(raw_mss[off + a:off + e, band], *kb[band]), a,
                    l0, l0 + win, *poly_cols(*fits[band], BW), quantized)
                got = img[out0 + l0 - overlap:out0 + l0 - overlap + win, :,
                          [2, 1, 0, 3].index(band)]
                worst = max(worst, int(np.abs(got.astype(np.int32)
                                              - want.astype(np.int32)).max()))
        out0 += n - overlap
        off += sec_lines - overlap
    return worst


def interior_diff(a, b, keep_rows, block=4096):
    """|a - b| over the rows ``keep_rows`` selects, 8 edge columns left
    out (the JAX package's fast-vs-parity test,
    tests/test_pipeline_e2e.py:434-469): -> (max DN, share > 1 DN)."""
    dmax, over, n = 0, 0, 0
    for r in range(0, a.shape[0], block):
        k = keep_rows[r:r + block]
        d = np.abs(a[r:r + block, 8:-8].astype(np.int32)
                   - b[r:r + block, 8:-8].astype(np.int32))[k]
        if d.size:
            dmax = max(dmax, int(d.max()))
            over += int((d > 1).sum())
            n += d.size
    return dmax, over / n


# float32(y + G) is within 2^-16 px of y + G for section rows y < 1024:
# the rows where the JAX package's fast-vs-parity envelope is defined (its
# test remaps 600 rows); at y ~ 30000 the map keeps 2^-9 px and the parity
# route drifts from the fast route by up to ~30 DN on noise.  Of that
# envelope only its share (> 1 DN on < 1% of pixels) is gated: at the
# camera's 3072-px bands the fast route's own float32 mapx (xx up to 12288)
# is 1.2e-4 px off, which moves rare pixels of band-resolution noise by up
# to ~8 DN
ENVELOPE_ROWS = 1024


def row_mask(rows, spans, cut=()):
    """The output rows in the ``spans`` [(first, end)], less ``cut``'s."""
    keep = np.zeros(rows, bool)
    for a, e in spans:
        keep[a:e] = True
    for a, e in cut:
        keep[a:e] = False
    return keep


def _spy(module, name, calls):
    """Record the positional arguments of every ``module.name`` call;
    returns a function that restores the original."""
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    setattr(module, name, spy)
    return lambda: setattr(module, name, real)


def phase_parity(dev, power, tmp: Path, lines: int = 40960):
    """The parity route on the card: the function gate, then through
    ``cli.main`` on a 40960-line scene of RAW files (bench.py's synthesis,
    PAN2 3 rows below PAN1): ``prestitch`` in each ``--coord-mode`` and
    ``--fast`` (two 30000-row sections and the rolling-buffer bottom cut),
    and the default action in each mode and ``--fast`` (10240 MSS lines in
    two sections of 5200 overlapping by 100).  Each parity output: its
    line count SectionaryRemap's, 0 DN against the oracle on windows at
    every section's edges and the bottom cut, > 1 DN from the ``--fast``
    output on < 1% of the first 1024 rows of each section (continuous
    mode; see ENVELOPE_ROWS), and the two modes differ."""
    import torch

    from opticalimageprocessor_tpu_torch.io import tiff
    from opticalimageprocessor_tpu_torch.ops import resample

    rng = np.random.default_rng(SEED + 5)
    res = {"lines": lines, "card": power}
    parity_function_gate(dev, rng, res)

    pan1, pan2, mss = synth_scene(torch, rng, lines, dev, dy=3)
    files = {n: tmp / f"{n}.RAW" for n in ("CMOS1.PAN", "CMOS2.PAN",
                                           "CMOS1.MSS")}
    pan1.cpu().numpy().tofile(files["CMOS1.PAN"])
    pan2.cpu().numpy().tofile(files["CMOS2.PAN"])
    mss.cpu().numpy().transpose(1, 0, 2).tofile(files["CMOS1.MSS"])
    del pan1, pan2, mss
    torch.cuda.empty_cache()
    kb, csv = {}, {}
    for name, n in (("pan1", W), ("pan2", W),
                    *((f"msb{b}", BW) for b in range(1, 5))):
        kb[name] = rand_params(rng, n)
        csv[name] = str(tmp / f"{name}.csv")
        _write_csv(csv[name], *kb[name])

    launches, plans = {}, []
    modes = (("continuous", []), ("fast", ["--fast"]),
             ("quantized", ["--coord-mode", "quantized"]))

    def run(tag, argv):
        plans.clear()
        launches[tag], res[f"{tag}_wall_s"], text = run_cli(tag, argv,
                                                            "parity")
        n = launches[tag]
        fast = "--fast" in argv
        check(n["rrc"] > 0 and n["crosspower"] == 0 and n["stitch_tail"] == 0
              and n["row_pass"] == 0 and (n["remap_band"] > 0) == fast,
              f"{tag}: launches {n}")
        check(bool(plans) != fast, f"{tag}: {len(plans)} parity plans")
        return text

    restore = [_spy(resample, "plan_for_constant_shift", plans),
               _spy(resample, "plan_for_band_alignment", plans)]
    try:
        # 1. prestitch: continuous, --fast, quantized on the same pair
        base = ["prestitch", "--pan1", str(files["CMOS1.PAN"]), "--pan2",
                str(files["CMOS2.PAN"]), "--rrc1", csv["pan1"], "--rrc2",
                csv["pan2"], "-s", "1", "-l", "16000", "--stitch-overlap",
                str(FOLD_COLS), "--device", dev.type]
        raw2 = np.memmap(files["CMOS2.PAN"], dtype="<u2",
                         mode="r").reshape(lines, W)
        prestt, shifts = {}, {}
        for mode, extra in modes:
            tag = f"prestitch_{mode}"
            out = tmp / tag
            out.mkdir()
            run(tag, base + extra + ["--out-dir", str(out)])
            for n in ("CMOS1.PAN", "CMOS2.PAN"):
                (out / f"{n}.RRC.RAW").unlink()
            prestt[mode] = out / "CMOS2.PAN.RRC.PRESTT.RAW"
            if mode == "fast":
                continue
            (dx, dy, width, quantized), = plans
            check(width == W and quantized == (mode == "quantized"),
                  f"{tag}: plan {plans}")
            shifts[mode] = (dx, dy)
            worst, written, sections = check_prestitch_oracle(
                prestt[mode], raw2, *kb["pan2"], dx, dy, quantized, lines)
            say(f"[parity] {tag}: stt ({dx!r}, {dy!r}), {len(sections)} "
                f"sections {sections}, {written} lines written; windows vs "
                f"the oracle max {worst} DN")
            check(worst == 0, f"{tag}: {worst} DN against the oracle")
            check(len(sections) == 2 and int(dy) + 1 > 0,
                  f"{tag}: want 2 sections and a bottom cut")
            res[f"{tag}_oracle_max_dn"] = worst
        check(len(set(shifts.values())) == 1,
              f"prestitch: the stt differs between runs: {shifts}")
        # (phase 5 holds the stt to 0.05 px; here it sets the cuts)
        check(abs(dx + 3) < 0.1 and 3 <= dy < 3.1, f"stt ({dx}, {dy})")
        pre = {m: np.memmap(p, dtype="<u2", mode="r").reshape(-1, W)
               for m, p in prestt.items()}
        check(pre["fast"].shape == pre["continuous"].shape,
              f"prestitch --fast: {pre['fast'].shape[0]} lines")
        # section rows [8, ENVELOPE_ROWS) of each section; every row 8 or
        # more from the strip's ends, the seam and the bottom cut
        keep = row_mask(written, [(o + 8, o + ENVELOPE_ROWS)
                                  for o, _ in sections])
        seam = sections[1][0]
        away = row_mask(written, [(8, written - int(dy) - 1 - 8)],
                        [(seam - 8, seam + 8)])
        for mode in ("continuous", "quantized"):
            d_env = interior_diff(pre[mode], pre["fast"], keep)
            d_all = interior_diff(pre[mode], pre["fast"], away)
            say(f"[parity] prestitch {mode} vs --fast: first "
                f"{ENVELOPE_ROWS} rows of each section max {d_env[0]} DN, "
                f"{d_env[1]:.5%} > 1 DN; every row away from the seams max "
                f"{d_all[0]} DN, {d_all[1]:.5%} > 1 DN")
            res[f"prestitch_{mode}_vs_fast"] = dict(envelope=d_env,
                                                    away_from_seams=d_all)
        d = res["prestitch_continuous_vs_fast"]["envelope"]
        check(d[1] < 0.01,
              "prestitch continuous vs --fast: > 1 DN on 1% or more")
        check(not same_file(prestt["continuous"], prestt["quantized"]),
              "prestitch: the two coordinate modes wrote the same PRESTT")
        del pre, raw2
        for p in prestt.values():
            shutil.rmtree(p.parent)

        # 2. the default action: continuous, --fast, quantized
        sec_lines, overlap = 5200, 100
        base = ["--pan", str(files["CMOS1.PAN"]), "--mss",
                str(files["CMOS1.MSS"]), "--do-rrc4pan", "--rrc-pan",
                csv["pan1"], "--slices", "10", "--ibc-sections", "1",
                "--lines-section", str(sec_lines), "--overlap-lines",
                str(overlap), "--device", dev.type]
        for b in range(1, 5):
            base += [f"--rrc-msb{b}", csv[f"msb{b}"]]
        raw_mss = np.memmap(files["CMOS1.MSS"], dtype="<u2",
                            mode="r").reshape(lines // 4, 4, BW)
        band_kb = [kb[f"msb{b}"] for b in range(1, 5)]
        aligned, fits = {}, {}
        for mode, extra in modes:
            tag = f"align_{mode}"
            out = tmp / tag
            out.mkdir()
            run(tag, base + extra + ["--out-dir", str(out)])
            aligned[mode] = tiff.read_tiff(
                str(out / "CMOS1.MSS.ALIGNED.TIFF"))
            shutil.rmtree(out)
            if mode == "fast":
                continue
            check(len(plans) == 4 and all(
                p[2] == BW and p[3] == (mode == "quantized") for p in plans),
                f"{tag}: plans {len(plans)}")
            fits[mode] = [(np.asarray(p[0]).tolist(),
                           np.asarray(p[1]).tolist()) for p in plans]
            worst = check_align_oracle(aligned[mode], raw_mss, band_kb,
                                       fits[mode], sec_lines, overlap,
                                       mode == "quantized")
            say(f"[parity] {tag}: windows of both sections, 4 bands, vs the "
                f"oracle max {worst} DN")
            check(worst == 0, f"{tag}: {worst} DN against the oracle")
            res[f"{tag}_oracle_max_dn"] = worst
        check(fits["continuous"] == fits["quantized"],
              "align: the fits differ between runs")
        rows = lines // 4 - overlap
        for m, a in aligned.items():
            check(a.shape == (rows, BW, 4), f"align {m}: shape {a.shape}")
        # section k's kept rows start at output row k * (sec_lines -
        # overlap), its section row `overlap`
        seam = sec_lines - overlap
        keep = row_mask(rows, [(0, ENVELOPE_ROWS - overlap),
                               (seam, seam + ENVELOPE_ROWS - overlap)])
        away = row_mask(rows, [(8, rows - 8)], [(seam - 8, seam + 8)])
        for mode in ("continuous", "quantized"):
            d_env = interior_diff(aligned[mode], aligned["fast"], keep)
            d_all = interior_diff(aligned[mode], aligned["fast"], away)
            say(f"[parity] align {mode} vs --fast: section rows < "
                f"{ENVELOPE_ROWS} max {d_env[0]} DN, {d_env[1]:.5%} > 1 DN; "
                f"every row away from the seam max {d_all[0]} DN, "
                f"{d_all[1]:.5%} > 1 DN")
            res[f"align_{mode}_vs_fast"] = dict(envelope=d_env,
                                                away_from_seams=d_all)
        d = res["align_continuous_vs_fast"]["envelope"]
        check(d[1] < 0.01, "align continuous vs --fast: > 1 DN on 1% or more")
        check(not np.array_equal(aligned["continuous"], aligned["quantized"]),
              "align: the two coordinate modes wrote the same ALIGNED.TIFF")
        del aligned, raw_mss
    finally:
        for r in restore:
            r()
    res["launches"] = launches
    say(f"[parity] {json.dumps(res)}")
    return {k: sum(n[k] for n in launches.values())
            for k in next(iter(launches.values()))}


# ---------------------------------------------------------------------------
# phase 8: docs/sample-task.sh from the raw downlink (auxsep, then phase 5's
# file commands on the separated files)
# ---------------------------------------------------------------------------

DOWNLINK = "KASHI_TJ3-01_20220817_031259_{}.dat"      # {}: the CMOS
SEPARATED = "KASHI_TJ3-01_CMOS-{}_20220817_031259"     # auxsep's stem


def _be_bytes(values: np.ndarray, width: int) -> np.ndarray:
    """(n,) unsigned integers -> (n, width) big-endian bytes."""
    shifts = np.arange(8 * (width - 1), -1, -8, dtype=np.uint32)
    return ((values.astype(np.uint32)[:, None] >> shifts) & 0xFF).astype(
        np.uint8)


def _framed(payload: np.ndarray, n: int, width: int, out: np.ndarray):
    """Copy a byte stream into ``out`` (n rows, ``width`` payload bytes
    each, a strided view), zero-padding the last row."""
    full = payload.size // width
    out[:full] = payload[:full * width].reshape(full, width)
    if n > full:
        out[full, :payload.size - full * width] = payload[full * width:]


def frame_downlink(imdt: np.ndarray, chid: int, rng):
    """An IMDT byte stream (uint8) framed for the downlink, vectorised:
    ``formats/aos``'s build_imtr_stream and build_aos_stream with the
    native CRC (the per-frame builders are too slow at this size).

    Returns (the stream's pieces in order, the counts auxsep must report:
    valid, empty, invalid AOS frames).  Leading junk, then the AOS frames
    with an extra frame after every tenth of them, which must add or lose
    nothing: in turn an empty frame (VCID 0x3F, injection 0xAAAAAAAA), a
    valid frame flagged invalid after its CRC was computed (injection
    0xAAAAAAAA), and a CRC-corrupted duplicate of the frame before."""
    from opticalimageprocessor_tpu_torch.formats import aos
    from opticalimageprocessor_tpu_torch.utils import native

    n = -(-imdt.size // aos.IMTR_IMGDATA_BYTES)
    imtr = np.zeros((n, aos.IMTR_FRAME_BYTES), np.uint8)
    imtr[:, :4] = np.frombuffer(aos.IMTR_SIG, np.uint8)
    imtr[:, aos.IMTR_SEQ_OFF:aos.IMTR_SEQ_OFF + 4] = _be_bytes(
        np.arange(1, n + 1), 4)
    imtr[:, aos.IMTR_CHID_OFF] = chid
    imtr[:, aos.IMTR_DTMARK_OFF] = aos.IMTR_DTMARK_IMG
    _framed(imdt, n, aos.IMTR_IMGDATA_BYTES, imtr[
        :, aos.IMTR_IMGDATA_OFF:aos.IMTR_IMGDATA_OFF + aos.IMTR_IMGDATA_BYTES])
    crc = native.crc16_many(imtr.reshape(-1), np.arange(n, dtype=np.int64)
                            * aos.IMTR_FRAME_BYTES, aos.IMTR_CRC_OFF)
    imtr[:, aos.IMTR_CRC_OFF:aos.IMTR_CRC_OFF + 2] = _be_bytes(crc, 2)
    imtr[:, aos.IMTR_ENDSIG_OFF:aos.IMTR_ENDSIG_OFF + 4] = np.frombuffer(
        aos.IMTR_ENDSIG, np.uint8)

    stream = imtr.reshape(-1)
    m = -(-stream.size // aos.AOS_DATA_BYTES)
    frames = np.zeros((m, aos.AOS_FRAME_BYTES), np.uint8)
    frames[:, :4] = np.frombuffer(aos.SYNC_BYTES, np.uint8)
    frames[:, 4] = 0x40
    frames[:, aos.AOS_VCID_OFF] = 1
    frames[:, aos.AOS_VCDUSEQ_OFF:aos.AOS_VCDUSEQ_OFF + 3] = _be_bytes(
        np.arange(m) & 0xFFFFFF, 3)
    del imtr
    _framed(stream, m, aos.AOS_DATA_BYTES,
            frames[:, aos.AOS_DATA_OFF:aos.AOS_DATA_OFF + aos.AOS_DATA_BYTES])
    crc = native.crc16_many(
        frames.reshape(-1),
        np.arange(m, dtype=np.int64) * aos.AOS_FRAME_BYTES + aos.AOS_HEADER_OFF,
        aos.AOS_CRC_OFF - aos.AOS_HEADER_OFF)
    frames[:, aos.AOS_CRC_OFF:aos.AOS_CRC_OFF + 2] = _be_bytes(crc, 2)

    inj = slice(aos.AOS_VCDUINJ_OFF, aos.AOS_VCDUINJ_OFF + 4)
    pieces = [rng.integers(0, 256, 777, dtype=np.uint8)]
    counts = {"valid": m, "empty": 0, "invalid": 0}
    prev = 0
    for i, at in enumerate(np.linspace(0, m, 11).astype(int)[1:-1]):
        kind = ("empty", "flagged", "corrupt")[i % 3]
        if kind == "empty":
            extra = np.frombuffer(aos.build_empty_aos_frame(), np.uint8)
        else:
            extra = frames[at - 1].copy()
            if kind == "flagged":
                extra[inj] = 0xAA
            else:
                extra[aos.AOS_CRC_OFF] ^= 0xFF
        counts["empty" if kind == "empty" else "invalid"] += 1
        pieces += [frames[prev:at], extra]
        prev = at
    pieces.append(frames[prev:])
    return pieces, counts


def separate_downlinks(tmp: Path, scene, rng, n_frames):
    """Steps 1 and 2: frame CMOS1's (PAN1, MSS) and CMOS2's (PAN2, MSS)
    ``n_frames`` image frames with random AUX blocks into two downlinks,
    run ``cli.main(["auxsep", ...])`` on each, and hold the separated
    .IMDT, .PAN.RAW, .MSS.RAW and .AUX byte for byte to what was framed;
    -> (the separated PAN1, PAN2 and MSS paths, a record of the runs)."""
    from opticalimageprocessor_tpu_torch.formats import aos
    from opticalimageprocessor_tpu_torch.models.auxsep import AuxSeparator

    pans, mss_rows = scene
    out = tmp / "separated"
    out.mkdir()
    res = {}
    for cmos, chid in ((1, aos.IMTR_CHID_CMOS1), (2, aos.IMTR_CHID_CMOS2)):
        t0 = time.perf_counter()
        pan = pans[cmos - 1]
        aux = rng.integers(0, 256, (n_frames, aos.IMGSIG_AUX_ALLBYTES),
                           dtype=np.uint8)
        imdt = np.frombuffer(b"".join(
            aos.build_image_frame(
                pan[i * aos.IMGSIG_PAN_LINES:(i + 1) * aos.IMGSIG_PAN_LINES],
                mss_rows[i * aos.IMGSIG_MSS_LINES:
                         (i + 1) * aos.IMGSIG_MSS_LINES],
                seq=i + 1, aux=aux[i].tobytes())
            for i in range(n_frames)), np.uint8)
        pieces, counts = frame_downlink(imdt, chid, rng)
        dl = tmp / DOWNLINK.format(cmos)
        with open(dl, "wb") as f:
            for p in pieces:
                f.write(memoryview(p.reshape(-1)))
        del pieces
        rec = dict(framing_s=time.perf_counter() - t0, imdt_bytes=imdt.size,
                   aos_bytes=dl.stat().st_size,
                   chunk_bytes=AuxSeparator(str(dl)).chunk_bytes)
        launches, rec["wall_s"], text = run_cli(
            f"auxsep CMOS{cmos}", ["auxsep", str(dl), "--out-dir", str(out)],
            "downlink")
        check(not any(launches.values()), f"auxsep launched {launches}")
        for m in re.finditer(r"\[(aos_scan|imdt_extract)\] ([\d,]+) bytes in "
                             r"([\d.,]+) seconds \(([\d.,]+) MBps\)", text):
            rec[m.group(1)] = dict(s=float(m.group(3).replace(",", "")),
                                   MBps=float(m.group(4).replace(",", "")))
        check({"aos_scan", "imdt_extract"} <= set(rec), "auxsep stage parse")
        got = re.findall(r"AOS frames: (\d+) valid, (\d+) empty, (\d+) "
                         r"invalid", text)
        check(got == [tuple(str(counts[k]) for k in
                            ("valid", "empty", "invalid"))],
              f"CMOS{cmos}: AOS frames {got}, framed {counts}")

        stem = out / SEPARATED.format(cmos)
        sep = np.memmap(f"{stem}.IMDT", np.uint8, mode="r")
        check(sep.size == -(-imdt.size // aos.IMTR_IMGDATA_BYTES)
              * aos.IMTR_IMGDATA_BYTES
              and np.array_equal(sep[:imdt.size], imdt)
              and not sep[imdt.size:].any(),
              f"CMOS{cmos}: .IMDT != the framed image frames")
        for ext, want in ((".PAN.RAW", pan), (".MSS.RAW", mss_rows)):
            sep = np.memmap(f"{stem}{ext}", "<u2", mode="r")
            check(sep.size == want.size
                  and np.array_equal(sep.reshape(want.shape), want),
                  f"CMOS{cmos}: {ext} != what was framed")
        check(Path(f"{stem}.AUX").read_bytes() == aux.tobytes(),
              f"CMOS{cmos}: .AUX != what was framed")
        del sep, imdt
        dl.unlink()
        Path(f"{stem}.IMDT").unlink()
        say(f"[downlink] CMOS{cmos}: {json.dumps(rec)}; .IMDT, .PAN.RAW, "
            ".MSS.RAW and .AUX == what was framed, byte for byte")
        res[f"cmos{cmos}"] = rec
    stems = [out / SEPARATED.format(c) for c in (1, 2)]
    return (Path(f"{stems[0]}.PAN.RAW"), Path(f"{stems[1]}.PAN.RAW"),
            Path(f"{stems[0]}.MSS.RAW")), res


def trace_split(prof: Path) -> dict:
    """Step 4: the one torch.profiler trace of ``prestitch --profile``: its
    kernel events of (a) and (c) and its stage spans, and the device time
    by class (h2d / d2h / d2d copies, kernels) and their union, in ms."""
    traces = list(prof.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"--profile wrote {len(traces)} traces")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e["dur"] / 1e6 for e in events
             if e.get("cat") == "user_annotation" and "dur" in e}
    check("prestitch_fast" in spans
          and any(n.startswith("rrc:") for n in spans),
          f"the trace lacks the rrc:* / prestitch_fast spans: {sorted(spans)}")
    dev_ev = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e]
    names = {e["name"] for e in dev_ev if e.get("cat") == "kernel"}
    for kernel in ("rrc_kernel", "remap_bands_kernel"):
        check(any(kernel in n for n in names),
              f"the trace has no {kernel} event: {sorted(names)[:20]}")
    by: dict[str, list] = {}
    for e in dev_ev:
        by.setdefault(_copy_class(e["name"]), []).append(
            (e["ts"], e["ts"] + e["dur"]))
    out = {f"{k}_ms": _union_ms(v) for k, v in sorted(by.items())}
    out["device_union_ms"] = _union_ms(iv for v in by.values() for iv in v)
    # the interval the trace covers: the command's wall less this is the
    # profiler's own start (CUPTI) and stop (collecting, writing the JSON)
    timed = [e for e in events if "ts" in e and "dur" in e]
    out["traced_ms"] = (max(e["ts"] + e["dur"] for e in timed)
                        - min(e["ts"] for e in timed)) / 1e3
    out["spans_s"] = spans
    return out


def jp2_codec():
    """The JPEG2000 decoder auxsep finds here: "cv2", "pil" (Pillow with
    OpenJPEG) or None."""
    try:
        import cv2  # noqa: F401
        return "cv2"
    except ImportError:
        pass
    try:
        from PIL import features
    except ImportError:
        return None
    return "pil" if features.check("jpg_2000") else None


def golden_downlinks(tmp: Path) -> dict:
    """Step 5: the committed golden downlinks through ``auxsep``: the raw
    one's outputs at tests/golden/expected.json's SHA-256; the JPEG2000
    one's too where a codec imports, else rc 2 with the JAX package's
    diagnostic."""
    gold = ROOT / "tests" / "golden"
    with open(gold / "expected.json") as f:
        expected = json.load(f)
    codec = jp2_codec()
    res = {"jp2_codec": codec}
    for name, keys in (("golden.dat.gz", ("pan", "mss", "aux", "imdt")),
                       ("golden_jp2.dat.gz", ("pan", "mss", "aux"))):
        d = tmp / name.split(".")[0]
        d.mkdir()
        dat = d / DOWNLINK.format(1)
        with gzip.open(gold / name) as f:
            dat.write_bytes(f.read())
        ok = codec is not None or name == "golden.dat.gz"
        _, _, text = run_cli(f"auxsep {name}",
                             ["auxsep", str(dat), "--out-dir", str(d)],
                             "golden", want_rc=0 if ok else 2)
        if ok:
            stem = d / SEPARATED.format(1)
            for k in keys:
                ext = {"pan": ".PAN.RAW", "mss": ".MSS.RAW", "aux": ".AUX",
                       "imdt": ".IMDT"}[k]
                check(sha256_file(f"{stem}{ext}") == expected[f"{k}_sha"],
                      f"{name}: {ext} SHA-256 != expected.json")
            res[name] = f"{'/'.join(keys)} SHA-256 == expected.json"
        else:
            check("JPEG2000 sub-image decoding needs OpenCV (cv2) or Pillow "
                  "with OpenJPEG" in text, f"{name}: no codec diagnostic")
            res[name] = "no JPEG2000 codec here: rc 2 with the diagnostic"
        shutil.rmtree(d)
    say(f"[golden] {json.dumps(res)}")
    return res


def phase_downlink(dev, power, tmp: Path, want: dict, lines: int = 16384,
                   section_lines: int = 16000):
    """docs/sample-task.sh from two downlinks at the camera's geometry:
    phase 5's scene framed into CMOS1's and CMOS2's downlinks, separated by
    ``auxsep`` byte for byte through the native library; ``prestitch
    --fast --profile``, the default ``--fast`` and ``stitch`` on the
    separated files, their outputs at phase 5's SHA-256 (``want``); the
    trace's kernel events, spans and device split; the golden downlinks.
    -> the launches of the three commands."""
    import torch

    from opticalimageprocessor_tpu_torch.formats import aos
    from opticalimageprocessor_tpu_torch.utils import native

    t_phase = time.perf_counter()
    built = not os.path.exists(native._lib_path())
    check(native.native_available(),
          "the native host library did not load: auxsep would run its numpy "
          "routes")
    say(f"[downlink] native host library {native._lib_path()} loaded"
        f"{', built by this run' if built else ''}")
    pan1, pan2, mss, kb = files_scene(torch, dev, lines)
    scene = ([pan1.cpu().numpy(), pan2.cpu().numpy()],
             mss.cpu().numpy().transpose(1, 0, 2).reshape(lines // 4, W))
    del pan1, pan2, mss
    csv = {}
    for name, (k, b) in kb.items():
        csv[name] = str(tmp / f"{name}.csv")
        _write_csv(csv[name], k, b)
    res = {"lines": lines, "card": power, "native_built": built}
    (p1, p2, m1), res["auxsep"] = separate_downlinks(
        tmp, scene, np.random.default_rng(SEED + 8),
        lines // aos.IMGSIG_PAN_LINES)
    del scene

    launches = {}
    prof, pre, align = tmp / "profile", tmp / "prestitch", tmp / "align"
    pre.mkdir()
    align.mkdir()
    launches["prestitch"], secs, _ = run_cli(
        "prestitch --fast --profile",
        ["prestitch", "--fast", "--pan1", str(p1), "--pan2", str(p2),
         "--rrc1", csv["pan1"], "--rrc2", csv["pan2"], "-s", "1", "-l",
         str(section_lines), "--stitch-overlap", str(FOLD_COLS), "--out-dir",
         str(pre), "--device", dev.type, "--profile", str(prof)],
        "downlink")
    res["prestitch_wall_s"] = secs
    argv = ["--fast", "--pan", str(p1), "--mss", str(m1), "--do-rrc4pan",
            "--rrc-pan", csv["pan1"], "--slices", "10", "--ibc-sections", "1",
            "--out-dir", str(align), "--device", dev.type]
    for b in range(1, 5):
        argv += [f"--rrc-msb{b}", csv[f"msb{b}"]]
    launches["align"], res["align_wall_s"], _ = run_cli("align", argv,
                                                        "downlink")
    st_path = tmp / "STITCHED.RAW"
    prestt = pre / f"{SEPARATED.format(2)}.PAN.RRC.PRESTT.RAW"
    launches["stitch"], res["stitch_wall_s"], _ = run_cli(
        "stitch", ["stitch", "--image1", str(p1), "--image2", str(prestt),
                   "-o", str(st_path), "-c", str(FOLD_COLS)], "downlink")
    n = launches["prestitch"]
    check(n["rrc"] == 2 and n["remap_band"] == 1 and n["crosspower"] == 0
          and n["stitch_tail"] == 0 and n["row_pass"] == 0,
          f"prestitch: launches {n}")
    n = launches["align"]
    check(n["remap_band"] == 4 and n["rrc"] > 0 and n["row_pass"] == 0
          and n["crosspower"] == 0 and n["stitch_tail"] == 0,
          f"align: launches {n}")
    check(not any(launches["stitch"].values()), "stitch launched a kernel")
    got = {"prestt": sha256_file(prestt),
           "aligned": sha256_file(
               align / f"{SEPARATED.format(1)}.MSS.ALIGNED.TIFF"),
           "stitched": sha256_file(st_path)}
    check(got == want, f"outputs from the downlinks {got} != phase 5's {want}")
    say("[downlink] PRESTT.RAW, ALIGNED.TIFF and the stitched RAW from the "
        "downlinks == phase 5's, SHA-256")
    res["prestitch_trace"] = trace_split(prof)
    for d in (pre, align, prof, tmp / "separated"):
        shutil.rmtree(d)
    st_path.unlink()
    res["golden"] = golden_downlinks(tmp)
    res["phase_s"] = time.perf_counter() - t_phase
    say(f"[downlink] {json.dumps(res)}")
    return {k: sum(n[k] for n in launches.values())
            for k in launches["prestitch"]}


# ---------------------------------------------------------------------------
# phase 9: the line mesh (--mesh), N shards on the one card
# ---------------------------------------------------------------------------

MESH_SHARDS = 4


def _line_mesh(dev, n=MESH_SHARDS):
    from opticalimageprocessor_tpu_torch.parallel.mesh import LineMesh

    return LineMesh([dev] * n)


def _counted(fn):
    """``fn()`` with the launch counts set to 0 just before it and read
    just after: -> (its result, the launches)."""
    import torch

    from opticalimageprocessor_tpu_torch import _build

    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.LAUNCHES)


def _sum_launches(*runs):
    return {k: sum(r.get(k, 0) for r in runs) for k in runs[0]}


def _fit_diff(a, b, width):
    """The largest difference of two sets of fitted polynomials (rows of
    ascending coefficients) over the strip's columns, in px."""
    xs = np.arange(0.0, width + 1, 64.0)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    worst = 0.0
    for ca, cb in zip(a, b):
        d = sum((ca[k] - cb[k]) * xs**k for k in range(ca.size))
        worst = max(worst, float(np.abs(d).max()))
    return worst


def phase_mesh_scene(dev, power, lines: int = 32768 + 12):
    """The sharded scene through the module API on ``LineMesh([dev] * 4)``
    at 32780 lines (PAN shards of 8196, 8196, 8196 and 8192 rows): its
    estimates against the resident ScenePipeline's (fit within 1e-5 px,
    stt within 1e-3 px), kernel (b) on the first device's block of tiles
    against its plain version, with the resident estimates pinned its
    aligned, stitched and prestt rasters byte for byte the resident ones
    and the plain versions' (kernels (a), (c), (d) at the shard windows'
    shapes), the sharded MSS2 align (estimates within 1e-5 px; pinned,
    aligned2 byte for byte the resident one and the plain one at row bound
    6), its launches, and one sharded forward's CUDA-event ms and peak
    device memory beside the resident forward's."""
    import torch

    from opticalimageprocessor_tpu_torch.models import device_pipeline as dp
    from opticalimageprocessor_tpu_torch.models.device_pipeline import (
        MssAlign,
        ScenePipeline,
        check_registration_valid,
        check_stt_valid,
    )
    from opticalimageprocessor_tpu_torch.ops import phasecorr, resample, rrc
    from opticalimageprocessor_tpu_torch.ops import phasecorr_cuda as pcc
    from opticalimageprocessor_tpu_torch.ops.rrc import rrc_apply
    from opticalimageprocessor_tpu_torch.parallel.sharded import (
        ingest_line_sharded,
        tile_blocks,
    )
    from opticalimageprocessor_tpu_torch.parallel.sharded_scene import (
        ShardedMssAlign,
        ShardedScene,
    )

    rng = np.random.default_rng(SEED + 9)
    pan1, pan2, mss, mss2 = synth_scene(torch, rng, lines, dev, mss2=True)
    pipe = ScenePipeline(
        rand_params(rng, W), rand_params(rng, W), rand_params(rng, 4, BW),
        fold=FOLD_COLS // 2, overlap_cols=FOLD_COLS, return_prestt=True,
    ).to(dev)
    align = MssAlign(rand_params(rng, 4, BW)).to(dev)
    mesh = _line_mesh(dev)
    scene = ShardedScene(pipe, mesh)
    malign = ShardedMssAlign(align, mesh)
    # the resident route (its launches are not the mesh's)
    est = pipe.estimate(pan1, pan2, mss)
    check_registration_valid(est[2].cpu())
    check_stt_valid(est[5])
    outs = pipe.transform(pan1, pan2, mss, *est[:2], *est[3:5])
    al2, nv2, (cx2, cy2) = align(outs[2], mss2)
    shards = (ingest_line_sharded(mesh, pan1, 0, 4),
              ingest_line_sharded(mesh, pan2, 0, 4),
              ingest_line_sharded(mesh, mss, 1))
    m2s = ingest_line_sharded(mesh, mss2, 1)
    res = {"lines": lines, "shards": MESH_SHARDS, "card": power,
           "pan_shard_rows": [b - a for a, b in map(shards[0].bounds,
                                                    range(MESH_SHARDS))]}

    # the first device's block of registration tiles, as kernel (b) gets it
    blocks = []
    real_wcf = dp.windowed_crosspower_fused_tiles

    def spy_wcf(*args):
        if not blocks:
            blocks.append(args)
        return real_wcf(*args)

    dp.windowed_crosspower_fused_tiles = spy_wcf
    try:
        est_s, l_est = _counted(lambda: scene.estimate(*shards))
    finally:
        dp.windowed_crosspower_fused_tiles = real_wcf
    res["fit_diff_px"] = max(_fit_diff(est_s[k].cpu(), est[k].cpu(), W)
                             for k in (0, 1))
    res["stt_diff_px"] = max(abs(float(est_s[k]) - float(est[k]))
                             for k in (3, 4))
    say(f"[mesh] sharded estimate vs resident: fit {res['fit_diff_px']:.3g} "
        f"px, stt {res['stt_diff_px']:.3g} px; launches {l_est}")
    check(torch.equal(est_s[2], est[2]) and int(est_s[5]) == int(est[5]),
          "sharded valid counts != resident")
    check(res["fit_diff_px"] <= 1e-5 and res["stt_diff_px"] <= 1e-3,
          "sharded estimates beyond 1e-5 px (fit) / 1e-3 px (stt)")
    # kernel (b) on that block against its plain version
    fpan, fband, (M, N), m_small, win_y, win_x = blocks.pop()
    geom = dp.register_geometry(lines, W, pipe.slices, pipe.n_sections)
    t0, t1 = tile_blocks(geom.n_sections * geom.slices, MESH_SHARDS)[0]
    res["tile_block"] = list(fpan.shape[:1]) + [t1 - t0]
    check(fpan.shape[0] == t1 - t0 < geom.n_sections * geom.slices,
          f"kernel (b)'s first block holds {fpan.shape[0]} tiles, not "
          f"{t1 - t0}")
    keep = fpan.shape[-1]
    kargs = (fpan, fband, phasecorr.filter_response(m_small, M // m_small,
                                                    dev),
             phasecorr.filter_response(fband.shape[-1], M // m_small,
                                       dev)[:keep],
             *phasecorr.eval_consts(N, keep, win_x, False, dev))
    res["block_crosspower_max_abs_err"] = crosspower_vs_plain(
        f"[mesh] (b) on a {fpan.shape[0]}-tile block", kargs,
        pcc.packed_eval_operands(N, keep, win_x, dev), M, N, win_y,
        win_x)[0]
    del fpan, fband, kargs

    outs_s, l_tr = _counted(lambda: scene.transform(*shards, *est[:2],
                                                    *est[3:5]))
    # the kernels at the shards' window shapes, held to their plain
    # versions over the whole strip: kernels (a), (c), (d) a shard at 0 DN
    plain = plain_transform(pipe, pan1, pan2, mss, *est[:2], *est[3:5],
                            want_prestt=True)
    for name, got, want, want_p in zip(("aligned", "stitched", "prestt"),
                                       outs_s, outs, plain):
        got = got.gather(dev)
        check(torch.equal(got, want),
              f"sharded {name} != resident (pinned estimates)")
        dmax, share = dn_diff(got, want_p)
        check(dmax == 0, f"sharded {name} vs plain: max {dmax} DN on "
              f"{share:.4%}")
    del plain, got, want, want_p
    say("[mesh] pinned: sharded aligned, stitched, prestt == resident == "
        f"plain byte for byte; launches {l_tr}")

    (al2_s, nv2_s, (cx2_s, cy2_s)), l_m2 = _counted(
        lambda: malign(outs_s[2], m2s))
    res["mss2_fit_diff_px"] = max(_fit_diff(cx2_s.cpu(), cx2.cpu(), W),
                                  _fit_diff(cy2_s.cpu(), cy2.cpu(), W))
    check(torch.equal(nv2_s, nv2) and res["mss2_fit_diff_px"] <= 1e-5,
          f"sharded MSS2 estimates {res['mss2_fit_diff_px']} px off")
    mss2_c = m2s.map(lambda t, d: rrc_apply(t, align.mss_k, align.mss_b))
    al2_pin, l_pin = _counted(lambda: malign.remap(mss2_c, cx2, cy2))
    al2_pin = al2_pin.gather(dev)
    check(torch.equal(al2_pin, al2),
          "sharded aligned2 != resident (pinned estimates)")
    f32 = torch.float32
    al2_p = resample._remap_bands_plain(
        rrc._rrc_plain(mss2, align.mss_k, align.mss_b),
        torch.as_tensor(cx2, dtype=f32, device=dev),
        torch.as_tensor(cy2, dtype=f32, device=dev), align.row_bound,
        resample.col_block_size(BW, align.col_block), align.col_halo)
    dmax, share = dn_diff(al2_pin, al2_p)
    check(dmax == 0, f"sharded aligned2 vs plain (row bound "
          f"{align.row_bound}): max {dmax} DN on {share:.4%}")
    del al2_p
    say(f"[mesh] MSS2: fit {res['mss2_fit_diff_px']:.3g} px off; pinned "
        f"aligned2 == resident == plain (row bound {align.row_bound}) byte "
        f"for byte; launches {l_m2} + {l_pin}")
    launches = _sum_launches(l_est, l_tr, l_m2, l_pin)
    check(all(launches[k] > 0 for k in
              ("rrc", "crosspower", "remap_band", "stitch_tail"))
          and launches["row_pass"] == 0,
          f"the sharded scene did not launch (a)-(d): {launches}")
    check(l_tr["stitch_tail"] == MESH_SHARDS
          and l_tr["remap_band"] == MESH_SHARDS,
          f"the sharded transform's (c) / (d) launches {l_tr}, not one a "
          "shard")
    del outs, outs_s, al2, al2_s, al2_pin, mss2_c
    torch.cuda.empty_cache()

    def resident():
        return int(pipe(pan1, pan2, mss)[0][0, 0, 0])      # forced readback

    def sharded():
        return int(scene(*shards)[0].shards[0][0, 0, 0])

    for name, fn in (("resident", resident), ("sharded", sharded)):
        _, res[f"{name}_forward_peak_gb"] = _peak_gb(fn)
        torch.cuda.empty_cache()
        res[f"{name}_forward_ms"] = time_ms(fn, 3)
    res["note"] = ("4 shards on one card: the sharded forward's ms is the "
                   "cost of sharding (halo and tile copies, 4x the "
                   "launches), not a speed-up")
    say(f"[mesh] {json.dumps(res)}")
    return launches


def _plain_staged(src, cx, cy, row_bound):
    """The staged fast remap (ops/resample.remap_band_fast) of a whole
    (rows, W) uint16 strip on its device with the plain vertical pass
    (_fast_row_pass_plain) in place of kernel (e)."""
    import torch
    import torch.nn.functional as F

    from opticalimageprocessor_tpu_torch.ops import resample

    rows, width = src.shape
    dev = src.device
    cx = torch.as_tensor(np.asarray(cx, np.float32)).to(dev)
    cy = torch.as_tensor(np.asarray(cy, np.float32)).to(dev)
    tap0, w = resample._col_taps(cx, width,
                                 resample.col_block_size(width, None),
                                 resample.COL_HALO)
    colg = resample._col_interp(src.to(torch.float32), tap0, w)
    cu = resample._row_pass_coeffs(resample._band_g(cy, width), row_bound)
    padded = F.pad(colg, (0, 0, row_bound + 1, row_bound + 2))
    del colg
    return resample._round_u16(
        resample._fast_row_pass_plain(padded, cu, rows))


def phase_mesh_files(dev, tmp: Path, lines: int = 16384):
    """The sharded file routes on phase 5's 16384-line files (``tmp``):
    ``run_sharded_align`` in both ``--coord-mode``s and
    ``run_sharded_prestitch`` through the module API on ``LineMesh([dev] *
    4)`` and on one device, their files byte for byte alike and their
    coefficients / deltas equal; continuous mode at 0 DN against the plain
    staged remap of the whole strip with the run's coefficients; quantized
    mode at 0 DN against the cv::remap oracle (whole-image maps) on row
    windows at every shard seam and the strip's ends; the PRESTT.RAW at 0
    DN against the plain staged remap; then ``prestitch --mesh 1`` and the
    default ``--mesh 1`` through ``cli.main``, byte for byte the 4-shard
    files.  -> the launches of the mesh runs."""
    import torch

    from opticalimageprocessor_tpu_torch.io import tiff
    from opticalimageprocessor_tpu_torch.models import (
        sharded_align,
        sharded_prestitch,
    )
    from opticalimageprocessor_tpu_torch.models.scene import load_rrc
    from opticalimageprocessor_tpu_torch.parallel import sharded

    files = {n: str(tmp / f"{n}.RAW")
             for n in ("CMOS1.PAN", "CMOS2A.PAN", "CMOS1.MSS")}
    csv = {n: str(tmp / f"{n}.csv")
           for n in ("pan1", "pan2", *(f"msb{b}" for b in range(1, 5)))}
    kb = {n: load_rrc(p, W if n.startswith("pan") else BW)
          for n, p in csv.items()}
    bands = tuple(csv[f"msb{b}"] for b in range(1, 5))
    mss_h = _raw(files["CMOS1.MSS"]).reshape(-1, 4, BW).transpose(1, 0, 2)
    root = tmp / "mesh"
    root.mkdir()
    res = {"lines": lines, "shards": MESH_SHARDS}
    launches, dirs, fits = [], {}, {}
    calls = []
    restore = [_spy(sharded, "remap_band_dynamic", calls),
               _spy(sharded, "plan_remap_sharded", calls)]
    try:
        for mode in ("continuous", "quantized"):
            for n in (MESH_SHARDS, 1):
                tag = f"align_{mode}_{n}"
                d = dirs[tag] = root / tag
                d.mkdir()
                calls.clear()
                t0 = time.perf_counter()
                path, n_l = _counted(lambda: sharded_align.run_sharded_align(
                    files["CMOS1.PAN"], files["CMOS1.MSS"], csv["pan1"],
                    bands, n_devices=_line_mesh(dev, n), do_rrc_pan=True,
                    slices=10, sections=1, out_dir=str(d),
                    quantized_coords=mode == "quantized"))
                res[f"{tag}_s"] = time.perf_counter() - t0
                launches.append(n_l)
                say(f"[mesh] {tag}: {res[tag + '_s']:.3f} s; launches {n_l}")
                if mode == "continuous":
                    fits[tag] = [(np.asarray(c[1]), np.asarray(c[2]),
                                  c[3] if len(c) > 3 else 6) for c in calls]
                    check(n_l["row_pass"] == 4 * n and n_l["rrc"] > 0
                          and n_l["remap_band"] == 0
                          and n_l["crosspower"] == 0,
                          f"{tag}: launches {n_l}")
                else:
                    (_, cxq, cyq, _), = calls
                    fits[tag] = (np.asarray(cxq), np.asarray(cyq))
                    check(n_l["row_pass"] == 0 and n_l["rrc"] > 0,
                          f"{tag}: launches {n_l}")
            name = "CMOS1.MSS.ALIGNED.TIFF"
            a, b = (dirs[f"align_{mode}_{n}"] / name
                    for n in (MESH_SHARDS, 1))
            check(same_file(a, b), f"{mode}: 4-shard ALIGNED != 1-shard")
        for i, ((c4x, c4y, _), (c1x, c1y, _)) in enumerate(zip(
                fits[f"align_continuous_{MESH_SHARDS}"],
                fits["align_continuous_1"])):
            check(np.array_equal(c4x, c1x) and np.array_equal(c4y, c1y),
                  f"band {i + 1}: 4-shard coefficients != 1-shard")
        check(all(np.array_equal(u, v) for u, v in zip(
            fits[f"align_quantized_{MESH_SHARDS}"],
            fits["align_quantized_1"])), "quantized coefficients differ")
        say("[mesh] align: 4 shards and 1 give the same coefficients and "
            "ALIGNED.TIFF byte for byte, both modes")

        # continuous: the plain staged remap of the whole strip
        img = tiff.read_tiff(str(dirs[f"align_continuous_{MESH_SHARDS}"]
                                 / "CMOS1.MSS.ALIGNED.TIFF"))
        for b, (cx, cy, rb) in enumerate(
                fits[f"align_continuous_{MESH_SHARDS}"]):
            src = torch.from_numpy(
                rrc_oracle(mss_h[b], *kb[f"msb{b + 1}"])).to(dev)
            plain = _plain_staged(src, cx, cy, rb)[520:].cpu().numpy()
            check(np.array_equal(img[..., [2, 1, 0, 3].index(b)], plain),
                  f"continuous band {b + 1} != the plain staged remap")
        say("[mesh] continuous: ALIGNED.TIFF == plain staged remap of the "
            "whole strip (kernel (e) vs _fast_row_pass_plain), 0 DN")
        # quantized: the oracle at every shard seam and the strip's ends
        img = tiff.read_tiff(str(dirs[f"align_quantized_{MESH_SHARDS}"]
                                 / "CMOS1.MSS.ALIGNED.TIFF"))
        cxq, cyq = fits[f"align_quantized_{MESH_SHARDS}"]
        mrows = lines // 4
        seams = [a for a, _ in sharded.shard_bounds(mrows, MESH_SHARDS)[1:]]
        windows = [(520, 552), (mrows - 32, mrows)] + [
            (s - 32, s + 32) for s in seams]
        worst = 0
        for l0, l1 in windows:
            a, e = max(0, l0 - 16), min(mrows, l1 + 16)
            for b in range(4):
                want = oracle_rows(
                    rrc_oracle(mss_h[b, a:e], *kb[f"msb{b + 1}"]), a, l0, l1,
                    *poly_cols(cxq[b], cyq[b], BW), True)
                got = img[l0 - 520:l1 - 520, :, [2, 1, 0, 3].index(b)]
                worst = max(worst, int(np.abs(
                    got.astype(np.int32) - want.astype(np.int32)).max()))
        say(f"[mesh] quantized: ALIGNED.TIFF vs the cv::remap oracle "
            f"(whole-image maps) at seams {seams} and the ends: max {worst} "
            "DN")
        check(worst == 0, "quantized mesh align vs the oracle")
        del img

        # prestitch, 4 shards and 1
        deltas = {}
        for n in (MESH_SHARDS, 1):
            tag = f"prestitch_{n}"
            d = dirs[tag] = root / tag
            d.mkdir()
            calls.clear()
            t0 = time.perf_counter()
            deltas[n], n_l = _counted(
                lambda: sharded_prestitch.run_sharded_prestitch(
                    files["CMOS1.PAN"], files["CMOS2A.PAN"], csv["pan1"],
                    csv["pan2"], n_devices=_line_mesh(dev, n), sections=1,
                    line_per_section=16000, overlap_cols=FOLD_COLS,
                    out_dir=str(d)))
            res[f"{tag}_s"] = time.perf_counter() - t0
            launches.append(n_l)
            say(f"[mesh] {tag}: deltas {deltas[n][:2]} in "
                f"{res[tag + '_s']:.3f} s; launches {n_l}")
            check(n_l["rrc"] == 2 * n and n_l["row_pass"] >= n
                  and n_l["remap_band"] == 0, f"{tag}: launches {n_l}")
        check(deltas[MESH_SHARDS][:2] == deltas[1][:2],
              "prestitch deltas differ between 4 shards and 1")
        dx, dy, prestt = deltas[MESH_SHARDS]
        check(abs(dx + 3) < 0.05 and abs(dy - 3) < 0.05, f"stt {dx}, {dy}")
        for name in ("CMOS1.PAN.RRC.RAW", "CMOS2A.PAN.RRC.RAW",
                     "CMOS2A.PAN.RRC.PRESTT.RAW"):
            check(same_file(dirs[f"prestitch_{MESH_SHARDS}"] / name,
                            dirs["prestitch_1"] / name),
                  f"prestitch {name}: 4 shards != 1")
        (_, cxp, cyp, rbp), = calls
        src = torch.from_numpy(
            _raw(dirs[f"prestitch_{MESH_SHARDS}"] / "CMOS2A.PAN.RRC.RAW")
        ).to(dev)
        plain = _plain_staged(src, np.asarray(cxp), np.asarray(cyp), rbp)
        check(np.array_equal(_raw(prestt), plain.cpu().numpy()),
              "PRESTT.RAW != the plain staged remap")
        del src, plain
        torch.cuda.empty_cache()
        say(f"[mesh] prestitch: 4 shards == 1 (RRC, PRESTT) byte for byte; "
            f"PRESTT == plain staged remap at row bound {rbp}, 0 DN")
    finally:
        for r in restore:
            r()

    # --mesh 1 through the CLI: the 4-shard model runs' files
    d = root / "cli_prestitch"
    d.mkdir()
    n_l, res["cli_prestitch_s"], _ = run_cli(
        "prestitch --mesh 1",
        ["prestitch", "--pan1", files["CMOS1.PAN"], "--pan2",
         files["CMOS2A.PAN"], "--rrc1", csv["pan1"], "--rrc2", csv["pan2"],
         "-s", "1", "-l", "16000", "--stitch-overlap", str(FOLD_COLS),
         "--out-dir", str(d), "--mesh", "1", "--device", dev.type], "mesh")
    launches.append(n_l)
    for name in ("CMOS1.PAN.RRC.RAW", "CMOS2A.PAN.RRC.RAW",
                 "CMOS2A.PAN.RRC.PRESTT.RAW"):
        check(same_file(d / name, dirs[f"prestitch_{MESH_SHARDS}"] / name),
              f"prestitch --mesh 1 {name} != the 4-shard run's")
    d = root / "cli_align"
    d.mkdir()
    argv = ["--pan", files["CMOS1.PAN"], "--mss", files["CMOS1.MSS"],
            "--do-rrc4pan", "--rrc-pan", csv["pan1"], "--slices", "10",
            "--ibc-sections", "1", "--out-dir", str(d), "--mesh", "1",
            "--device", dev.type]
    for b in range(1, 5):
        argv += [f"--rrc-msb{b}", csv[f"msb{b}"]]
    n_l, res["cli_align_s"], _ = run_cli("default --mesh 1", argv, "mesh")
    launches.append(n_l)
    check(same_file(d / "CMOS1.MSS.ALIGNED.TIFF",
                    dirs[f"align_continuous_{MESH_SHARDS}"]
                    / "CMOS1.MSS.ALIGNED.TIFF"),
          "default --mesh 1 ALIGNED.TIFF != the 4-shard run's")
    say("[mesh] prestitch --mesh 1 and the default --mesh 1 through "
        "cli.main == the 4-shard module runs byte for byte")
    say(f"[mesh] files {json.dumps(res)}")
    shutil.rmtree(root)
    return _sum_launches(*launches)


SCENE_OUTPUTS = ("MSS.ALIGNED.TIFF", "STITCHED.RAW", "MSS2.ALIGNED.TIFF",
                 "STITCHED_MSS.TIFF")


def phase_mesh_cli(dev, tmp: Path, want: dict, section: int = 4096):
    """Through ``cli.main`` on phase 6's 34816-line files (``tmp``):
    ``scene --mesh 1 --mss2`` and ``scene --stream --mesh 1 --mss2``, their
    outputs at phase 6's SHA-256 (``want``: the streamed run's, equal to
    the resident run's); ``scene --mesh 2`` on one card: rc 2 with JAX's
    message; a partial ``OIP_DIST_*`` env in a subprocess: a non-zero rc
    naming the missing variable.  -> the launches of the mesh runs."""
    import torch

    files = {n: tmp / f"{n}.RAW" for n in ("PAN1", "PAN2", "MSS", "MSS2")}
    launches = []
    for route, extra in (("mesh", ["--mesh", "1"]),
                         ("stream_mesh", ["--stream", "--stream-section-lines",
                                          str(section), "--mesh", "1"])):
        out = tmp / route
        out.mkdir()
        n_l, secs, _ = run_cli(f"scene {' '.join(extra)} --mss2",
                               scene_argv(files, tmp, out, dev, *extra),
                               "mesh")
        launches.append(n_l)
        names = SCENE_OUTPUTS + (("PAN2.PRESTT.RAW",) if "--stream" in extra
                                 else ())
        got = {name: sha256_file(out / name) for name in names}
        check(got == {k: want[k] for k in names},
              f"scene {' '.join(extra)}: outputs != phase 6's")
        say(f"[mesh] scene {' '.join(extra)} --mss2: {secs:.3f} s, outputs "
            "== phase 6's (SHA-256)")
        shutil.rmtree(out)
    out = tmp / "mesh2"
    out.mkdir()
    n_l, _, text = run_cli(
        "scene --mesh 2", scene_argv(files, tmp, out, dev, "--mesh", "2"),
        "mesh", want_rc=2)
    have = torch.cuda.device_count()
    check(have >= 2 or f"--mesh 2 needs 2 devices, only {have} available"
          in text, "scene --mesh 2 on one card: not JAX's message")
    check(not any(n_l.values()) and not os.listdir(out),
          "scene --mesh 2 on one card did work")
    say("[mesh] scene --mesh 2 on one card: rc 2, "
        f"'--mesh 2 needs 2 devices, only {have} available'")
    env = {k: v for k, v in os.environ.items()
           if k not in ("OIP_DIST_NPROCS", "OIP_DIST_PROCID")}
    env.update(OIP_DIST_COORD="127.0.0.1:1", PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys\nfrom opticalimageprocessor_tpu_torch.cli import main\n"
         "sys.exit(main(['--help']))"],
        env=env, capture_output=True, text=True, timeout=300)
    check(r.returncode != 0 and "OIP_DIST_NPROCS" in r.stderr + r.stdout,
          f"a partial OIP_DIST_* env gave rc {r.returncode}")
    say(f"[mesh] partial OIP_DIST_* env: rc {r.returncode}, names "
        "OIP_DIST_NPROCS")
    return _sum_launches(*launches)


# ---------------------------------------------------------------------------
# --profile: where the device time of one forward goes
# ---------------------------------------------------------------------------

_KERNEL_CLASSES = (
    ("row_pass_kernel", "kernel (e) row_pass"),
    ("crosspower_kernel", "kernel (b) crosspower"),
    ("stitch_tail_kernel", "kernel (d) stitch_tail"),
    ("remap_bands_kernel", "kernel (c) remap_band"),
    ("rrc_kernel", "kernel (a) rrc"),
)


def _device_class(name: str) -> str:
    for key, label in _KERNEL_CLASSES:
        if key in name:
            return label
    low = name.lower()
    if "memcpy" in low:
        return "memcpy"
    if "memset" in low:
        return "memset"
    if "fft" in low:
        return "cuFFT"
    if any(k in low for k in ("gemm", "gemv", "xmma", "splitkreduce")):
        return "cuBLAS"
    return "other (copies, cat, casts, elementwise)"


def _union_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals, in ms (us in)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def phase_profile(dev, power, lines: int) -> dict:
    """One ``ScenePipeline.forward`` under torch.profiler after warm-up:
    device time per class, the union of all device intervals (busy), and
    the idle share against the forward's wall time, profiled (host clock)
    and unprofiled (CUDA events, 5 iterations)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from opticalimageprocessor_tpu_torch.models.device_pipeline import (
        ScenePipeline,
    )

    rng = np.random.default_rng(SEED + 2)
    pan1, pan2, mss = synth_scene(torch, rng, lines, dev)
    pipe = ScenePipeline(
        rand_params(rng, W), rand_params(rng, W), rand_params(rng, 4, BW),
        fold=FOLD_COLS // 2, overlap_cols=FOLD_COLS,
    ).to(dev)

    def step():
        return int(pipe(pan1, pan2, mss)[0][0, 0, 0])    # forced readback

    step()
    unprofiled = time_ms(step, 5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory(prefix="oip_prof_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev_ev = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e]
    check(bool(dev_ev), "the profiler recorded no device time")
    classes: dict[str, float] = {}
    per_name: dict[str, list] = {}
    for e in dev_ev:
        label = _device_class(e["name"])
        classes[label] = classes.get(label, 0.0) + e["dur"] / 1e3
        acc = per_name.setdefault(e["name"][:90], [0.0, 0])
        acc[0] += e["dur"] / 1e3
        acc[1] += 1
    busy = _union_ms((e["ts"], e["ts"] + e["dur"]) for e in dev_ev)
    top = sorted(([round(v[0], 4), v[1], k] for k, v in per_name.items()),
                 reverse=True)[:12]
    return dict(
        lines=lines, card=power, unprofiled_ms=unprofiled,
        profiled_wall_ms=wall, busy_union_ms=busy,
        idle_share_profiled=1.0 - busy / wall,
        idle_share_unprofiled=1.0 - busy / unprofiled,
        classes_ms=dict(sorted(classes.items(), key=lambda kv: -kv[1])),
        top_kernels=top,
    )


# ---------------------------------------------------------------------------

def main() -> int:
    import torch

    args = sys.argv[1:]
    if args not in ([], ["--profile"]):
        say("usage: python3 chip_smoke.py [--profile]")
        return 2
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false")
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from opticalimageprocessor_tpu_torch import _build
    except ImportError as e:
        say(f"FAIL: the port package is not beside this script ({e})")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(power)       # the card's name and power limit, as nvidia-smi prints
    say(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    say(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill",
                                   "error")):
            say(f"[build] {line.strip()}")

    if args == ["--profile"]:
        for lines in (32768, 65536):
            say(f"[profile] {json.dumps(phase_profile(dev, power, lines))}")
            torch.cuda.empty_cache()
        return 0

    records: dict[str, dict] = {}
    phase_kernels(dev, records)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="oip_smoke_") as tmp:
        # one log for phases 3, 5 and 6: the logger opens LOGFILE once
        os.environ["LOGFILE"] = os.path.join(tmp, "oip.log")
        scene_dir, files_dir = Path(tmp, "scene"), Path(tmp, "files")
        scene_dir.mkdir()
        launches = phase_cli(dev, scene_dir)
        shutil.rmtree(scene_dir)
        torch.cuda.empty_cache()
        phase_pipeline(dev, power)
        torch.cuda.empty_cache()
        mesh_launches = [phase_mesh_scene(dev, power)]
        torch.cuda.empty_cache()
        files_dir.mkdir()
        files_launches, files_shas = phase_files(dev, files_dir)
        torch.cuda.empty_cache()
        mesh_launches.append(phase_mesh_files(dev, files_dir))
        shutil.rmtree(files_dir)
        torch.cuda.empty_cache()
        stream_dir = Path(tmp, "stream")
        stream_dir.mkdir()
        stream_launches, stream_shas = phase_stream(dev, power, stream_dir)
        torch.cuda.empty_cache()
        mesh_launches.append(phase_mesh_cli(dev, stream_dir, stream_shas))
        shutil.rmtree(stream_dir)
        torch.cuda.empty_cache()
        parity_dir = Path(tmp, "parity")
        parity_dir.mkdir()
        parity_launches = phase_parity(dev, power, parity_dir)
        shutil.rmtree(parity_dir)
        torch.cuda.empty_cache()
        downlink_dir = Path(tmp, "downlink")
        downlink_dir.mkdir()
        downlink_launches = phase_downlink(dev, power, downlink_dir,
                                           files_shas)
        shutil.rmtree(downlink_dir)
    mesh_launches = _sum_launches(*mesh_launches)
    say(f"[mesh] launches of phase 9's mesh runs {mesh_launches}")
    launches = {k: launches[k] + files_launches[k] + stream_launches[k]
                + parity_launches[k] + downlink_launches[k]
                + mesh_launches[k] for k in launches}
    check(all(v > 0 for v in launches.values()),
          f"a kernel was never launched in phases 3, 5, 6, 7, 8 and 9: "
          f"{launches}")

    replaces = {
        "rrc": ("opticalimageprocessor_tpu_torch/csrc/rrc.cu",
                "opticalimageprocessor_tpu/ops/rrc.py:149"),
        "crosspower": ("opticalimageprocessor_tpu_torch/csrc/crosspower.cu",
                       "opticalimageprocessor_tpu/ops/phasecorr_pallas.py:136"),
        "remap_band": ("opticalimageprocessor_tpu_torch/csrc/remap_band.cu",
                       "opticalimageprocessor_tpu/ops/resample.py:752"),
        "stitch_tail": ("opticalimageprocessor_tpu_torch/csrc/stitch_tail.cu",
                        "opticalimageprocessor_tpu/ops/resample.py:1149"),
        "row_pass": ("opticalimageprocessor_tpu_torch/csrc/row_pass.cu",
                     "opticalimageprocessor_tpu/ops/resample.py:652"),
    }
    kernels = []
    for name, (source, repl) in replaces.items():
        r = records[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=repl,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"],
            **{k: r[k] for k in ("scene_ms", "scene_bound_ms", "gemm_only_ms",
                                 "scene_gemm_only_ms", "prestitch_ms",
                                 "prestitch_bound_ms", "align_ms",
                                 "align_bound_ms", "mss2_ms", "mss2_bound_ms",
                                 "section_ms", "section_bound_ms", "library",
                                 "shapes")
               if k in r},
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Whole-scene pipeline (the CLI's ``scene`` subcommand), single device.

Counterpart of ``opticalimageprocessor_tpu/models/scene.py``: loads the
PAN1/PAN2/MSS RAW strips and the RRC CSVs, runs
:class:`~.device_pipeline.ScenePipeline` (estimate, then transform) on one
device, reports the reference's validity failures with the same messages,
and writes the CMOS1 ALIGNED.TIFF and the stitched PAN (RAW or TIFF).

RAW/TIFF/CSV host IO and logging come from the port's own host modules
(``constants``, ``formats``, ``io``, ``utils.logging``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..constants import (
    BYTES_PER_PIXEL,
    IBCV_DEF_THRESHOLD,
    IBPA_STEM_EXT,
    MSS_BANDS,
    PIXELS_PER_LINE,
    TIFF_FILE_EXT,
)
from ..formats.naming import build_output_file_path
from ..formats.rrc_csv import load_rrc_params
from ..io import raw as raw_io
from ..io import tiff as tiff_io
from ..utils.logging import logw, olog, stage

from .device_pipeline import (
    ScenePipeline,
    check_registration_valid,
    check_stt_valid,
)

_WRITE_ROWS = 4096   # host rows per device->host copy when writing


def load_rrc(path: str, columns: int) -> tuple[np.ndarray, np.ndarray]:
    """float64 ``(k, b)`` from an RRC CSV; an empty path gives the
    identity (k=1, b=0: an exact no-op through the RRC)."""
    if not path:
        return np.ones(columns), np.zeros(columns)
    kb = load_rrc_params(path, columns)
    return kb[:, 0].copy(), kb[:, 1].copy()


def log_band_coeffs(cx, cy, n_valid) -> None:
    """OLOG the fitted per-band shift polynomials in the PreProcessor's
    format (preproc.h:552-560)."""
    cx = np.asarray(cx, np.float64)
    cy = np.asarray(cy, np.float64)
    n_valid = np.asarray(n_valid)
    for b in range(cx.shape[0]):
        olog("Inter-band shifting of MSB%d: %d valid values", b + 1,
             int(n_valid[b]))
        olog("\tdeltaX coeff: [1] %.15f, [0] %.9f", cx[b, 1], cx[b, 0])
        olog(
            "\tdeltaY coeff: [2] %.15f, [1] %.15f, [0] %.9f",
            cy[b, 2], cy[b, 1], cy[b, 0],
        )


def log_scene_params(params, n_valid, n_stt: int) -> None:
    """OLOG the estimated parameters: per-band fits and the averaged stt
    deltas (the RAW average, stitcher.h:196-199); when the clamp engaged,
    also the clamped values the prestitch resample consumed."""
    cx, cy, stt_dx, stt_dy, raw_dx, raw_dy = params
    log_band_coeffs(cx, cy, n_valid)
    stt_dx, stt_dy = float(stt_dx), float(stt_dy)
    raw_dx, raw_dy = float(raw_dx), float(raw_dy)
    olog(
        "Total %d valid delta value pairs found, everage value: "
        "dx: %.5f, dy: %.5f",
        n_stt, raw_dx, raw_dy,
    )
    if (stt_dx, stt_dy) != (raw_dx, raw_dy):
        logw(
            "stt deltas clamped to the supported resample band: "
            "dx %.5f -> %.5f, dy %.5f -> %.5f (raise col_halo / "
            "prestt-row-bound for larger mounting offsets)",
            raw_dx, stt_dx, raw_dy, stt_dy,
        )


def _host_rows(t: torch.Tensor):
    """Yield a device raster's rows as host numpy blocks in line order."""
    for a in range(0, t.shape[0], _WRITE_ROWS):
        yield t[a:a + _WRITE_ROWS].cpu().numpy()


def resolve_device(device: str | torch.device) -> torch.device:
    """The run's device; a CUDA device without CUDA raises (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available"
        )
    return dev


def run_scene(
    pan1_file: str,
    pan2_file: str,
    mss_file: str,
    rrc_pan1: str = "",
    rrc_pan2: str = "",
    rrc_mss_files: tuple[str, str, str, str] | None = None,
    slices: int = 10,
    sections: int | None = None,
    fold_cols: int = 200,
    stt_sections: int = 10,
    threshold: float = IBCV_DEF_THRESHOLD,
    stt_threshold: float = IBCV_DEF_THRESHOLD,
    stt_max_delta_y: float = 0.0,
    out_stitched: str = "",
    out_dir: str | None = None,
    pixels_per_line: int = PIXELS_PER_LINE,
    bgr_tiff_order: bool = True,
    device: str | torch.device = "cuda",
):
    """Run the scene pipeline on one device; returns a dict of output
    paths (``aligned``, ``stitched``)."""
    dev = resolve_device(device)
    # the kx/ky contractions are float32 matmuls, as the JAX package runs
    # them at Precision.HIGHEST: never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    band_px = pixels_per_line // MSS_BANDS
    p1 = raw_io.RawStrip(pan1_file, pixels_per_line)
    p2 = raw_io.RawStrip(pan2_file, pixels_per_line)
    ms = raw_io.RawStrip(mss_file, pixels_per_line)
    if p1.nbytes != p2.nbytes:
        raise ValueError("PAN1 size doesn't match PAN2 size")
    raw_io.check_pan_mss_sizes(p1, ms)
    olog("Scene: PAN %d lines, MSS %d lines.", p1.lines, ms.lines)

    mss_kb = [load_rrc(f, band_px) for f in rrc_mss_files or ("",) * 4]
    pipe = ScenePipeline(
        load_rrc(rrc_pan1, pixels_per_line),
        load_rrc(rrc_pan2, pixels_per_line),
        (np.stack([k for k, _ in mss_kb]), np.stack([b for _, b in mss_kb])),
        slices=slices, n_sections=sections, fold=fold_cols // 2,
        stt_sections=stt_sections,
        # the stt windows span the physical CMOS overlap, which is what
        # the stitch folds away (stitcher.h: stitch-overlap == fold cols)
        overlap_cols=fold_cols,
        threshold=threshold, stt_threshold=stt_threshold,
        stt_max_delta_y=stt_max_delta_y,
    ).to(dev)

    with stage("scene_load", p1.nbytes * 2 + ms.nbytes):
        pan1 = torch.from_numpy(np.array(p1._mm)).to(dev)
        pan2 = torch.from_numpy(np.array(p2._mm)).to(dev)
        view = ms._mm.reshape(ms.lines, MSS_BANDS, band_px).transpose(1, 0, 2)
        mss = torch.from_numpy(np.ascontiguousarray(view)).to(dev)

    with stage("scene_estimate", p1.nbytes + ms.nbytes):
        cx, cy, n_valid, raw_dx, raw_dy, n_stt = pipe.estimate(
            pan1, pan2, mss
        )
        n_valid = n_valid.cpu().numpy()
        n_stt = int(n_stt)
    check_registration_valid(n_valid)
    check_stt_valid(n_stt)
    dxs, dys = pipe.clamp_stt(raw_dx, raw_dy)
    log_scene_params(
        (cx.cpu().numpy(), cy.cpu().numpy(), dxs, dys, raw_dx, raw_dy),
        n_valid, n_stt,
    )
    with stage("scene_transform", p1.nbytes * 2 + ms.nbytes):
        aligned, stitched = pipe.transform(
            pan1, pan2, mss, cx, cy, raw_dx, raw_dy
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    del pan1, pan2, mss

    order = [2, 1, 0, 3] if bgr_tiff_order else [0, 1, 2, 3]
    aligned_path = build_output_file_path(
        mss_file, IBPA_STEM_EXT, TIFF_FILE_EXT, out_dir=out_dir
    )
    with stage("scene_write_aligned", aligned.numel() * 2):
        writer = tiff_io.TiffStripWriter(
            aligned_path, band_px, ms.lines, samples=MSS_BANDS
        )
        for blk in _host_rows(aligned):
            writer.write_rows(blk[:, :, order])
        writer.close()
    olog("Aligned MSS written to %s", aligned_path)

    st_w = int(stitched.shape[1])
    if not out_stitched:
        out_stitched = os.path.join(
            out_dir or os.getcwd(),
            f"stitched_{st_w}n{BYTES_PER_PIXEL * 8}b{TIFF_FILE_EXT}",
        )
    out_is_tiff = os.path.splitext(out_stitched)[1].lower() in (
        ".tiff", ".tif",
    )
    with stage("scene_write_stitched", stitched.numel() * 2):
        if out_is_tiff:
            writer = tiff_io.TiffStripWriter(
                out_stitched, st_w, p1.lines, samples=1
            )
            for blk in _host_rows(stitched):
                writer.write_rows(blk)
        else:
            writer = raw_io.RawStripWriter(out_stitched, st_w)
            for blk in _host_rows(stitched):
                writer.write_lines(blk)
        writer.close()
    olog("Stitched PAN written to %s", out_stitched)
    return {"aligned": aligned_path, "stitched": out_stitched}

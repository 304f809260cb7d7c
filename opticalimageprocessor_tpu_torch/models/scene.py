"""Whole-scene pipeline (the CLI's ``scene`` subcommand).

Counterpart of ``opticalimageprocessor_tpu/models/scene.py``: loads the
PAN1/PAN2/MSS RAW strips and the RRC CSVs, runs
:class:`~.device_pipeline.ScenePipeline` (estimate, then transform) on one
device or, with ``mesh=N``, on each shard of an N-device line mesh
(``parallel/sharded_scene``), reports the reference's validity failures
with the same messages, and writes the CMOS1 ALIGNED.TIFF and the stitched
PAN (RAW or TIFF).  With ``mss2_file`` it runs the reference's whole
``DOC/sample-task.sh`` workflow: CMOS2's MSS aligns against the
prestitched PAN2 while that is still on the devices
(:class:`~.device_pipeline.MssAlign`), and the two aligned rasters stitch
into one MSS TIFF.  ``models/scene_stream`` runs the same scene in
bounded-memory sections.

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
from ..parallel.mesh import LINE_AXIS, LineMesh, LineSharded, resolve_mesh
from ..utils.logging import device_profile, logw, olog, stage, to_host

from .device_pipeline import (
    ScenePipeline,
    check_registration_valid,
    check_stt_valid,
    make_mss_align,
)

_WRITE_ROWS = 4096   # host rows per device->host copy when writing


def load_rrc(path: str, columns: int) -> tuple[np.ndarray, np.ndarray]:
    """float64 ``(k, b)`` from an RRC CSV; an empty path gives the
    identity (k=1, b=0: an exact no-op through the RRC)."""
    if not path:
        return np.ones(columns), np.zeros(columns)
    kb = load_rrc_params(path, columns)
    return kb[:, 0].copy(), kb[:, 1].copy()


def load_band_rrc(paths, band_px: int) -> tuple[np.ndarray, np.ndarray]:
    """float64 ``(k, b)`` (4, band_px) of the 4 MSS bands' RRC CSVs (None:
    the identity)."""
    kb = [load_rrc(f, band_px) for f in paths or ("",) * MSS_BANDS]
    return np.stack([k for k, _ in kb]), np.stack([b for _, b in kb])


def is_tiff(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in (".tiff", ".tif")


def check_tiff_output(path: str) -> None:
    """The stitched MSS is multi-band: TIFF only (stitch_tiff parity);
    checked before any device work."""
    if path and not is_tiff(path):
        raise ValueError("Output file should be a tiff image")


def default_stitched_path(out_dir, width: int) -> str:
    return os.path.join(
        out_dir or os.getcwd(),
        f"stitched_{width}n{BYTES_PER_PIXEL * 8}b{TIFF_FILE_EXT}",
    )


def default_stitched_mss_path(out_dir) -> str:
    return os.path.join(out_dir or os.getcwd(), f"stitched-MSS{TIFF_FILE_EXT}")


def mss_fold_half(fold_cols: int) -> int:
    """Fold columns each aligned MSS raster loses at the seam: the MSS
    folds PAN's ``fold_cols / 4`` (sample-task.sh FOLDCOL_MSS), half a
    side."""
    return max(1, fold_cols // MSS_BANDS // 2)


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
    raw_dx, raw_dy = float(to_host(raw_dx)), float(to_host(raw_dy))
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


def scene_pipeline(rrc_pan1, rrc_pan2, rrc_mss_files, pixels_per_line,
                   slices, sections, fold_cols, stt_sections, threshold,
                   stt_threshold, stt_max_delta_y, return_prestt):
    """The scene's :class:`ScenePipeline` from the CLI's settings and RRC
    CSVs (on the CPU; move it with ``.to``)."""
    return ScenePipeline(
        load_rrc(rrc_pan1, pixels_per_line),
        load_rrc(rrc_pan2, pixels_per_line),
        load_band_rrc(rrc_mss_files, pixels_per_line // MSS_BANDS),
        slices=slices, n_sections=sections, fold=fold_cols // 2,
        stt_sections=stt_sections,
        # the stt windows span the physical CMOS overlap, which is what
        # the stitch folds away (stitcher.h: stitch-overlap == fold cols)
        overlap_cols=fold_cols,
        threshold=threshold, stt_threshold=stt_threshold,
        stt_max_delta_y=stt_max_delta_y, return_prestt=return_prestt,
    )


def run_scene(*args, profile_dir: str = "", **kw):
    """Run the scene pipeline (see :func:`_run_scene`); with
    ``profile_dir`` the whole run is wrapped in a torch.profiler trace
    (utils.logging.device_profile)."""
    with device_profile(profile_dir, kw.get("device", "cuda")):
        return _run_scene(*args, **kw)


def _run_scene(
    pan1_file: str,
    pan2_file: str,
    mss_file: str,
    rrc_pan1: str = "",
    rrc_pan2: str = "",
    rrc_mss_files: tuple[str, str, str, str] | None = None,
    mss2_file: str = "",
    rrc_mss2_files: tuple[str, str, str, str] | None = None,
    slices: int = 10,
    sections: int | None = None,
    fold_cols: int = 200,
    stt_sections: int = 10,
    threshold: float = IBCV_DEF_THRESHOLD,
    stt_threshold: float = IBCV_DEF_THRESHOLD,
    stt_max_delta_y: float = 0.0,
    out_stitched: str = "",
    out_stitched_mss: str = "",
    out_dir: str | None = None,
    pixels_per_line: int = PIXELS_PER_LINE,
    bgr_tiff_order: bool = True,
    device: str | torch.device = "cuda",
    mesh: int | LineMesh = 0,
):
    """Run the scene pipeline; returns a dict of output paths
    (``aligned``, ``stitched``; with ``mss2_file`` also ``aligned2`` and
    ``stitched_mss``).

    With ``mss2_file`` CMOS2's MSS registers and aligns against the
    prestitched PAN2 (the sample task's step 3.2 uses ``S1_PAN2 =
    *.RRC.PRESTT.RAW``), and the two ALIGNED rasters stitch into one wide
    MSS TIFF with ``fold_cols / 4`` fold columns.

    ``mesh``: 0 runs on ``device``; N (or an explicit
    :class:`~..parallel.mesh.LineMesh`) over an N-device line mesh (JAX's
    ``scene --mesh N``, models/scene.py:188-236).  Either way the strips
    are ingested shard by shard from the memory maps (one shard on one
    device), :class:`~..parallel.sharded_scene.ShardedScene` (and with
    ``mss2_file`` :class:`~..parallel.sharded_scene.ShardedMssAlign`) runs
    the scene on the shards through :class:`~.device_pipeline.
    ScenePipeline` / :class:`~.device_pipeline.MssAlign`, and the rasters
    drain shard by shard at their rows' offsets (``parallel/distributed``):
    the same files, byte for byte, on any mesh at the same estimates.
    Under several processes (``OIP_DIST_*``) the mesh spans them, each
    process ingests and drains its own shards, and a run without a mesh
    raises JAX's message."""
    from ..parallel.distributed import (
        drain_line_sharded_to_raw,
        drain_line_sharded_to_tiff,
    )
    from ..parallel.sharded import ingest_line_sharded
    from ..parallel.sharded_scene import ShardedMssAlign, ShardedScene

    from ..parallel.distributed import process_count

    if mss2_file:
        check_tiff_output(out_stitched_mss)
    if process_count() > 1 and not mesh:
        # without a mesh every process would run the whole scene
        # redundantly and race on the same output files
        raise RuntimeError(
            f"multi-host scene run ({process_count()} processes) "
            "requires --mesh N so strips shard across the processes' "
            "devices and each process drains only its own rows"
        )
    sharded = resolve_mesh(mesh, device)
    mesh = sharded or LineMesh([resolve_device(device)])
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
    if sharded:
        olog("Sharded scene over %d-device '%s' mesh.", len(mesh), LINE_AXIS)

    scene = ShardedScene(scene_pipeline(
        rrc_pan1, rrc_pan2, rrc_mss_files, pixels_per_line, slices,
        sections, fold_cols, stt_sections, threshold, stt_threshold,
        stt_max_delta_y, return_prestt=bool(mss2_file),
    ), mesh)

    def load_bands_sharded(strip):
        view = strip._mm.reshape(strip.lines, MSS_BANDS, band_px)
        return ingest_line_sharded(mesh, view.transpose(1, 0, 2), 1)

    with stage("scene_load", p1.nbytes * 2 + ms.nbytes):
        pan1 = ingest_line_sharded(mesh, p1._mm, 0, MSS_BANDS)
        pan2 = ingest_line_sharded(mesh, p2._mm, 0, MSS_BANDS)
        mss = load_bands_sharded(ms)
    with stage("scene_estimate", p1.nbytes + ms.nbytes):
        cx, cy, n_valid, raw_dx, raw_dy, n_stt = scene.estimate(
            pan1, pan2, mss)
        n_valid = to_host(n_valid).numpy()
        n_stt = int(to_host(n_stt))
    check_registration_valid(n_valid)
    check_stt_valid(n_stt)
    dxs, dys = scene.pipe.clamp_stt(raw_dx, raw_dy)
    log_scene_params(
        (to_host(cx).numpy(), to_host(cy).numpy(), dxs, dys, raw_dx, raw_dy),
        n_valid, n_stt,
    )
    with stage("scene_transform", p1.nbytes * 2 + ms.nbytes):
        aligned, stitched, *prestt = scene.transform(
            pan1, pan2, mss, cx, cy, raw_dx, raw_dy)
        for dev in mesh.distinct():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    del pan1, pan2, mss

    order = [2, 1, 0, 3] if bgr_tiff_order else [0, 1, 2, 3]
    aligned_path = build_output_file_path(
        mss_file, IBPA_STEM_EXT, TIFF_FILE_EXT, out_dir=out_dir
    )
    with stage("scene_write_aligned", ms.lines * band_px * MSS_BANDS * 2):
        drain_line_sharded_to_tiff(aligned, aligned_path, order=order)
    olog("Aligned MSS written to %s", aligned_path)

    st_w = stitched.shape[1]
    out_stitched = out_stitched or default_stitched_path(out_dir, st_w)
    with stage("scene_write_stitched", p1.lines * st_w * 2):
        if is_tiff(out_stitched):
            drain_line_sharded_to_tiff(stitched, out_stitched)
        else:
            drain_line_sharded_to_raw(stitched, out_stitched, st_w)
    olog("Stitched PAN written to %s", out_stitched)
    outs = {"aligned": aligned_path, "stitched": out_stitched}
    if not mss2_file:
        return outs
    del stitched

    # ---- CMOS2 MSS: align against the prestitched PAN2, then stitch the
    # two aligned rasters (sample-task.sh steps 3.2 + 4)
    ms2 = raw_io.RawStrip(mss2_file, pixels_per_line)
    raw_io.check_pan_mss_sizes(p2, ms2)
    align = ShardedMssAlign(make_mss_align(
        load_band_rrc(rrc_mss2_files, band_px), slices=slices,
        n_sections=sections, threshold=threshold,
    ), mesh)
    with stage("scene_load_mss2", ms2.nbytes):
        mss2 = load_bands_sharded(ms2)
    with stage("scene_align_mss2", ms2.nbytes):
        aligned2, n_valid2, (cx2, cy2) = align(prestt[0], mss2)
        n_valid2 = to_host(n_valid2).numpy()
    del mss2, prestt
    check_registration_valid(n_valid2)
    log_band_coeffs(to_host(cx2).numpy(), to_host(cy2).numpy(), n_valid2)

    aligned2_path = build_output_file_path(
        mss2_file, IBPA_STEM_EXT, TIFF_FILE_EXT, out_dir=out_dir
    )
    with stage("scene_write_aligned2", ms2.lines * band_px * MSS_BANDS * 2):
        drain_line_sharded_to_tiff(aligned2, aligned2_path, order=order)
    olog("Aligned MSS (CMOS2) written to %s", aligned2_path)

    # the seam concat on each shard's device (both rasters are cut alike)
    foldm_half = mss_fold_half(fold_cols)
    half = band_px - foldm_half
    stitched_mss = LineSharded(mesh, [
        None if a is None else torch.cat([a[:, :half], b[:, foldm_half:]],
                                         dim=1)
        for a, b in zip(aligned.shards, aligned2.shards)
    ], 0, aligned.edges)
    del aligned, aligned2
    out_stitched_mss = out_stitched_mss or default_stitched_mss_path(out_dir)
    with stage("scene_write_stitched_mss",
               ms.lines * 2 * half * MSS_BANDS * 2):
        drain_line_sharded_to_tiff(stitched_mss, out_stitched_mss,
                                   order=order)
    olog("Stitched MSS written to %s", out_stitched_mss)
    outs.update({"aligned2": aligned2_path, "stitched_mss": out_stitched_mss})
    return outs


def load_bands(strip: raw_io.RawStrip, dev) -> torch.Tensor:
    """A RAW MSS strip (each line 4 contiguous band segments) as (4, lines,
    W/4) uint16 on ``dev``."""
    band_px = strip.pixels_per_line // MSS_BANDS
    view = strip._mm.reshape(strip.lines, MSS_BANDS, band_px).transpose(1, 0, 2)
    return torch.from_numpy(np.ascontiguousarray(view)).to(dev)

"""Streamed whole-scene pipeline: the resident scene without its memory
bound, on one device or, one section a device, over a line mesh.

Counterpart of ``opticalimageprocessor_tpu/models/scene_stream.py``.
``models/scene.run_scene`` holds the whole scene on the device (~5x the PAN
strip's bytes); this module runs the same math with device memory bounded
by one section, whatever the strip length.  It follows the reference's own
data flow (preproc.h:245-259, stitcher.h:151-156): the parameter estimates
read only sampled windows, and every whole-strip stage (RRC, the alignment
and prestitch resamples, the seam concat) is line-local up to a few halo
rows.

Phase 1, :func:`estimate_streamed`: the resident route's estimate
(:meth:`~.device_pipeline.ScenePipeline.estimate_rows`) with the strip
files as its row source, which uploads only the sampled rows (at most 5 x
16000 PAN lines of tiles and their band rows, and the stt's overlap
windows): the estimates are the resident route's, bit for bit.

Phase 2, :func:`transform_streamed`: sections of ``section_rows`` PAN
lines, each with halo rows, go through
:meth:`~.device_pipeline.ScenePipeline.transform` (kernel (a) on the bands,
one kernel-(c) and one kernel-(d) launch) and drain in line order into the
writers; the copies run off the compute stream (``io/streaming``).

The halos are clipped at the strip ends instead of zero-filled and masked:
kernels (c) and (d), and their plain versions, read 0 past the edges of
their input after the RRC, so a window that a strip end clips sees the
resident route's border rule, and an interior window reads true neighbour
rows for every tap its row bound keeps (halo = row bound + 2).  No output
row depends on its absolute index, so the section rows equal the resident
rows.

With ``mss2_file`` the prestitched PAN2 is written as ``.PRESTT.RAW``;
CMOS2's MSS is estimated against that file and streamed at row bound 6,
and the two ALIGNED.TIFFs are stream-stitched into the MSS TIFF.

``mesh=N`` streams N sections at once, section ``j`` of each step on the
mesh's device ``j`` (:class:`_Lanes`), each the single-device loop's
section, so the outputs are the single-device stream's byte for byte.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..constants import (
    IBCV_DEF_THRESHOLD,
    IBPA_STEM_EXT,
    MSS_BANDS,
    PIXELS_PER_LINE,
    PRESTT_STEM_EXT,
    TIFF_FILE_EXT,
)
from ..formats.naming import build_output_file_path
from ..io import raw as raw_io
from ..io import tiff as tiff_io
from ..io.raw import RawStrip
from ..io.streaming import HostDeviceCopies, window
from ..parallel.mesh import LINE_AXIS, LineMesh, resolve_mesh
from ..utils.logging import device_profile, olog, stage, to_host
from .device_pipeline import (
    MssAlign,
    ScenePipeline,
    StripRows,
    check_registration_valid,
    check_stt_valid,
)
from .scene import (
    check_tiff_output,
    default_stitched_mss_path,
    default_stitched_path,
    is_tiff,
    load_band_rrc,
    log_band_coeffs,
    log_scene_params,
    mss_fold_half,
    resolve_device,
    scene_pipeline,
)

_STITCH_ROWS = 2048   # MSS rows a step of the stream-stitch


def band_rows(strip: RawStrip, a: int, b: int) -> np.ndarray:
    """Band rows ``[a, b)`` of a RAW MSS strip as a (4, b - a, W/4) view."""
    band_px = strip.pixels_per_line // MSS_BANDS
    return strip._mm[a:b].reshape(b - a, MSS_BANDS, band_px).transpose(1, 0, 2)


def _upload(a: np.ndarray, dev) -> torch.Tensor:
    """A host copy of ``a`` (a memory-map view is read-only) on ``dev``."""
    return torch.from_numpy(np.array(a)).to(dev)


class _FileRows(StripRows):
    """A RAW strip file as a row source (its band rows with ``bands``):
    each plan entry's rows uploaded to ``device`` as they are taken, so the
    host holds one entry's rows at a time."""

    def __init__(self, strip: RawStrip, device: torch.device,
                 bands: bool = False):
        super().__init__(band_rows(strip, 0, strip.lines) if bands
                         else strip._mm)
        self.device = device

    def fetch(self, plan):
        return (_upload(v, self.device) for v in super().fetch(plan))


def estimate_streamed(pipe: ScenePipeline, p1: RawStrip, p2: RawStrip,
                      ms: RawStrip, device):
    """Phase 1 on the strip files: -> ``(cx (4, 2), cy (4, 3), n_valid (4,),
    raw_dx, raw_dy, n_stt)``, bit-identical to ``pipe.estimate`` on the
    resident strips (only the sampled rows go to ``device``)."""
    dev = torch.device(device)
    return pipe.estimate_rows(_FileRows(p1, dev), _FileRows(p2, dev),
                              _FileRows(ms, dev, bands=True), [dev])


def estimate_mss2_streamed(align: MssAlign, pan_c: RawStrip,
                           ms2: RawStrip, device):
    """MSS2's registration against the corrected PAN2 file (the PRESTT
    strip): -> ``(cx, cy, n_valid)``, bit-identical to :class:`MssAlign`'s
    on the resident rasters (the band tiles are RRC'd as they are cut)."""
    dev = torch.device(device)
    return align.register(_FileRows(pan_c, dev),
                          _FileRows(ms2, dev, bands=True), [dev], raw=True)


def _check_section_rows(section_rows: int) -> None:
    if section_rows <= 0 or section_rows % MSS_BANDS:
        raise ValueError("section_rows must be a multiple of 4")


def _stream(n, load, run, write) -> None:
    """The streamed loop: step k's work and drain are enqueued
    (``run``), then step k + 1's host read and upload are issued and step
    k - 1's drain is written, so the devices work on k while the host reads
    k + 1 and writes k - 1."""
    nxt = load(0)
    pending = None
    for k in range(n):
        cur, nxt = nxt, None
        drain = run(cur)
        if k + 1 < n:
            nxt = load(k + 1)
        if pending is not None:
            write(pending)
        pending = drain
    write(pending)


class _Lanes:
    """The devices a streamed loop runs on: one, or a line mesh's, each
    with its own copy of the module and its own :class:`HostDeviceCopies`.
    A step is ``len(devices)`` consecutive sections, section ``j`` of it on
    device ``j`` (JAX's ``--stream --mesh N``: N single-device-shaped
    sections at once, no collectives), so every section is the
    single-device loop's section, computed alike."""

    def __init__(self, module, device):
        if isinstance(device, LineMesh):
            devs = device.devices
            own = next(module.buffers()).device
            mods = {d: module if d == own else copy.deepcopy(module).to(d)
                    for d in dict.fromkeys(devs)}
        else:
            devs = [torch.device(device)]
            mods = {devs[0]: module}
        self.devices = devs
        self.modules = [mods[d] for d in devs]
        self.copies = [HostDeviceCopies(d) for d in devs]

    def run(self, n, load, step, write) -> int:
        """Stream ``n`` sections: ``load(k, lane)`` -> the section's inputs,
        ``step(lane, *inputs)`` -> its device outputs, ``write(*outputs)``
        on the host, in section order.  Returns ``n``."""
        width = len(self.devices)

        def load_step(g):
            return [(j, load(k, j))
                    for j, k in enumerate(range(g * width,
                                                min((g + 1) * width, n)))]

        def run(cur):
            return [self.copies[j].download(step(j, *inputs))
                    for j, inputs in cur]

        def write_step(drains):
            for d in drains:
                write(*d.wait())

        _stream(-(-n // width), load_step, run, write_step)
        return n


def _write_tiff_rows(writer, block: np.ndarray) -> None:
    """TiffStripWriter keeps a view of a block's rows past its last whole
    strip; a drained block's memory is reused two sections on, so hand it
    a copy then."""
    if block.shape[0] % writer.rows_per_strip:
        block = block.copy()
    writer.write_rows(block)


def transform_streamed(pipe: ScenePipeline, p1: RawStrip, p2: RawStrip,
                       ms: RawStrip, cx, cy, raw_dx, raw_dy, write_aligned,
                       write_stitched, write_prestt=None,
                       section_rows: int = 4096, device="cuda") -> int:
    """Phase 2: ``pipe.transform`` section by section.  Each section is
    ``section_rows`` PAN lines (the last one may be shorter) with
    ``prestt_row_bound + 2`` halo rows of PAN1 and PAN2 and ``row_bound +
    2`` of the bands, clipped at the strip ends; its payload rows go, in
    line order, to ``write_aligned`` ((rows/4, W/4, 4)), ``write_stitched``
    and, where ``pipe.return_prestt``, ``write_prestt`` (host arrays valid
    during the call).  ``device``: one device, or a
    :class:`~..parallel.mesh.LineMesh` whose devices take consecutive
    sections in turn.  Returns the number of sections."""
    _check_section_rows(section_rows)
    # host floats once, not a device readback a section
    raw_dx, raw_dy = float(to_host(raw_dx)), float(to_host(raw_dy))
    halo_p = pipe.prestt_row_bound + 2
    halo_b = pipe.row_bound + 2
    lanes = _Lanes(pipe, device)
    coeffs = [(cx.to(d), cy.to(d)) for d in lanes.devices]
    n = -(-p1.lines // section_rows)

    def load(k, j):
        off = k * section_rows
        lines = min(section_rows, p1.lines - off)
        a, b, top, _ = window(p1.lines, off, lines, halo_p)
        ab, bb, top_b, _ = window(ms.lines, off // MSS_BANDS,
                                  lines // MSS_BANDS, halo_b)
        up = lanes.copies[j].upload(
            [p1._mm[a:b], p2._mm[a:b], band_rows(ms, ab, bb)])
        return up, lines, top, top_b

    def step(j, up, lines, top, top_b):
        pan1, pan2, bands = up.get()
        aligned, *pans = lanes.modules[j].transform(
            pan1, pan2, bands, *coeffs[j], raw_dx, raw_dy)
        lb = lines // MSS_BANDS
        return [aligned[top_b:top_b + lb],
                *(t[top:top + lines] for t in pans)]

    def write(aligned, stitched, prestt=None):
        write_aligned(aligned)
        write_stitched(stitched)
        if prestt is not None:
            write_prestt(prestt)

    return lanes.run(n, load, step, write)


def transform_mss2_streamed(align: MssAlign, ms2: RawStrip, cx, cy,
                            write_aligned, section_rows: int = 4096,
                            device="cuda") -> int:
    """MSS2's alignment in sections of ``section_rows / 4`` band rows with
    ``row_bound + 2`` halo rows (row bound 6: halo 8), each through
    :meth:`MssAlign.transform` (kernel (a), one kernel-(c) launch), on one
    device or a line mesh's in turn.  Returns the number of sections."""
    _check_section_rows(section_rows)
    halo = align.row_bound + 2
    rows = section_rows // MSS_BANDS
    lanes = _Lanes(align, device)
    coeffs = [(cx.to(d), cy.to(d)) for d in lanes.devices]
    n = -(-ms2.lines // rows)

    def load(k, j):
        off = k * rows
        lines = min(rows, ms2.lines - off)
        a, b, top, _ = window(ms2.lines, off, lines, halo)
        return lanes.copies[j].upload([band_rows(ms2, a, b)]), lines, top

    def step(j, up, lines, top):
        return [lanes.modules[j].transform(up.get()[0], *coeffs[j])[
            top:top + lines]]

    return lanes.run(n, load, step, write_aligned)


def run_scene_streamed(*args, profile_dir: str = "", **kw):
    """Run the streamed scene (see :func:`_run_scene_streamed`); with
    ``profile_dir`` the whole run is wrapped in a torch.profiler trace
    (utils.logging.device_profile)."""
    with device_profile(profile_dir, kw.get("device", "cuda")):
        return _run_scene_streamed(*args, **kw)


def _run_scene_streamed(
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
    section_rows: int = 4096,
    device: str | torch.device = "cuda",
    mesh: int | LineMesh = 0,
):
    """The streamed scene: the outputs of ``run_scene`` with the same
    arguments, byte for byte, with device memory bounded by a few
    ``section_rows``-line sections.  Returns the output paths (with
    ``mss2_file`` also ``prestt``, the prestitched PAN2 RAW).

    ``mesh=N`` (``scene --stream --mesh N``) runs N sections at once, one
    on each device of an N-device line mesh, each the single-device loop's
    section (no collectives), so the outputs are the single-device
    stream's byte for byte.  The estimate, which reads sampled windows
    only, runs on the mesh's first device."""
    from ..parallel.distributed import process_count

    if mesh and process_count() > 1:
        # the streamed mesh runs whole sections in one process; a mesh
        # spanning processes cannot give them (JAX reads them through
        # np.asarray, models/scene_stream.py:762)
        raise RuntimeError(
            f"scene --stream --mesh under {process_count()} processes: the "
            "streamed route runs in one process (run scene --mesh N "
            "without --stream across processes)")
    if mss2_file:
        check_tiff_output(out_stitched_mss)
    _check_section_rows(section_rows)
    mesh_obj = resolve_mesh(mesh, device)
    lanes = mesh_obj or device
    dev = mesh_obj.devices[0] if mesh_obj else resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    band_px = pixels_per_line // MSS_BANDS
    p1 = raw_io.RawStrip(pan1_file, pixels_per_line)
    p2 = raw_io.RawStrip(pan2_file, pixels_per_line)
    ms = raw_io.RawStrip(mss_file, pixels_per_line)
    if p1.nbytes != p2.nbytes:
        raise ValueError("PAN1 size doesn't match PAN2 size")
    raw_io.check_pan_mss_sizes(p1, ms)
    olog("Streamed scene: PAN %d lines, MSS %d lines, %d-line sections.",
         p1.lines, ms.lines, section_rows)
    if mesh_obj:
        olog("Streamed scene sharded over %d-device '%s' mesh (%d sections "
             "of %d PAN lines in flight).", len(mesh_obj), LINE_AXIS,
             len(mesh_obj), section_rows)

    pipe = scene_pipeline(
        rrc_pan1, rrc_pan2, rrc_mss_files, pixels_per_line, slices,
        sections, fold_cols, stt_sections, threshold, stt_threshold,
        stt_max_delta_y, return_prestt=bool(mss2_file),
    ).to(dev)
    with stage("stream_estimate", 0):
        cx, cy, n_valid, raw_dx, raw_dy, n_stt = estimate_streamed(
            pipe, p1, p2, ms, dev)
        n_valid = to_host(n_valid).numpy()
        n_stt = int(to_host(n_stt))
    check_registration_valid(n_valid)
    check_stt_valid(n_stt)
    dxs, dys = pipe.clamp_stt(raw_dx, raw_dy)
    log_scene_params(
        (to_host(cx).numpy(), to_host(cy).numpy(), dxs, dys, raw_dx, raw_dy),
        n_valid, n_stt,
    )

    order = [2, 1, 0, 3] if bgr_tiff_order else [0, 1, 2, 3]
    aligned_path = build_output_file_path(
        mss_file, IBPA_STEM_EXT, TIFF_FILE_EXT, out_dir=out_dir
    )
    st_w = 2 * (pixels_per_line - pipe.fold)
    out_stitched = out_stitched or default_stitched_path(out_dir, st_w)
    aligned_w = tiff_io.TiffStripWriter(
        aligned_path, band_px, ms.lines, samples=MSS_BANDS
    )
    if is_tiff(out_stitched):
        stitched_w = tiff_io.TiffStripWriter(out_stitched, st_w, p1.lines,
                                             samples=1)
        write_stitched = lambda blk: _write_tiff_rows(stitched_w, blk)  # noqa: E731
    else:
        stitched_w = raw_io.RawStripWriter(out_stitched, st_w)
        write_stitched = stitched_w.write_lines
    prestt_path, prestt_w = "", None
    if mss2_file:
        prestt_path = build_output_file_path(
            pan2_file, PRESTT_STEM_EXT, out_dir=out_dir
        )
        prestt_w = raw_io.RawStripWriter(prestt_path, pixels_per_line)
    with stage("stream_transform", p1.nbytes * 2 + ms.nbytes):
        transform_streamed(
            pipe, p1, p2, ms, cx, cy, raw_dx, raw_dy,
            lambda blk: aligned_w.write_rows(blk[:, :, order]),
            write_stitched, prestt_w.write_lines if prestt_w else None,
            section_rows, lanes,
        )
    for w in (aligned_w, stitched_w, prestt_w):
        if w is not None:
            w.close()
    olog("Aligned MSS written to %s", aligned_path)
    olog("Stitched PAN written to %s", out_stitched)
    outs = {"aligned": aligned_path, "stitched": out_stitched}
    if not mss2_file:
        return outs
    outs["prestt"] = prestt_path

    # ---- CMOS2 MSS against the prestitched PAN2 (sample-task steps 3.2+4)
    ms2 = raw_io.RawStrip(mss2_file, pixels_per_line)
    raw_io.check_pan_mss_sizes(p2, ms2)
    align = MssAlign(
        load_band_rrc(rrc_mss2_files, band_px), slices=slices,
        n_sections=sections, threshold=threshold,
    ).to(dev)
    with stage("stream_estimate_mss2", 0):
        cx2, cy2, n_valid2 = estimate_mss2_streamed(
            align, raw_io.RawStrip(prestt_path, pixels_per_line), ms2, dev)
        n_valid2 = to_host(n_valid2).numpy()
    check_registration_valid(n_valid2)
    log_band_coeffs(to_host(cx2).numpy(), to_host(cy2).numpy(), n_valid2)

    aligned2_path = build_output_file_path(
        mss2_file, IBPA_STEM_EXT, TIFF_FILE_EXT, out_dir=out_dir
    )
    aligned2_w = tiff_io.TiffStripWriter(
        aligned2_path, band_px, ms2.lines, samples=MSS_BANDS
    )
    with stage("stream_transform_mss2", ms2.nbytes):
        transform_mss2_streamed(
            align, ms2, cx2, cy2,
            lambda blk: aligned2_w.write_rows(blk[:, :, order]),
            section_rows, lanes,
        )
    aligned2_w.close()
    olog("Aligned MSS (CMOS2) written to %s", aligned2_path)

    # stream-stitch the aligned pair from the two TIFFs
    foldm_half = mss_fold_half(fold_cols)
    half = band_px - foldm_half
    out_stitched_mss = out_stitched_mss or default_stitched_mss_path(out_dir)
    wmss = tiff_io.TiffStripWriter(
        out_stitched_mss, 2 * half, ms.lines, samples=MSS_BANDS
    )
    with stage("stream_stitch_mss", ms.lines * 2 * half * MSS_BANDS * 2):
        for b1, b2 in zip(
            tiff_io.iter_tiff_rows(aligned_path, _STITCH_ROWS),
            tiff_io.iter_tiff_rows(aligned2_path, _STITCH_ROWS),
        ):
            wmss.write_rows(
                np.concatenate([b1[:, :half], b2[:, foldm_half:]], axis=1)
            )
    wmss.close()
    olog("Stitched MSS written to %s", out_stitched_mss)
    outs.update({"aligned2": aligned2_path, "stitched_mss": out_stitched_mss})
    return outs

"""Dual-CMOS prestitch over the line mesh (the CLI's ``prestitch --mesh
N``).

Counterpart of ``opticalimageprocessor_tpu/models/sharded_prestitch.py``:
the user contract of :class:`~.stitcher.Stitcher` in fast mode -- the stt
estimate on the uncorrected strips' overlap (main.cpp:280-284,
stitcher.h:148-201) with its threshold and max-dy filter and its "No valid
delta value found" error, and a ``.PRESTT.RAW`` of the fast route's
semantics -- run over an N-device line mesh
(``parallel/sharded.make_prestitch_step``):

* the PAN strips go shard by shard from the memory-mapped RAW files to the
  devices (under several processes, each process reads its own shards);
* the RRC runs on each shard (kernel (a)); the ``.RRC.RAW`` files are
  drained shard by shard in line order (the reference's DoRRC files,
  stitcher.h:141-146);
* the constant-shift resample runs on each shard with its neighbours'
  halo rows (kernel (e)), then drains to ``.PRESTT.RAW``;
* under several processes each process writes its own rows of each file
  (``parallel/distributed`` drains).
"""

from __future__ import annotations

import os

import torch

from ..constants import (
    PIXELS_PER_LINE,
    PRESTT_STEM_EXT,
    RRC_STEM_EXT,
    STT_DEF_EDGECOLS,
    STT_DEF_MAXDELTAY,
    STT_DEF_PHCTHRHLD,
)
from ..formats.naming import build_output_file_path
from ..io import raw as raw_io
from ..parallel.distributed import drain_line_sharded_to_raw
from ..parallel.mesh import LINE_AXIS, LineMesh, resolve_mesh
from ..parallel.sharded import ingest_line_sharded, make_prestitch_step
from ..utils.logging import olog, stage
from .device_pipeline import stt_offsets
from .scene import load_rrc
from .stitcher import Stitcher, average_valid_deltas


def _drain_to_raw(arr, path: str, pixels_per_line: int, stage_name: str,
                  total: int) -> str:
    """Write a line-sharded strip to a RAW file shard by shard."""
    with stage(stage_name, total * pixels_per_line * 2):
        drain_line_sharded_to_raw(arr, path, pixels_per_line, total)
    return path


def run_sharded_prestitch(
    pan1: str,
    pan2: str,
    rrc1: str = "",
    rrc2: str = "",
    n_devices: int | LineMesh = 1,
    sections: int = 10,
    line_per_section: int = 16000,
    overlap_cols: int = 200,
    threshold: float = STT_DEF_PHCTHRHLD,
    max_delta_y: float = STT_DEF_MAXDELTAY,
    edge_cols: int = STT_DEF_EDGECOLS,
    do_rrc: bool = True,
    only_calculate: bool = False,
    out_dir: str | None = None,
    pixels_per_line: int = PIXELS_PER_LINE,
    device: str | torch.device = "cuda",
):
    """Run the sharded prestitch; returns (delta_x, delta_y, prestt_path,
    None with ``only_calculate``).  ``n_devices``: the mesh, a device count
    or an explicit :class:`~..parallel.mesh.LineMesh`."""
    mesh_dev = (n_devices.first if isinstance(n_devices, LineMesh)
                else device)
    # the host Stitcher's geometry and size checks
    st = Stitcher(pan1, pan2, rrc1, rrc2, sections, line_per_section,
                  overlap_cols, out_dir=out_dir,
                  pixels_per_line=pixels_per_line, fast=True,
                  device=mesh_dev)
    mesh = resolve_mesh(n_devices, device)
    olog("Sharded prestitch over %d-device '%s' mesh.", len(mesh), LINE_AXIS)

    p1 = raw_io.RawStrip(pan1, pixels_per_line)
    p2 = raw_io.RawStrip(pan2, pixels_per_line)
    with stage("shard_ingest", p1.nbytes + p2.nbytes):
        pan1_arr = ingest_line_sharded(mesh, p1._mm)
        pan2_arr = ingest_line_sharded(mesh, p2._mm)

    correlate, rrc_fn, remap = make_prestitch_step(
        mesh, sections, line_per_section, overlap_cols, edge_cols)

    # CalcSttParameters on the uncorrected strips (reference order)
    offs = stt_offsets(st.lines_pan, sections, line_per_section)
    with stage("stt_correlate_sharded"):
        dxs, dys, rss = correlate(pan1_arr, pan2_arr, real_lines=p1.lines)
    delta_x, delta_y, _resp = average_valid_deltas(
        dxs, dys, rss, offs, threshold, max_delta_y)
    if only_calculate:
        return delta_x, delta_y, None

    # DoRRC (sharded) + drain the .RRC.RAW intermediates
    prestt_src, prestt_src_path = pan2_arr, pan2
    if do_rrc:
        for src_path, par, arr in ((pan1, rrc1, pan1_arr),
                                   (pan2, rrc2, pan2_arr)):
            if not par:
                raise ValueError("RRC parameter file needed")
            corrected = rrc_fn(arr, load_rrc(par, pixels_per_line))
            dst = build_output_file_path(src_path, RRC_STEM_EXT,
                                         out_dir=out_dir)
            _drain_to_raw(corrected, dst, pixels_per_line,
                          f"rrc_sharded:{os.path.basename(src_path)}",
                          p2.lines)
            if src_path == pan2:
                prestt_src, prestt_src_path = corrected, dst
            del corrected
    del pan1_arr

    # PreStitch (sharded constant-shift resample) + drain
    out_path = build_output_file_path(prestt_src_path, PRESTT_STEM_EXT,
                                      out_dir=out_dir)
    with stage("prestitch_sharded", p2.nbytes):
        prestt = remap(prestt_src, delta_x, delta_y)
    _drain_to_raw(prestt, out_path, pixels_per_line, "write_prestt",
                  p2.lines)
    olog("Pre-stitched PAN2 (sharded) written to file '%s'.", out_path)
    return delta_x, delta_y, out_path

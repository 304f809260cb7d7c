"""Route ``dual``: the reference's whole sample task on one card,
``models/device_pipeline.DualScenePipeline.forward`` on device-resident
RAW strips (PAN1, PAN2, CMOS1's and CMOS2's MSS), one scene a call, each
ending in ``torch.cuda.synchronize()``: the scene, CMOS2's MSS aligned
against the prestitched PAN2, and the two aligned MSS stitched at the
seam.

A kept scene's rasters stay on the device (references to the forward's
own outputs, no copy) until the judge reads them."""

from __future__ import annotations

from opticalimageprocessor_tpu_torch.models.device_pipeline import (
    DualScenePipeline,
    MssAlign,
)

from .resident import crosspower_shape, make_pipeline


def make_dual(cfg, tables) -> DualScenePipeline:
    """The scene's pipeline as route ``resident`` builds it, returning the
    prestitched PAN2, and CMOS2's align step as the ``scene --mss2``
    command builds it: the scene's slices, row blocks and threshold, at
    MSS2's own row bound."""
    pipe = make_pipeline(cfg, tables)
    pipe.return_prestt = True
    align = MssAlign(tables.mss2, slices=cfg["slices"],
                     n_sections=cfg["sections"], threshold=cfg["threshold"],
                     row_bound=cfg["mss2_row_bound"],
                     col_block=cfg["col_block"], col_halo=cfg["col_halo"])
    return DualScenePipeline(pipe, align, cfg["fold_cols"])


class Route:
    def __init__(self, cfg, tables, pool, device, timer):
        self.pool = pool
        self.pipe = make_dual(cfg, tables).to(device)
        self.kept = {}
        lines, width = pool[0].pan1.shape
        self.shapes = {
            "crosspower": crosspower_shape(cfg, lines, width),
            "stitch_tail": (lines, width, cfg["fold_cols"] // 2),
        }

    def run(self, j: int, slot):
        """One dual scene on pool scene ``j``; its rasters are kept in
        ``slot`` unless that is None.  -> the estimate (cx, cy, n_valid,
        raw_dx, raw_dy, n_stt, cx2, cy2, n_valid2)."""
        s = self.pool[j]
        (aligned, stitched, aligned2, stitched_mss, n_valid, n_stt,
         n_valid2, params, (cx2, cy2)) = self.pipe(s.pan1, s.pan2, s.mss,
                                                   s.mss2)
        cx, cy, _dxs, _dys, raw_dx, raw_dy = params
        if slot is not None:
            self.kept[slot] = (aligned, stitched, aligned2, stitched_mss)
        return cx, cy, n_valid, raw_dx, raw_dy, n_stt, cx2, cy2, n_valid2

    def rasters(self, slot):
        return self.kept[slot]

    def release(self):
        """Drop the program's state; the kept rasters stay."""
        del self.pipe

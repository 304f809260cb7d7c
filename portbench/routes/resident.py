"""Route ``resident``: the ``scene`` command's device pipeline,
``models/device_pipeline.ScenePipeline.forward``, on device-resident RAW
strips, one scene a call, each ending in ``torch.cuda.synchronize()``.

A kept scene's rasters stay on the device (references to the forward's
own outputs, no copy) until the judge reads them."""

from __future__ import annotations

from opticalimageprocessor_tpu_torch.models.device_pipeline import (
    ScenePipeline,
)

from .. import reference as ref


def make_pipeline(cfg, tables) -> ScenePipeline:
    """The scene's pipeline as the ``scene`` command builds it from ``-c
    fold_cols`` (``models/scene.scene_pipeline``), with the registration's
    row blocks and the stt windows as the configuration states them."""
    return ScenePipeline(
        tables.pan1, tables.pan2, tables.mss, slices=cfg["slices"],
        n_sections=cfg["sections"], fold=cfg["fold_cols"] // 2,
        row_bound=cfg["row_bound"], stt_sections=cfg["stt_sections"],
        stt_lines=cfg["stt_lines"], overlap_cols=cfg["fold_cols"],
        col_block=cfg["col_block"], col_halo=cfg["col_halo"],
        stt_threshold=cfg["stt_threshold"], threshold=cfg["threshold"],
        prestt_row_bound=cfg["prestt_row_bound"],
    )


def crosspower_shape(cfg, lines: int, width: int):
    """(tiles, bands, M, keep, m, n, wx) of the scene's one windowed
    cross-power."""
    g = ref.reg_geometry(lines, width, cfg["slices"], cfg["sections"])
    wx = 2 * min(64, (g.cols - 1) // 2) + 1
    return (g.slices * g.n_sections, ref.MSS_BANDS, g.corr_rows,
            g.cols // 2 + 1, g.brows, g.bcols, wx)


class Route:
    def __init__(self, cfg, tables, pool, device, timer):
        self.pool = pool
        self.pipe = make_pipeline(cfg, tables).to(device)
        self.kept = {}
        lines, width = pool[0].pan1.shape
        self.shapes = {
            "crosspower": crosspower_shape(cfg, lines, width),
            "stitch_tail": (lines, width, cfg["fold_cols"] // 2),
        }
        if timer.spans:
            # spans around the calls forward makes (instance attributes
            # shadow the methods; forward itself is unchanged)
            self.pipe.estimate = timer.wrap("estimate", self.pipe.estimate)
            self.pipe.transform = timer.wrap("transform", self.pipe.transform)

    def run(self, j: int, slot):
        """One scene on pool scene ``j``; its rasters are kept in ``slot``
        unless that is None.  -> the estimate (cx, cy, n_valid, raw_dx,
        raw_dy, n_stt)."""
        s = self.pool[j]
        aligned, stitched, n_valid, n_stt, params = self.pipe(
            s.pan1, s.pan2, s.mss)
        cx, cy, _dxs, _dys, raw_dx, raw_dy = params
        if slot is not None:
            self.kept[slot] = (aligned, stitched)
        return cx, cy, n_valid, raw_dx, raw_dy, n_stt

    def rasters(self, slot):
        return self.kept[slot]

    def release(self):
        """Drop the program's state; the kept rasters stay."""
        del self.pipe

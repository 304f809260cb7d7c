"""The least time of the parity scene's section remaps, kernel (f)'s work,
counted from the scene's shapes and the reference's two section loops,
never from the kernel that does it.

Each ``cv::remap`` call of a section reads its (rows, W) uint16 section
once and writes its kept (count, W) rows once, beside the plan's 28 bytes
a column (the first tap, 4 column weights, the float64 row offset); its
operations are 34 float32 operations an output pixel (16 multiply-adds of
the 4 x 4 taps, the 16 weight products, the coordinate and the rounding)
at the unfused float32 rate, half of ``roofline.F32_FLOPS``, as the
repository's ``chip_smoke.py`` (``remap_section_bound``) counts them.  The
calls run one after another, so their least times add up.
"""

from __future__ import annotations

from .roofline import F32_FLOPS, bound_ms

SECTION_OPS = 34            # float32 operations an output pixel
MIN_PROCESS_LINES = 1500    # IBPA_MIN_PROCESSLINES (oipshared.h)


def section_calls(cfg, pan_shape, mss_shape, dy: float):
    """The (rows read, rows written, width) of every section remap of one
    scene: PreStitch's sections of ``remap_section_rows`` rows at the
    vertical shift ``dy`` (each between its upper and bottom cut, the
    first keeping its upper cut), the rolling-buffer window of ``2 * bcut
    + 8`` rows where the strip has 2 or more sections, then the alignment's
    sections of ``line_per_section`` lines less ``section_overlap``, one a
    band."""
    lines, width = pan_shape
    bands, blines, bwidth = mss_shape
    dy = float(dy)
    rows_a_section = cfg["remap_section_rows"]
    ucut = 0 if dy >= 0.0 else int(-dy) + 1
    bcut = int(dy) + 1 if dy >= 0.0 else 0
    pan = []
    offset = 0
    while True:
        rows = min(rows_a_section, lines - offset)
        if rows <= ucut + bcut:
            break
        pan.append([rows, rows - bcut - (ucut if pan else 0), width])
        offset += rows - ucut - bcut
    if bcut and len(pan) == 1:
        pan[0][1] += bcut
    elif bcut and pan:
        pan.append([min(rows_a_section, 2 * bcut + 8), bcut, width])
    lps, overlap = cfg["line_per_section"], cfg["section_overlap"]
    mss = []
    offset = 0
    while True:
        rows = min(blines - offset, lps)
        if rows < MIN_PROCESS_LINES:
            break
        mss += [(rows, rows - overlap, bwidth)] * bands
        offset += lps - overlap
    return [tuple(c) for c in pan] + mss


def section_bound_ms(calls) -> float:
    """The least ms of the calls ``(rows, count, width)``, each bounded by
    its bytes or its operations, summed."""
    return sum(bound_ms(2 * rows * width + 2 * count * width + 28 * width,
                        operations=(SECTION_OPS * count * width,
                                    F32_FLOPS / 2))
               for rows, count, width in calls)

"""The plain reference of the dual scene's second half: what
``reference.py`` lacks to judge the whole sample task.

The prestitched PAN2 (the reference's ``*.RRC.PRESTT.RAW``: RRC(PAN2)
translated by the clamped stt deltas over its full width, of which the
stitched PAN keeps the columns right of the fold), the registration of
CMOS2's MSS against it (``reference.register`` with an identity PAN table:
the prestitched PAN is already corrected) and the seam of the two aligned
MSS rasters.  Plain PyTorch on ``reference.py``'s functions, under the
same precision (``reference.Precision``): it imports nothing of the port
and nothing of the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import reference as ref


def prestt(pan2, kb2, dx: float, dy: float, block: int, halo: int,
           prec: ref.Precision = ref.Precision(), rows_per_block: int = 8192):
    """RRC(``pan2``) (L, W) translated by (``dx``, ``dy``) over its full
    width, rows past the strip reading 0, as ``reference.stitch``
    translates it (in blocks of ``rows_per_block`` output rows) ->
    (L, W) uint16."""
    t = prec.resample
    rows, width = pan2.shape
    f32 = torch.float32
    dx_t = torch.tensor(dx, dtype=f32, device=pan2.device)
    dy_t = torch.tensor(dy, dtype=f32, device=pan2.device)
    tap0, w = ref._col_taps(torch.stack([4.0 * dx_t, torch.zeros_like(dx_t)]),
                            width, block, halo)
    fl = torch.floor(dy_t)
    iy0 = int(fl)
    wys = ref._cubic_weights(dy_t - fl)
    out = torch.empty((rows, width), dtype=torch.uint16, device=pan2.device)
    for r0 in range(0, rows, rows_per_block):
        r1 = min(rows, r0 + rows_per_block)
        # output row r reads PAN2 rows r + iy0 - 1 .. r + iy0 + 2
        s0, s1 = r0 + iy0 - 1, r1 + iy0 + 2
        a = min(max(s0, 0), rows)
        b = max(min(s1, rows), a)
        colg = ref._col_interp(ref.rrc(pan2[a:b], *kb2, prec), tap0, w, t)
        padded = F.pad(colg, (0, 0, a - s0, s1 - b))
        del colg
        acc = torch.zeros((r1 - r0, width), dtype=t, device=pan2.device)
        for k in range(4):
            acc = acc + padded[k:k + r1 - r0] * wys[k].to(t)
        del padded
        out[r0:r1] = ref._round_u16(acc)
    return out


def identity_table(width: int, device):
    """The RRC table that leaves a corrected strip as it is: gain 1, bias
    0 (exact through the RRC's float64, or float32, cast)."""
    f64 = torch.float64
    return (torch.ones(width, dtype=f64, device=device),
            torch.zeros(width, dtype=f64, device=device))


def register2(prestt_pan, mss2, mss2_kb, cfg,
              prec: ref.Precision = ref.Precision(), responses=None):
    """CMOS2's RAW ``mss2`` (4, L/4, W/4) registered against the
    prestitched PAN2, as the configuration states the registration ->
    cx2 (4, 2), cy2 (4, 3), n_valid2 (4,)."""
    ident = identity_table(prestt_pan.shape[1], prestt_pan.device)
    return ref.register(prestt_pan, mss2, ident, mss2_kb, cfg["slices"],
                        cfg["sections"], cfg["threshold"], prec,
                        responses=responses)


def mss_fold_half(fold_cols: int) -> int:
    """Band columns each aligned MSS loses at the seam: a quarter of PAN's
    ``fold_cols`` (sample-task.sh FOLDCOL_MSS), half a side."""
    return max(1, fold_cols // ref.MSS_BANDS // 2)


def seam(aligned, aligned2, fold_cols: int):
    """CMOS1's aligned MSS (rows, W/4, 4) less its right fold half ++
    CMOS2's less its left one."""
    fh = mss_fold_half(fold_cols)
    return torch.cat([aligned[:, :aligned.shape[1] - fh], aligned2[:, fh:]],
                     dim=1)

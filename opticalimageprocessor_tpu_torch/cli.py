"""Command-line interface of the PyTorch/CUDA port: the ``scene``
subcommand, with the flags, defaults, validation and exit codes of the
JAX package's ``oiptpu scene`` (254 usage error / 2 runtime error / 1
unknown; reference main.cpp:320-343) plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain PyTorch versions)::

    python -m opticalimageprocessor_tpu_torch.cli scene \\
        --pan1 P1.RAW --pan2 P2.RAW --mss M.RAW [--rrc-pan1 ..] [-c 200] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

from opticalimageprocessor_tpu import constants as C
# the reference CLI's usage-error type, parse-time file check and stage
# report (its module imports no jax)
from opticalimageprocessor_tpu.cli import (
    UsageError,
    _print_stage_report,
    _require_file,
)


def _scene(argv) -> int:
    p = argparse.ArgumentParser(
        prog="oiptorch scene",
        description=(
            "Whole-scene pipeline: RRC + registration + alignment + "
            "prestitch + stitch on one device (fast-mode semantics; the "
            "scene must fit in device memory)"
        ),
    )
    p.add_argument("--pan1", required=True, help="CMOS1 PAN raw image")
    p.add_argument("--pan2", required=True, help="CMOS2 PAN raw image")
    p.add_argument("--mss", required=True, help="CMOS1 MSS raw image")
    p.add_argument("--rrc-pan1", default="", help="RRC CSV for PAN1")
    p.add_argument("--rrc-pan2", default="", help="RRC CSV for PAN2")
    for b in range(1, 5):
        p.add_argument(f"--rrc-msb{b}", default="",
                       help=f"RRC CSV for CMOS1 MSS band #{b}")
    p.add_argument("--slices", type=int, default=C.IBCV_DEF_SLICES)
    p.add_argument("--ibc-sections", type=int, default=0,
                   help="registration sections (0 = auto from strip length)")
    p.add_argument("-c", "--fold-cols", type=int, default=C.STT_DEF_OVERLAPPX)
    p.add_argument("-s", "--stt-sections", type=int, default=C.STT_DEF_SECTIONS)
    p.add_argument("--ibc-threshold", type=float, default=C.IBCV_DEF_THRESHOLD)
    p.add_argument("--stt-threshold", type=float, default=C.STT_DEF_PHCTHRHLD)
    p.add_argument("--stt-maxdeltay", type=float, default=C.STT_DEF_MAXDELTAY)
    p.add_argument("-o", "--out", default="",
                   help="stitched PAN output (.TIFF or .RAW)")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    a = p.parse_args(argv)
    if a.fold_cols < 2:
        raise UsageError("fold column value too small")
    if not (0.0 <= a.ibc_threshold < 1.0) or not (
        0.0 <= a.stt_threshold < 1.0
    ):
        raise UsageError("invalid threshold value")
    rrc_mss = (a.rrc_msb1, a.rrc_msb2, a.rrc_msb3, a.rrc_msb4)
    for opt, f in (
        ("--pan1", a.pan1), ("--pan2", a.pan2), ("--mss", a.mss),
        ("--rrc-pan1", a.rrc_pan1), ("--rrc-pan2", a.rrc_pan2),
        *[(f"--rrc-msb{i}", f) for i, f in enumerate(rrc_mss, 1)],
    ):
        _require_file(f, opt)

    from .models.scene import run_scene

    run_scene(
        a.pan1, a.pan2, a.mss, a.rrc_pan1, a.rrc_pan2, rrc_mss,
        slices=a.slices, sections=a.ibc_sections or None,
        fold_cols=a.fold_cols, stt_sections=a.stt_sections,
        threshold=a.ibc_threshold, stt_threshold=a.stt_threshold,
        stt_max_delta_y=a.stt_maxdeltay, out_stitched=a.out,
        out_dir=a.out_dir, device=a.device,
    )
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        if not argv or argv[0] != "scene":
            raise UsageError("the port offers the 'scene' subcommand only")
        rc = _scene(argv[1:])
        _print_stage_report()
        return rc
    except UsageError as e:
        print(f"USAGE ERROR: {e}.")
        return 254
    except (ValueError, RuntimeError, OSError) as e:
        from opticalimageprocessor_tpu.utils.logging import loge

        loge("%s.", e)
        return 2
    except Exception:  # noqa: BLE001 — reference maps unknown errors to 1
        from opticalimageprocessor_tpu.utils.logging import loge

        loge("UNKOWN FATAL ERROR OCCURED.")
        return 1


if __name__ == "__main__":
    sys.exit(main())

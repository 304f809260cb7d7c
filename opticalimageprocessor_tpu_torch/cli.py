"""Command-line interface of the PyTorch/CUDA port, with the flags,
defaults, validation and exit codes of the JAX package's ``oiptpu`` (254
usage error / 2 runtime error / 1 unknown; reference main.cpp:320-343)
plus ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
PyTorch versions):

* ``auxsep`` (downlink AUX/image separation, on the host only: it takes
  no ``--device``);
* the default action (inter-band registration + alignment) and
  ``prestitch``: the parity route (bit for bit ``cv::remap``, in either
  ``--coord-mode``) or, with ``--fast``, the fast route;
* ``stitch`` (host concatenation of the CMOS halves);
* ``scene`` (the whole scene in one run): takes every flag of the JAX
  CLI's ``scene`` and runs its checks; runs the resident route, or with
  ``--stream`` the streamed one, each with or without ``--mss2`` (the
  whole sample-task workflow), in the fast route's semantics; with
  ``--parity`` (one device, in either ``--coord-mode``) in the reference
  binary's own, those of the file commands' parity route.

``--profile DIR`` on the default action, ``prestitch`` and ``scene``
writes a torch.profiler trace of the run into DIR.  ``--mesh N`` on the
default action, ``prestitch``, ``scene`` and ``scene --stream`` runs the
command over an N-device line mesh (``parallel/``): ``cuda:0`` ...
``cuda:N-1``, or ``--device cpu --mesh N`` N shards on the CPU.  A
complete set of ``OIP_DIST_*`` launch variables joins a
``torch.distributed`` process group before any work (a partial set aborts
the run, as in the JAX CLI); ``--mesh N`` then spans the processes, each
ingesting and draining only its own shards (``parallel/distributed``;
``scene --stream --mesh`` is refused there).  The workflow of
docs/sample-task.sh::

    python -m opticalimageprocessor_tpu_torch.cli auxsep \
        KASHI_TJ3-01_20220817_031259_1.dat
    python -m opticalimageprocessor_tpu_torch.cli prestitch \
        --pan1 CMOS1.PAN.RAW --pan2 CMOS2.PAN.RAW --rrc1 r1 --rrc2 r2
    python -m opticalimageprocessor_tpu_torch.cli --pan P.RAW \
        --mss M.RAW --do-rrc4pan --rrc-pan rp --rrc-msb1 b1 ... --rrc-msb4 b4
    python -m opticalimageprocessor_tpu_torch.cli stitch \
        --image1 CMOS1.PAN.RAW --image2 CMOS2.PAN.RRC.PRESTT.RAW -c 200
"""

from __future__ import annotations

import argparse
import sys

import os

from . import constants as C


# UsageError, _require_file and _print_stage_report are copied from
# opticalimageprocessor_tpu/cli.py
class UsageError(ValueError):
    pass


def _require_file(path: str, opt: str) -> None:
    """Parse-time ExistingFile check (CLI11 ->check(CLI::ExistingFile),
    main.cpp:105/114-119/193-223): fail with a usage error (rc 254) before
    any work starts."""
    if path and not os.path.isfile(path):
        raise UsageError(f"{opt}: File does not exist: {path}")


def _print_stage_report() -> None:
    """Per-stage seconds/MBps summary (the reference's ubiquitous
    stop_watch/comma_sep instrumentation, aggregated), then, after a
    ``--profile`` run, the spans' device ms a call and the counters
    (``utils.logging.span_report``)."""
    from .utils.logging import olog, span_report, stage_report

    rep = stage_report()
    if rep:
        olog("==== stage report ====")
        for name, st in rep.items():
            olog(
                "%-24s %8.3f s  %10.1f MBps  (%d calls)",
                name, st["seconds"], st["MBps"] if st["bytes"] else 0.0,
                st["calls"],
            )
    spans = span_report()
    if spans:
        olog("==== span report ====")
        for name, sp in spans.items():
            if "count" in sp:
                olog("%-24s %8d  (%d calls)", name, sp["count"],
                     sp["calls"])
            else:
                olog("%-24s %10.3f device ms a call  (%d calls)", name,
                     sp["device_ms"] / sp["calls"], sp["calls"])


_PROFILE_HELP = ("write a torch.profiler trace of the run (host activity, "
                 "and the card's with a CUDA --device) to DIR")


def _mesh_help(what: str) -> str:
    return (f"run the {what} over an N-device line mesh (0 = single "
            "device; fast-mode remap semantics): cuda:0 ... cuda:N-1, or N "
            "shards on the CPU with --device cpu")


def _add_port_flags(p: argparse.ArgumentParser, what: str,
                    pipeline: str) -> None:
    """``--fast``, ``--mesh`` and ``--profile`` as the JAX CLI spells them,
    and ``--device``."""
    p.add_argument("--fast", action="store_true", default=False,
                   help=f"fast-mode {what} over the whole strip (within 1 "
                        "DN of the default parity route's sections)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help=_mesh_help(pipeline))
    p.add_argument("--profile", default="", metavar="DIR",
                   help=_PROFILE_HELP)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")


def _build_default_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="oiptorch",
        description=(
            "Optical Satellite Image Pre-Processing/Processing Utility "
            "(PyTorch/CUDA).  Without a subcommand, runs the inter-band "
            "registration + alignment action."
        ),
        epilog=(
            "subcommands (run 'oiptorch <subcommand> --help' for options): "
            "auxsep (downlink AUX/image separation), "
            "prestitch (dual-CMOS stitch parameters + PAN2 correction), "
            "stitch (concatenate the CMOS halves), scene (the whole scene "
            "in one run)"
        ),
    )
    p.add_argument("-v", "--version", action="version", version="1.1")
    p.add_argument("--pan", default="", help="PAN raw image file path")
    p.add_argument("--do-rrc4pan", action="store_true",
                   help="Whether or not do Relative Radiometric Correction "
                        "for PAN")
    p.add_argument("--rrc-pan", default="",
                   help="Relative Radiometric Correction parameter file path "
                        "for PAN image")
    p.add_argument("--write-rrcpan", dest="write_rrcpan", action="store_true",
                   help="Whether or not write RRC PAN data as tiff image file")
    p.add_argument("--no-rrcpan", dest="write_rrcpan", action="store_false")
    p.add_argument("--mss", default="", help="MSS raw image file path")
    p.add_argument("--no-rrc4mss", dest="do_rrc4mss", action="store_false",
                   default=True,
                   help="Skip Relative Radiometric Correction for MSS")
    for b in range(1, 5):
        p.add_argument(f"--rrc-msb{b}", default="",
                       help="Relative Radiometric Correction parameter file "
                            f"path for MSS band #{b} (1-based band NO.)")
    p.add_argument("--slices", type=int, default=C.IBCV_DEF_SLICES)
    p.add_argument("--ibc-sections", type=int, default=C.IBCV_DEF_SECTIONS)
    p.add_argument("--ibc-threshold", type=float, default=C.IBCV_DEF_THRESHOLD)
    p.add_argument("--line-offset", type=int, default=C.IBPA_DEFAULT_LINEOFFSET)
    p.add_argument("--lines-section", type=int,
                   default=C.IBPA_DEFAULT_BATCHLINES)
    p.add_argument("--overlap-lines", type=int,
                   default=C.IBPA_DEFAULT_LINEOVERLAP)
    p.add_argument("-k", "--keep-leading", action="store_true", default=False)
    p.add_argument("--out-dir", default=None,
                   help="output directory (default cwd)")
    p.add_argument("--coord-mode", choices=["continuous", "quantized"],
                   default="continuous",
                   help="coordinate convention of the parity route's "
                        "resample: OpenCV 5.x continuous, or OpenCV <= 4.x's "
                        "1/32-px grid (the fast route ignores it, as in the "
                        "JAX package)")
    _add_port_flags(p, "alignment resample", "align pipeline")
    return p


def _default_action(a) -> int:
    if not (0.0 <= a.ibc_threshold < 1.0):
        raise UsageError("invalid threshold value")
    # CLI11 ->needs(rrc4pan) parity (main.cpp:198-203)
    if a.rrc_pan and not a.do_rrc4pan:
        raise UsageError("--rrc-pan needs --do-rrc4pan")
    if a.write_rrcpan and not a.do_rrc4pan:
        raise UsageError("--write-rrcpan needs --do-rrc4pan")
    if a.do_rrc4pan and not a.rrc_pan:
        raise UsageError("RRC parameter file of PAN needed")
    rrc_mss = (a.rrc_msb1, a.rrc_msb2, a.rrc_msb3, a.rrc_msb4)
    if a.do_rrc4mss and any(not f for f in rrc_mss):
        raise UsageError("RRC parameter file of all MSS Bands needed")
    _require_file(a.pan, "--pan")
    _require_file(a.mss, "--mss")
    _require_file(a.rrc_pan, "--rrc-pan")
    for i, f in enumerate(rrc_mss, 1):
        _require_file(f, f"--rrc-msb{i}")

    from .utils.logging import device_profile

    with device_profile(a.profile, a.device):
        if a.mesh:
            from .models.sharded_align import run_sharded_align

            run_sharded_align(
                a.pan, a.mss, a.rrc_pan, rrc_mss, n_devices=a.mesh,
                do_rrc_pan=a.do_rrc4pan, do_rrc_mss=a.do_rrc4mss,
                slices=a.slices, sections=a.ibc_sections,
                threshold=a.ibc_threshold, line_offset=a.line_offset,
                section_overlap=a.overlap_lines,
                keep_leading_lines=a.keep_leading, out_dir=a.out_dir,
                quantized_coords=a.coord_mode == "quantized",
                write_rrcpan=a.do_rrc4pan and a.write_rrcpan,
                device=a.device,
            )
            return 0

        from .models.preprocessor import PreProcessor

        pp = PreProcessor(a.pan, a.mss, a.rrc_pan, rrc_mss,
                          out_dir=a.out_dir,
                          quantized_coords=a.coord_mode == "quantized",
                          fast=a.fast, device=a.device)
        pp.load_and_rrc(do_rrc_pan=a.do_rrc4pan, do_rrc_mss=a.do_rrc4mss)
        if a.do_rrc4pan and a.write_rrcpan:
            pp.write_rrc_pan_tiff(a.line_offset)
        pp.calc_inter_band_correlation(a.slices, a.ibc_sections,
                                       a.ibc_threshold)
        pp.do_inter_band_alignment(
            a.lines_section, a.line_offset, a.overlap_lines, a.keep_leading
        )
    return 0


def _auxsep(argv) -> int:
    p = argparse.ArgumentParser(prog="oiptorch auxsep",
                                description="Do aux & image data separation")
    p.add_argument("-O", "--offset", type=int, default=0,
                   help="Parse AOS file from specified byte offset")
    p.add_argument("file", help="AOS or IMDT file path")
    p.add_argument("--out-dir", default=None)
    a = p.parse_args(argv)
    _require_file(a.file, "file")

    from .models.auxsep import AuxSeparator

    AuxSeparator(a.file, a.offset, out_dir=a.out_dir).separate()
    return 0


def _prestitch(argv) -> int:
    p = argparse.ArgumentParser(
        prog="oiptorch prestitch",
        description=(
            "Do preparation parameters calculating & PAN2 pixel correction "
            "for CMOS stitching"
        ),
    )
    p.add_argument("--pan1", required=True)
    p.add_argument("--pan2", required=True)
    p.add_argument("--rrc1", default="")
    p.add_argument("--rrc2", default="")
    p.add_argument("-s", "--sections", type=int, default=C.STT_DEF_SECTIONS)
    p.add_argument("-l", "--section-lines", type=int,
                   default=C.STT_DEF_SECLINES)
    p.add_argument("--stitch-overlap", type=int, default=C.STT_DEF_OVERLAPPX)
    p.add_argument("--stt-threshold", type=float, default=C.STT_DEF_PHCTHRHLD)
    p.add_argument("--stt-maxdeltay", type=float, default=C.STT_DEF_MAXDELTAY)
    p.add_argument("-e", "--edge-cols", type=int, default=C.STT_DEF_EDGECOLS)
    p.add_argument("-r", "--rrc", dest="do_rrc", action="store_true",
                   default=True)
    p.add_argument("--no-rrc", dest="do_rrc", action="store_false")
    p.add_argument("-c", "--only-calculate", action="store_true",
                   default=False)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--coord-mode", choices=["continuous", "quantized"],
                   default="continuous",
                   help="coordinate convention of the parity route's "
                        "resample: OpenCV 5.x continuous, or OpenCV <= 4.x's "
                        "1/32-px grid (the fast route ignores it, as in the "
                        "JAX package)")
    _add_port_flags(p, "constant-shift resample", "prestitch pipeline")
    a = p.parse_args(argv)
    if a.edge_cols < 0 or a.edge_cols > a.stitch_overlap // 2:
        raise UsageError("invalid edge cols")
    _require_file(a.pan1, "--pan1")
    _require_file(a.pan2, "--pan2")
    _require_file(a.rrc1, "--rrc1")
    _require_file(a.rrc2, "--rrc2")

    from .utils.logging import device_profile

    with device_profile(a.profile, a.device):
        if a.mesh:
            from .models.sharded_prestitch import run_sharded_prestitch

            run_sharded_prestitch(
                a.pan1, a.pan2, a.rrc1, a.rrc2, n_devices=a.mesh,
                sections=a.sections, line_per_section=a.section_lines,
                overlap_cols=a.stitch_overlap, threshold=a.stt_threshold,
                max_delta_y=a.stt_maxdeltay, edge_cols=a.edge_cols,
                do_rrc=a.do_rrc, only_calculate=a.only_calculate,
                out_dir=a.out_dir, device=a.device,
            )
            return 0

        from .models.stitcher import Stitcher

        st = Stitcher(a.pan1, a.pan2, a.rrc1, a.rrc2, a.sections,
                      a.section_lines, a.stitch_overlap, out_dir=a.out_dir,
                      quantized_coords=a.coord_mode == "quantized",
                      fast=a.fast, device=a.device)
        st.calc_stt_parameters(a.stt_threshold, a.stt_maxdeltay, a.edge_cols)
        if not a.only_calculate:
            if a.do_rrc:
                st.do_rrc()
            st.pre_stitch()
    return 0


def _stitch(argv) -> int:
    p = argparse.ArgumentParser(prog="oiptorch stitch",
                                description="Stitch two PAN or MSS images.")
    p.add_argument("--image1", required=True, help="Left image file path")
    p.add_argument("--image2", required=True, help="Right image file path")
    p.add_argument("-o", "--out", default="")
    p.add_argument("-c", "--fold-cols", type=int, required=True,
                   help="Folding cols (in pixel) when stitching two images")
    p.add_argument("-g", "--GDAL", dest="use_gdal", action="store_true",
                   default=False)
    p.add_argument("-m", "--band-map", default="",
                   help="Map output band order (1-based), i.e '3,2,1,4'")
    p.add_argument("--band-interp", action="store_true", default=False,
                   help="tag 4-band TIFF output bands R/G/B/Alpha "
                        "(StitchTiffGDAL setBandInterpretion; implies -g)")
    p.add_argument("--out-dir", default=None)
    a = p.parse_args(argv)
    if a.fold_cols < 2:
        raise UsageError("fold column value too small")
    band_map = None
    if a.band_map:
        if not a.use_gdal:
            raise UsageError("-m needs -g")
        parts = a.band_map.split(",")
        if len(parts) != 4:
            raise UsageError("need 4 band indices")
        band_map = [int(x) for x in parts]
        if any(m <= 0 or m > C.MSS_BANDS for m in band_map):
            raise UsageError("invalid band index")

    from .models.stitcher import stitch

    stitch(a.image1, a.image2, a.out, a.fold_cols // 2,
           a.use_gdal or a.band_interp, band_map, out_dir=a.out_dir,
           band_interp=a.band_interp)
    return 0


def _scene(argv) -> int:
    p = argparse.ArgumentParser(
        prog="oiptorch scene",
        description=(
            "Whole-scene pipeline: RRC + registration + alignment + "
            "prestitch + stitch in one run, in fast-mode semantics or, "
            "with --parity, the reference's own (the scene must fit in "
            "device memory unless --stream, or in the mesh's with "
            "--mesh N)"
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
    p.add_argument("--mss2", default="",
                   help="CMOS2 MSS raw image: also align it against the "
                        "prestitched PAN2 and stitch the MSS pair")
    for b in range(1, 5):
        p.add_argument(f"--rrc-m2b{b}", default="",
                       help=f"RRC CSV for CMOS2 MSS band #{b}")
    p.add_argument("--out-mss", default="",
                   help="stitched MSS output TIFF (with --mss2)")
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
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help=_mesh_help("scene pipeline"))
    p.add_argument("--stream", action="store_true", default=False,
                   help="stream the scene in sections (bounded device "
                        "memory, same outputs; with --mesh N, N sections "
                        "at once, one a device)")
    p.add_argument("--stream-section-lines", type=int, default=4096,
                   help="PAN lines per streamed section (with --stream)")
    p.add_argument("--parity", action="store_true", default=False,
                   help="the reference binary's own semantics on one "
                        "device (the parity route of prestitch, the "
                        "default action with --do-rrc4pan and stitch: "
                        "full-surface phase correlation, cv::resize and "
                        "cv::remap in the reference's sections), in place "
                        "of the fast route's")
    p.add_argument("--coord-mode", choices=["continuous", "quantized"],
                   default="continuous",
                   help="coordinate convention of --parity's resample: "
                        "OpenCV 5.x continuous, or OpenCV <= 4.x's 1/32-px "
                        "grid (the fast route ignores it)")
    p.add_argument("--profile", default="", metavar="DIR",
                   help=_PROFILE_HELP)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    a = p.parse_args(argv)
    # the JAX CLI's checks, in its order
    if a.fold_cols < 2:
        raise UsageError("fold column value too small")
    if not (0.0 <= a.ibc_threshold < 1.0) or not (
        0.0 <= a.stt_threshold < 1.0
    ):
        raise UsageError("invalid threshold value")
    rrc_mss = (a.rrc_msb1, a.rrc_msb2, a.rrc_msb3, a.rrc_msb4)
    rrc_mss2 = (a.rrc_m2b1, a.rrc_m2b2, a.rrc_m2b3, a.rrc_m2b4)
    if any(rrc_mss2) and not a.mss2:
        raise UsageError("--rrc-m2b* needs --mss2")
    if a.out_mss and not a.mss2:
        raise UsageError("--out-mss needs --mss2")
    if a.parity:
        for flag, on, why in (
            ("--mesh", a.mesh, "the line mesh runs the fast route"),
            ("--stream", a.stream, "the streamed sections run the fast "
                                   "route"),
            ("--mss2", a.mss2, "CMOS2's alignment runs the fast route"),
        ):
            if on:
                raise UsageError(f"--parity runs on one device from "
                                 f"resident strips, without {flag}: {why}")
    for opt, f in (
        ("--pan1", a.pan1), ("--pan2", a.pan2), ("--mss", a.mss),
        ("--mss2", a.mss2),
        ("--rrc-pan1", a.rrc_pan1), ("--rrc-pan2", a.rrc_pan2),
        *[(f"--rrc-msb{i}", f) for i, f in enumerate(rrc_mss, 1)],
        *[(f"--rrc-m2b{i}", f) for i, f in enumerate(rrc_mss2, 1)],
    ):
        _require_file(f, opt)

    kw = dict(
        mss2_file=a.mss2, rrc_mss2_files=rrc_mss2,
        slices=a.slices, sections=a.ibc_sections or None,
        fold_cols=a.fold_cols, stt_sections=a.stt_sections,
        threshold=a.ibc_threshold, stt_threshold=a.stt_threshold,
        stt_max_delta_y=a.stt_maxdeltay, out_stitched=a.out,
        out_stitched_mss=a.out_mss, out_dir=a.out_dir, device=a.device,
        profile_dir=a.profile, mesh=a.mesh,
    )
    if a.parity:
        from .models.scene import run_parity_scene

        run_parity_scene(
            a.pan1, a.pan2, a.mss, a.rrc_pan1, a.rrc_pan2, rrc_mss,
            slices=a.slices, sections=a.ibc_sections or None,
            fold_cols=a.fold_cols, stt_sections=a.stt_sections,
            threshold=a.ibc_threshold, stt_threshold=a.stt_threshold,
            stt_max_delta_y=a.stt_maxdeltay, out_stitched=a.out,
            out_dir=a.out_dir, device=a.device, profile_dir=a.profile,
            quantized_coords=a.coord_mode == "quantized",
        )
    elif a.stream:
        from .models.scene_stream import run_scene_streamed

        run_scene_streamed(
            a.pan1, a.pan2, a.mss, a.rrc_pan1, a.rrc_pan2, rrc_mss,
            section_rows=a.stream_section_lines, **kw,
        )
    else:
        from .models.scene import run_scene

        run_scene(a.pan1, a.pan2, a.mss, a.rrc_pan1, a.rrc_pan2, rrc_mss,
                  **kw)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # join the process group of a multi-process launch before any work and
    # outside the error mapping (JAX cli.py:441-448): a misconfigured
    # launch must not run N independent copies racing on the same output
    # files
    from .parallel.distributed import maybe_initialize_distributed

    maybe_initialize_distributed()
    try:
        if argv and argv[0] == "auxsep":
            rc = _auxsep(argv[1:])
        elif argv and argv[0] == "prestitch":
            rc = _prestitch(argv[1:])
        elif argv and argv[0] == "stitch":
            rc = _stitch(argv[1:])
        elif argv and argv[0] == "scene":
            rc = _scene(argv[1:])
        else:
            rc = _default_action(_build_default_parser().parse_args(argv))
        _print_stage_report()
        return rc
    except UsageError as e:
        print(f"USAGE ERROR: {e}.")
        return 254
    except (ValueError, RuntimeError, OSError) as e:
        from .utils.logging import loge

        loge("%s.", e)
        return 2
    except Exception:  # noqa: BLE001 — reference maps unknown errors to 1
        from .utils.logging import loge

        loge("UNKOWN FATAL ERROR OCCURED.")
        return 1


if __name__ == "__main__":
    sys.exit(main())

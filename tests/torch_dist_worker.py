"""Worker process of the port's multi-process tests
(tests/test_torch_distributed.py); not a test module.

The parent sets the ``OIP_DIST_*`` launch variables; each process joins the
process group, runs one command over a line mesh that spans the
processes, and writes what the parent compares with a one-process run.

Usage (``<timeout_s>``: the process group's timeout, in place of the
port's 300 s, so that a test whose peer fails does not wait that long):
    torch_dist_worker.py <timeout_s> cli <pixels_per_line> <argv...>
        ``opticalimageprocessor_tpu_torch.cli.main(argv)`` with the mesh
        and scene routes narrowed to ``pixels_per_line`` (the CLI runs at
        the camera width); exits with its return code
    torch_dist_worker.py <timeout_s> align_step <dir>
        the sharded align step on ``<dir>/inputs.npz`` over ``--mesh 8``,
        then the RAW drain of the ingested PAN and the LZW drain of
        ``<dir>/ramp.npy``
    torch_dist_worker.py <timeout_s> align_e2e <dir>
        ``run_sharded_align`` with ``write_rrcpan`` into ``<dir>/out_multi``,
        then with ``write_tiff=False``
    torch_dist_worker.py <timeout_s> peer_exit <dir>
        every process joins; the last one exits, the others then wait at a
        barrier
"""

import functools
import os
import sys

import numpy as np


def _narrow(width: int) -> None:
    from opticalimageprocessor_tpu_torch.models import (
        scene,
        scene_stream,
        sharded_align,
        sharded_prestitch,
    )

    for mod, name in ((scene, "run_scene"),
                      (scene_stream, "run_scene_streamed"),
                      (sharded_align, "run_sharded_align"),
                      (sharded_prestitch, "run_sharded_prestitch")):
        setattr(mod, name, functools.partial(getattr(mod, name),
                                             pixels_per_line=width))


def align_step(d: str) -> None:
    from opticalimageprocessor_tpu_torch.parallel import distributed, sharded
    from opticalimageprocessor_tpu_torch.parallel.mesh import line_mesh

    assert distributed.maybe_initialize_distributed()
    me = distributed.process_index()
    z = np.load(os.path.join(d, "inputs.npz"))
    mesh = line_mesh(8, "cpu")
    pan_s = sharded.ingest_line_sharded(mesh, z["pan"], 0, 4)
    step = sharded.make_align_step(mesh, slices=8, sections=1)
    aligned, cx, cy = step(pan_s, z["mss"], (z["pan_k"], z["pan_b"]),
                           (z["mss_k"], z["mss_b"]))
    np.save(os.path.join(d, f"cx_{me}.npy"), cx)
    np.save(os.path.join(d, f"cy_{me}.npy"), cy)
    for i, t in enumerate(aligned.shards):
        if t is not None:
            np.save(os.path.join(d, f"aligned_{i:02d}.npy"), t.numpy())
    distributed.drain_line_sharded_to_raw(
        pan_s, os.path.join(d, "pan_drained.RAW"), z["pan"].shape[1])
    ramp = np.load(os.path.join(d, "ramp.npy"))
    distributed.drain_line_sharded_to_tiff_lzw(
        sharded.ingest_line_sharded(mesh, ramp),
        os.path.join(d, "ramp_lzw.TIFF"), total=ramp.shape[0],
        order=[2, 1, 0, 3], rows_per_strip=64, row0=17)
    distributed.barrier("worker-done")


def align_e2e(d: str) -> None:
    from opticalimageprocessor_tpu_torch.models.sharded_align import (
        run_sharded_align,
    )
    from opticalimageprocessor_tpu_torch.parallel import distributed

    assert distributed.maybe_initialize_distributed()
    kw = dict(
        rrc_pan_file=os.path.join(d, "pan.rrc"),
        rrc_mss_files=tuple(os.path.join(d, f"b{i}.rrc")
                            for i in range(1, 5)),
        n_devices=8, do_rrc_pan=True, slices=8, sections=1,
        section_overlap=64, pixels_per_line=512, device="cpu",
    )
    files = (os.path.join(d, "P.PAN.RAW"), os.path.join(d, "P.MSS.RAW"))
    run_sharded_align(*files, out_dir=os.path.join(d, "out_multi"),
                      write_rrcpan=True, **kw)
    arr = run_sharded_align(*files, write_tiff=False, **kw)
    np.save(os.path.join(d, f"gathered_{distributed.process_index()}.npy"),
            arr)


def peer_exit(d: str) -> None:
    from opticalimageprocessor_tpu_torch.parallel import distributed

    assert distributed.maybe_initialize_distributed()
    if distributed.process_index() == distributed.process_count() - 1:
        os._exit(3)
    distributed.barrier("after-peer-exit")


def main() -> int:
    from opticalimageprocessor_tpu_torch.parallel import distributed

    distributed._DEFAULT_TIMEOUT_S = float(sys.argv[1])
    mode, args = sys.argv[2], sys.argv[3:]
    if mode == "cli":
        _narrow(int(args[0]))
        from opticalimageprocessor_tpu_torch import cli

        return cli.main(args[1:])
    {"align_step": align_step, "align_e2e": align_e2e,
     "peer_exit": peer_exit}[mode](args[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

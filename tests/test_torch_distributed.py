"""The port's multi-process launch (parallel/distributed, ``OIP_DIST_*``):
two processes over gloo on the CPU, each ingesting, computing and draining
only its own shards of an 8-shard line mesh, held byte for byte to the
one-process ``LineMesh([cpu] * 8)``, and to the JAX package (its
sequential LZW writer; its single-process scene mesh within the envelope
of its own two-process test, test_parallel.py:646).

The workers are tests/torch_dist_worker.py, spawned in pairs with JAX's
free-port recipe (test_parallel.py:236-238); each wait has a timeout and a
pair is killed in a ``finally``, so a hang fails the test."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import dist_worker
from opticalimageprocessor_tpu.formats.rrc_csv import save_rrc_params
from opticalimageprocessor_tpu.io import tiff as jtiff
from opticalimageprocessor_tpu.models.scene import run_scene as jrun_scene
from opticalimageprocessor_tpu.ops import resample as jres
from opticalimageprocessor_tpu_torch.models import scene as tscene
from opticalimageprocessor_tpu_torch.models import sharded_align as talign
from opticalimageprocessor_tpu_torch.models import sharded_prestitch as tpst
from opticalimageprocessor_tpu_torch.parallel import sharded
from opticalimageprocessor_tpu_torch.parallel.mesh import LineMesh
from test_torch_parallel import PST_KW, PST_OV, PST_PPL, _write_pair

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
WAIT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp, args, nprocs=2, timeout_s=120):
    """``nprocs`` worker processes under one complete ``OIP_DIST_*`` set
    (``timeout_s``: the group's timeout) -> [(rc, output)] in process
    order."""
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2",
           "OIP_DIST_COORD": f"127.0.0.1:{_free_port()}",
           "OIP_DIST_NPROCS": str(nprocs)}
    procs, logs = [], []
    try:
        for i in range(nprocs):
            logs.append(os.path.join(tmp, f"worker_{i}.out"))
            with open(logs[-1], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, WORKER, str(timeout_s),
                     *map(str, args)],
                    env={**env, "OIP_DIST_PROCID": str(i),
                         "LOGFILE": os.path.join(tmp, f"oip_{i}.log")},
                    stdout=out, stderr=subprocess.STDOUT, cwd=tmp))
        rcs = [p.wait(timeout=WAIT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(rc, open(log).read()) for rc, log in zip(rcs, logs)]


def _all_ok(res):
    for rc, text in res:
        assert rc == 0, text[-3000:]


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    return names


# -- the align step and the drains (test_parallel.py:216) ---------------------

def test_two_process_align_step_equals_one_process(tmp_path):
    """The sharded align step over 8 shards in 2 processes: the fit
    coefficients bit for bit on both processes and the one-process mesh's,
    the aligned shards byte for byte; the RAW drain of the ingested PAN
    (each process its own rows) reproduces the strip, and the LZW drain
    (strips straddling the processes, a 17-row trim) is byte for byte the
    JAX package's sequential TiffStripWriter."""
    pan, mss, _, _ = dist_worker.make_inputs()
    width, band_px = pan.shape[1], mss.shape[2]
    ident = dict(pan_k=np.ones(width), pan_b=np.zeros(width),
                 mss_k=np.ones((4, band_px)), mss_b=np.zeros((4, band_px)))
    np.savez(tmp_path / "inputs.npz", pan=pan, mss=mss, **ident)
    ramp = dist_worker.lzw_fixture()
    np.save(tmp_path / "ramp.npy", ramp)
    _all_ok(_launch(tmp_path, ["align_step", tmp_path]))

    mesh = LineMesh(["cpu"] * 8)
    aligned, cx, cy = sharded.make_align_step(mesh, slices=8, sections=1)(
        sharded.ingest_line_sharded(mesh, pan, 0, 4), mss,
        (ident["pan_k"], ident["pan_b"]), (ident["mss_k"], ident["mss_b"]))
    for me in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"cx_{me}.npy"), cx)
        np.testing.assert_array_equal(np.load(tmp_path / f"cy_{me}.npy"), cy)
    for i, t in enumerate(aligned.shards):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"aligned_{i:02d}.npy"), t.numpy())
    np.testing.assert_array_equal(
        np.fromfile(tmp_path / "pan_drained.RAW", "<u2").reshape(pan.shape),
        pan)

    seq = str(tmp_path / "ramp_lzw_seq.TIFF")
    w = jtiff.TiffStripWriter(seq, ramp.shape[1], ramp.shape[0] - 17, 4,
                              rows_per_strip=64, compression="lzw",
                              predictor=True)
    w.write_rows(ramp[17:][:, :, [2, 1, 0, 3]])
    w.close()
    assert (tmp_path / "ramp_lzw.TIFF").read_bytes() == open(seq, "rb").read()
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["inputs.npz", "ramp.npy", "ramp_lzw.TIFF", "ramp_lzw_seq.TIFF",
         "pan_drained.RAW", "oip_0.log", "oip_1.log", "worker_0.out",
         "worker_1.out", "cx_0.npy", "cx_1.npy", "cy_0.npy", "cy_1.npy",
         *[f"aligned_{i:02d}.npy" for i in range(8)]])   # no side files


# -- run_sharded_align end to end (test_parallel.py:328) ----------------------

def test_two_process_run_sharded_align_equals_one_process(tmp_path):
    """``run_sharded_align`` with ``write_rrcpan`` over 8 shards in 2
    processes: RRC.TIFF and ALIGNED.TIFF byte for byte the one-process
    ``--mesh 8``'s; ``write_tiff=False`` returns the same array on both
    processes, the one-process array."""
    rng = np.random.default_rng(31)
    width, band_px, lines_mss = 512, 128, 1536
    scene = rng.integers(2000, 42000, (lines_mss, band_px)).astype(np.uint16)
    pan_true = np.clip(np.rint(np.asarray(jres.upsample4_f32(
        scene.astype(np.float32)))), 0, 65535).astype(np.uint16)
    kp, bp = 1.02, -100.0
    pan_dl = np.clip(np.rint((pan_true.astype(np.float64) - bp) / kp),
                     0, 65535).astype(np.uint16)
    mss = np.stack([np.roll(scene, b % 2, axis=1) for b in range(4)],
                   axis=1).reshape(lines_mss, width)
    pan_dl.astype("<u2").tofile(tmp_path / "P.PAN.RAW")
    mss.astype("<u2").tofile(tmp_path / "P.MSS.RAW")
    save_rrc_params(str(tmp_path / "pan.rrc"), np.tile([[kp, bp]], (width, 1)))
    for i in range(1, 5):
        save_rrc_params(str(tmp_path / f"b{i}.rrc"),
                        np.tile([[1.0, 0.0]], (band_px, 1)))
    os.mkdir(tmp_path / "out_multi")
    _all_ok(_launch(tmp_path, ["align_e2e", tmp_path]))

    kw = dict(rrc_pan_file=str(tmp_path / "pan.rrc"),
              rrc_mss_files=tuple(str(tmp_path / f"b{i}.rrc")
                                  for i in range(1, 5)),
              n_devices=8, do_rrc_pan=True, slices=8, sections=1,
              section_overlap=64, pixels_per_line=width, device="cpu")
    files = (str(tmp_path / "P.PAN.RAW"), str(tmp_path / "P.MSS.RAW"))
    os.mkdir(tmp_path / "out_single")
    talign.run_sharded_align(*files, out_dir=str(tmp_path / "out_single"),
                             write_rrcpan=True, **kw)
    assert _same_files(tmp_path / "out_multi", tmp_path / "out_single") == [
        "P.MSS.ALIGNED.TIFF", "P.PAN.RRC.TIFF"]
    one = talign.run_sharded_align(*files, write_tiff=False, **kw)
    for me in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"gathered_{me}.npy"),
                                      one)


# -- scene --mesh 8 --mss2 (test_parallel.py:646) ----------------------------

SC_LINES, SC_W, SC_OV = 1200, 640, 32


def _scene_files(d, rng):
    """test_parallel.py:646's CMOS pair and MSS pair."""
    lines_mss = SC_LINES // 4
    scene = rng.integers(2000, 42000, (lines_mss, SC_W // 4)).astype(
        np.uint16)
    pan1 = np.clip(np.rint(np.asarray(jres.upsample4_f32(
        scene.astype(np.float32)))), 0, 65535).astype(np.uint16)
    pan2 = np.roll(np.roll(pan1, 2, axis=0), SC_OV - 3 - SC_W, axis=1)
    mss = np.stack([np.roll(scene, b - 1, 1) for b in range(4)],
                   axis=1).reshape(lines_mss, SC_W)
    mss2 = np.stack([np.roll(scene, b, 1) for b in range(4)],
                    axis=1).reshape(lines_mss, SC_W)
    for name, a in (("C1.PAN", pan1), ("C2.PAN", pan2), ("C1.MSS", mss),
                    ("C2.MSS", mss2)):
        a.astype("<u2").tofile(os.path.join(d, f"{name}.RAW"))
    save_rrc_params(os.path.join(d, "pan.rrc"),
                    np.tile([[1.01, -3.0]], (SC_W, 1)))
    return {k: os.path.join(d, f"{k}.RAW")
            for k in ("C1.PAN", "C2.PAN", "C1.MSS", "C2.MSS")}


def test_two_process_scene_mesh_equals_one_process(tmp_path):
    """``scene --mesh 8 --mss2`` in 2 processes through the CLI: every
    output byte for byte the one-process port mesh's; against JAX's
    single-process ``run_scene(mesh=8)`` JAX's own two-process envelope:
    the stitched PAN's left half exact, elsewhere mean < 1 DN, max <= 8."""
    f = _scene_files(str(tmp_path), np.random.default_rng(1234))
    rrc = str(tmp_path / "pan.rrc")
    out = {k: tmp_path / f"out_{k}" for k in ("multi", "single", "jax")}
    for d in out.values():
        os.mkdir(d)
    argv = ["scene", "--pan1", f["C1.PAN"], "--pan2", f["C2.PAN"], "--mss",
            f["C1.MSS"], "--mss2", f["C2.MSS"], "--rrc-pan1", rrc,
            "--rrc-pan2", rrc, "--slices", "8", "-c", str(SC_OV), "-s", "2",
            "--mesh", "8", "--device", "cpu", "--out-dir", out["multi"],
            "-o", out["multi"] / "stitched.RAW"]
    _all_ok(_launch(tmp_path, ["cli", SC_W, *argv]))

    kw = dict(rrc_pan1=rrc, rrc_pan2=rrc, mss2_file=f["C2.MSS"], slices=8,
              fold_cols=SC_OV, stt_sections=2, pixels_per_line=SC_W, mesh=8)
    tscene.run_scene(f["C1.PAN"], f["C2.PAN"], f["C1.MSS"],
                     out_dir=str(out["single"]),
                     out_stitched=str(out["single"] / "stitched.RAW"),
                     device="cpu", **kw)
    names = _same_files(out["multi"], out["single"])
    assert len(names) == 4, names

    o = jrun_scene(f["C1.PAN"], f["C2.PAN"], f["C1.MSS"],
                   out_dir=str(out["jax"]),
                   out_stitched=str(out["jax"] / "stitched.RAW"), **kw)
    half = SC_W - SC_OV // 2
    st = np.fromfile(out["multi"] / "stitched.RAW", "<u2").reshape(
        SC_LINES, 2 * half)
    jst = np.fromfile(o["stitched"], "<u2").reshape(SC_LINES, 2 * half)
    np.testing.assert_array_equal(st[:, :half], jst[:, :half])
    rasters = [(st, jst)] + [
        (jtiff.read_tiff(str(out["multi"] / os.path.basename(o[k]))),
         jtiff.read_tiff(o[k])) for k in ("aligned", "aligned2",
                                          "stitched_mss")]
    for got, want in rasters:
        assert got.shape == want.shape
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.mean() < 1.0 and d.max() <= 8, (d.mean(), d.max())


# -- prestitch --mesh 8 ------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--fast"]], ids=["parity", "fast"])
def test_two_process_prestitch_mesh_equals_one_process(tmp_path, flags):
    """``prestitch --mesh 8`` in 2 processes through the CLI, without and
    with ``--fast`` (the mesh route is the fast one either way): RRC.RAW of
    both PANs and PRESTT.RAW byte for byte the one-process mesh's."""
    files = _write_pair(str(tmp_path), np.random.default_rng(31), 644)
    out = {k: tmp_path / k for k in ("multi", "single")}
    for d in out.values():
        os.mkdir(d)
    argv = ["prestitch", *flags, "--pan1", files["pan1"], "--pan2",
            files["pan2"], "--rrc1", files["rrc1"], "--rrc2", files["rrc2"],
            "-s", "3", "-l", "128", "--stitch-overlap", str(PST_OV),
            "--stt-threshold", "0.05", "--mesh", "8", "--device", "cpu",
            "--out-dir", out["multi"]]
    _all_ok(_launch(tmp_path, ["cli", PST_PPL, *argv]))
    tpst.run_sharded_prestitch(files["pan1"], files["pan2"], files["rrc1"],
                               files["rrc2"], n_devices=8, device="cpu",
                               out_dir=str(out["single"]), **PST_KW)
    assert _same_files(out["multi"], out["single"]) == [
        "C1.PAN.RRC.RAW", "C2.PAN.RRC.PRESTT.RAW", "C2.PAN.RRC.RAW"]


# -- guards -------------------------------------------------------------------

def test_cli_joins_a_one_process_distributed_env(tmp_path):
    """A complete ``OIP_DIST_*`` set of one process joins the group and
    runs the command."""
    a = tmp_path / "L.RAW"
    np.zeros((4, 12288), np.uint16).tofile(a)
    res = _launch(tmp_path, ["cli", 12288, "stitch", "--image1", a,
                             "--image2", a, "-o", tmp_path / "O.RAW", "-c",
                             "4"], nprocs=1)
    _all_ok(res)
    assert (tmp_path / "O.RAW").stat().st_size == 4 * 2 * (12288 - 2) * 2
    assert "Process 0 of 1 joined the process group" in open(
        tmp_path / "oip_0.log").read()


def test_a_dead_peer_fails_the_barrier_within_the_timeout(tmp_path):
    """A process that dies after the join makes the other fail at its next
    barrier, naming it, within the group's timeout: no hang."""
    import time

    t0 = time.perf_counter()
    (rc0, text0), (rc1, _) = _launch(tmp_path, ["peer_exit", tmp_path],
                                     timeout_s=30)
    assert rc1 == 3
    assert rc0 != 0 and "barrier 'after-peer-exit' failed" in text0, text0
    assert time.perf_counter() - t0 < 60


@pytest.mark.parametrize("extra, message", [
    ([], "requires --mesh N"),
    (["--stream", "--mesh", "8"], "scene --stream --mesh under 2 processes"),
    (["--mesh", "3"], "--mesh 3 over 2 processes"),
], ids=["no_mesh", "stream_mesh", "mesh_3"])
def test_two_process_scene_refusals(tmp_path, extra, message):
    """Under 2 processes: ``scene`` without ``--mesh`` gets JAX's refusal,
    ``scene --stream --mesh`` is refused, a mesh that does not split over
    the processes raises -- rc 2 on both, before any output."""
    a = tmp_path / "L.RAW"
    np.zeros((4, SC_W), np.uint16).tofile(a)
    os.mkdir(tmp_path / "out")
    res = _launch(tmp_path, ["cli", SC_W, "scene", "--pan1", a, "--pan2", a,
                             "--mss", a, "--device", "cpu", "--out-dir",
                             tmp_path / "out", *extra])
    for rc, text in res:
        assert rc == 2 and message in text, text[-2000:]
    assert not os.listdir(tmp_path / "out")


# -- graft_entry (the counterpart of __graft_entry__.py) ----------------------

def test_graft_entry_matches_jax_entry():
    """``entry()``: the same example inputs as JAX's; the RRC stage byte for
    byte JAX's, the step within the fast remaps' envelope of JAX's (1 DN on
    < 1% of pixels, tests/test_torch_row_pass.py).  The cause is shown:
    both packages sum the same float32 products (the column cubic, then
    the U vertical taps) in float32, in different orders (XLA:CPU's
    blocked matmul and fused row pass against the port's tap order), so
    both sit within 1 DN of the float64 sum of those products, and every
    pixel where they differ is a near tie: its float64 value lies within
    the two float32 sums' error bound of a rounding boundary (x.5)."""
    import jax

    import __graft_entry__ as jge
    from opticalimageprocessor_tpu.ops import rrc as jrrc
    from opticalimageprocessor_tpu_torch import graft_entry
    from opticalimageprocessor_tpu_torch.ops.rrc import rrc_apply

    jfn, jargs = jge.entry()
    fn, args = graft_entry.entry()
    band, k, b, cx, cy = args
    assert all(isinstance(a, np.ndarray) for a in args)
    np.testing.assert_array_equal(band, jargs[0])
    np.testing.assert_array_equal(cx, jargs[2])
    np.testing.assert_array_equal(cy, jargs[3])
    np.testing.assert_array_equal(
        rrc_apply(torch.from_numpy(band), torch.from_numpy(k),
                  torch.from_numpy(b)).numpy(),
        np.asarray(jrrc.rrc_apply(band, jargs[1], use_pallas=None)))
    got = fn(*args, device="cpu").numpy()
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert got.shape == want.shape == (512, 3072) and got.dtype == np.uint16
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())

    # the float64 sum of the same float32 products
    from opticalimageprocessor_tpu_torch.ops import resample

    width, rb = band.shape[1], sharded.ROW_OFF_BOUND
    corr = torch.from_numpy(np.asarray(jrrc.rrc_apply(
        band, jargs[1], use_pallas=None)).astype(np.float64))
    tap0, w = resample._col_taps(torch.from_numpy(cx), width,
                                 resample.col_block_size(width, None),
                                 resample.COL_HALO)
    col = sum(w[t].double() * corr[:, torch.clamp(tap0 + t, 0, width - 1)]
              for t in range(4))
    cu = resample._row_pass_coeffs(
        resample._band_g(torch.from_numpy(cy), width), rb).double()
    padded = torch.nn.functional.pad(col, (0, 0, rb + 1, rb + 2))
    exact = sum(cu[v] * padded[v:v + got.shape[0]]
                for v in range(cu.shape[0])).numpy()
    for out in (got, want):
        assert np.abs(out - np.clip(np.rint(exact), 0, 65535)).max() <= 1
    # a float32 sum of n products is within n * 2^-24 * sum |terms| of the
    # exact sum: 4 column taps, then U vertical taps over them
    bound = ((4 + cu.shape[0]) * 2.0 ** -24 * float(w.abs().sum(0).max())
             * float(cu.abs().sum(0).max()) * float(corr.max()))
    tie = np.abs(exact - np.floor(exact) - 0.5)
    assert bound < 0.25 and tie[d > 0].max() <= bound, (tie[d > 0].max(),
                                                        bound)


def test_graft_entry_dryrun_multichip():
    """One sharded align step over ``LineMesh([cpu] * 8)``, value-checked."""
    from opticalimageprocessor_tpu_torch import graft_entry

    graft_entry.dryrun_multichip(8)

"""The port's scene over the line mesh (parallel/sharded_scene, run_scene
and run_scene_streamed with ``mesh``, ``scene --mesh N``) on
``LineMesh([cpu] * N)``: against the port's resident route (estimates bit
for bit, rasters byte for byte) and against the JAX package's
make_sharded_scene_fn on its 8-device virtual CPU mesh."""

import functools
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from opticalimageprocessor_tpu.formats.rrc_csv import load_rrc_params
from opticalimageprocessor_tpu.ops import rrc as jrrc
from opticalimageprocessor_tpu.parallel import mesh as jmesh
from opticalimageprocessor_tpu.parallel import sharded_scene as jss
from opticalimageprocessor_tpu_torch import cli
from opticalimageprocessor_tpu_torch.models import scene, scene_stream
from opticalimageprocessor_tpu_torch.models.device_pipeline import (
    MssAlign,
    ScenePipeline,
)
from opticalimageprocessor_tpu_torch.ops.rrc import params_from_jax_split
from opticalimageprocessor_tpu_torch.parallel.mesh import LineMesh
from opticalimageprocessor_tpu_torch.parallel.sharded_scene import (
    ShardedMssAlign,
    ShardedScene,
)
from test_torch_scene import FOLD, _write_scene
from test_torch_scene_stream import _fused_peak_tile

torch.set_num_threads(2)

# test_parallel.py:586's strip: 1200 lines, 640 px; 300 MSS lines do not
# divide an 8-device mesh
PIX, LINES = 640, 1200
SLICES, STT = 8, 4
KEYS = ("aligned", "stitched", "aligned2", "stitched_mss")


def cpu_mesh(n):
    return LineMesh(["cpu"] * n)


def _curve(c):
    """A fitted polynomial over the strip's columns."""
    x = np.linspace(0.0, PIX, 257)
    c = np.asarray(c, np.float64)
    return sum(c[k] * x**k for k in range(c.size))


def _params(files, names):
    """JAX's split RRC of each CSV and the port's float64 pair rebuilt from
    it (both packages compute the same RRC)."""
    split = [np.asarray(jrrc.split_rrc_params(*load_rrc_params(
        files[f"rrc_{n}"], PIX // 4 if n[0] == "m" else PIX).T))
        for n in names]
    port = [params_from_jax_split(s) for s in split]
    if len(names) == 1:
        return split[0], port[0]
    return np.stack(split), (np.stack([p[0] for p in port]),
                             np.stack([p[1] for p in port]))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh"))
    files, _, arrays = _write_scene(d, np.random.default_rng(52), LINES, PIX,
                                    dy=2)
    bands = [f"msb{b}" for b in range(1, 5)]
    params = {n: _params(files, [n]) for n in ("pan1", "pan2")}
    params["mss"] = _params(files, bands)
    params["mss2"] = _params(files, [f"m2b{b}" for b in range(1, 5)])
    pipe = ScenePipeline(params["pan1"][1], params["pan2"][1],
                         params["mss"][1], slices=SLICES, fold=FOLD // 2,
                         stt_sections=STT, overlap_cols=FOLD,
                         return_prestt=True)
    align = MssAlign(params["mss2"][1], slices=SLICES)
    pan1, pan2, mss, mss2 = (torch.from_numpy(a) for a in arrays)
    est = pipe.estimate(pan1, pan2, mss)
    outs = pipe.transform(pan1, pan2, mss, *est[:2], *est[3:5])
    mss2_out = align(outs[2], mss2)
    return dict(dir=d, files=files, params=params, pipe=pipe, align=align,
                inputs=(pan1, pan2, mss, mss2), est=est, outs=outs,
                mss2_out=mss2_out)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_sharded_estimate_is_resident_bit_for_bit(data, n):
    """The tiles cut from the shards, RRC'd as they are cut, in blocks on
    the devices, and the stt windows likewise: the resident estimate bit for
    bit (the CPU's FFTs do not depend on their batch here).  One device is
    the CLI's ``scene`` without ``--mesh``."""
    pan1, pan2, mss, _ = data["inputs"]
    got = ShardedScene(data["pipe"], cpu_mesh(n)).estimate(pan1, pan2, mss)
    for g, w in zip(got, data["est"]):
        assert torch.equal(g, w), (g, w)
    assert (got[2] == SLICES).all() and int(got[5]) == STT


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_transform_is_resident_byte_for_byte(data, n):
    """With the resident estimates pinned, every shard with its clipped
    halos through ScenePipeline.transform: aligned, stitched and prestt
    byte for byte (random band RRC with RRC(0) != 0: the strip ends never
    see an RRC'd zero fill)."""
    pan1, pan2, mss, _ = data["inputs"]
    est = data["est"]
    got = ShardedScene(data["pipe"], cpu_mesh(n)).transform(
        pan1, pan2, mss, *est[:2], *est[3:5])
    assert len(got) == 3
    for g, w in zip(got, data["outs"]):
        assert torch.equal(g.gather(), w)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_sharded_mss_align_is_resident(data, n):
    """CMOS2's MSS against the prestitched PAN2 over the mesh: MssAlign's
    valid counts and fits bit for bit, its aligned raster byte for byte."""
    mss2 = data["inputs"][3]
    aligned, n_valid, (cx, cy) = ShardedMssAlign(data["align"], cpu_mesh(n))(
        data["outs"][2], mss2)
    w_aligned, w_valid, (w_cx, w_cy) = data["mss2_out"]
    assert torch.equal(n_valid, w_valid) and (n_valid == SLICES).all()
    assert torch.equal(cx, w_cx) and torch.equal(cy, w_cy)
    assert torch.equal(aligned.gather(), w_aligned)


@pytest.fixture(scope="module")
def jax_mesh(data):
    """JAX's make_sharded_scene_fn on 8 devices (the MSS zero-padded to
    304 rows, its contract), its registration on the fused route (bf16
    cross-power in interpret mode: the contract of kernel (b))."""
    pan1, pan2, mss, _ = (t.numpy() for t in data["inputs"])
    m = jmesh.line_mesh(8)
    mss_pad = np.zeros((4, jss.pad_to(m, LINES // 4), PIX // 4), np.uint16)
    mss_pad[:, :LINES // 4] = mss
    p = data["params"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jss, "_windowed_peak_tile", _fused_peak_tile)
        fn = jss.make_sharded_scene_fn(
            m, LINES, PIX, slices=SLICES, fold=FOLD // 2, stt_sections=STT,
            overlap_cols=FOLD, return_prestt=True)
        l2 = NamedSharding(m, P("line", None))
        l3 = NamedSharding(m, P(None, "line", None))
        aligned, stitched, prestt, n_valid, n_stt, params = fn(
            jax.device_put(pan1, l2), jax.device_put(pan2, l2),
            jax.device_put(mss_pad, l3), p["pan1"][0], p["pan2"][0],
            p["mss"][0])
    return dict(aligned=np.asarray(aligned)[:LINES // 4],
                stitched=np.asarray(stitched), prestt=np.asarray(prestt),
                n_valid=np.asarray(n_valid), n_stt=int(n_stt),
                params=[np.asarray(v) for v in params])


def _check_envelope(got, want, what):
    """tests/test_torch_scene.py's envelope for the single-device pair:
    within 1 DN on <= 1% of pixels."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (what, d.max(),
                                                     (d > 0).mean())


def test_sharded_scene_pinned_matches_jax(data, jax_mesh):
    """JAX's estimates pinned into the port's sharded transform: the
    stitched PAN's left half (RRC of PAN1) byte for byte; its right half,
    the aligned raster and the prestitched PAN2 within the envelope that
    tests/test_torch_scene.py holds the single-device pair to (JAX's
    constant-shift remap rounds 1 DN differently on < 0.1% of pixels)."""
    pan1, pan2, mss, _ = data["inputs"]
    cx, cy, _, _, raw_dx, raw_dy = jax_mesh["params"]
    aligned, stitched, prestt = ShardedScene(data["pipe"], cpu_mesh(8)
                                             ).transform(
        pan1, pan2, mss, torch.tensor(cx), torch.tensor(cy),
        raw_dx, raw_dy)
    st, jst = stitched.gather().numpy(), jax_mesh["stitched"]
    left = PIX - FOLD // 2
    np.testing.assert_array_equal(st[:, :left], jst[:, :left])
    _check_envelope(st[:, left:], jst[:, left:], "stitched")
    _check_envelope(aligned.gather().numpy(), jax_mesh["aligned"], "aligned")
    _check_envelope(prestt.gather().numpy(), jax_mesh["prestt"], "prestt")


def test_sharded_scene_estimates_match_jax(data, jax_mesh):
    """Unpinned: the valid counts equal, every fitted curve and the stt
    deltas within 1e-3 px of JAX's mesh estimates."""
    cx, cy, n_valid, raw_dx, raw_dy, n_stt = ShardedScene(
        data["pipe"], cpu_mesh(8)).estimate(*data["inputs"][:3])
    j = jax_mesh
    np.testing.assert_array_equal(n_valid.numpy(), j["n_valid"])
    assert int(n_stt) == j["n_stt"] == STT
    for k, got in ((0, cx), (1, cy)):
        for b in range(4):
            d = np.abs(_curve(got[b].numpy()) - _curve(j["params"][k][b]))
            assert d.max() <= 1e-3, (k, b, d.max())
    assert abs(float(raw_dx) - float(j["params"][4])) <= 1e-3
    assert abs(float(raw_dy) - float(j["params"][5])) <= 1e-3


def _run(fn, data, out, **extra):
    files = data["files"]
    os.mkdir(out)
    rrc = lambda p: tuple(files[f"rrc_{p}{b}"] for b in range(1, 5))  # noqa
    return fn(files["pan1"], files["pan2"], files["mss"], files["rrc_pan1"],
              files["rrc_pan2"], rrc("msb"), mss2_file=files["mss2"],
              rrc_mss2_files=rrc("m2b"), slices=SLICES, stt_sections=STT,
              fold_cols=FOLD, pixels_per_line=PIX, out_dir=out,
              out_stitched=os.path.join(out, "STITCHED.RAW"),
              device="cpu", **extra)


def _same_files(a, b, keys):
    for key in keys:
        with open(a[key], "rb") as fa, open(b[key], "rb") as fb:
            assert fa.read() == fb.read(), key


@pytest.fixture(scope="module")
def single_runs(data):
    d = data["dir"]
    return {
        "resident": _run(scene.run_scene, data, os.path.join(d, "res")),
        "stream": _run(scene_stream.run_scene_streamed, data,
                       os.path.join(d, "str"), section_rows=384),
    }


@pytest.mark.parametrize("mesh", [4, "cpu8"])
def test_run_scene_mesh_equals_single_device(data, single_runs, mesh):
    """run_scene(mesh=4) and over an explicit 8-shard LineMesh (300 MSS
    lines: uneven shards), with CMOS2's MSS: every output file of
    run_scene(mesh=0), byte for byte."""
    m = cpu_mesh(8) if mesh == "cpu8" else mesh
    got = _run(scene.run_scene, data,
               os.path.join(data["dir"], f"mesh{mesh}"), mesh=m)
    assert set(got) == set(KEYS)
    _same_files(got, single_runs["resident"], KEYS)


@pytest.mark.parametrize("mesh", [2, 4])
def test_run_scene_streamed_mesh_equals_stream(data, single_runs, mesh):
    """``scene --stream --mesh N``: N 384-line sections at once, one a
    device, each the single-device stream's section: every output (the
    PRESTT.RAW too) byte for byte the stream's."""
    got = _run(scene_stream.run_scene_streamed, data,
               os.path.join(data["dir"], f"smesh{mesh}"), section_rows=384,
               mesh=mesh)
    _same_files(got, single_runs["stream"], KEYS + ("prestt",))
    _same_files(got, single_runs["resident"], KEYS)


@pytest.mark.parametrize("stream", [False, True])
def test_cli_scene_mesh_on_the_cpu(data, single_runs, stream, monkeypatch):
    """``scene --device cpu --mesh 4 --mss2`` (and with ``--stream``)
    through cli.main: the single-device model run's files byte for byte."""
    files = data["files"]
    for mod, name in ((scene, "run_scene"),
                      (scene_stream, "run_scene_streamed")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), pixels_per_line=PIX))
    out = os.path.join(data["dir"], f"cli{stream}")
    os.mkdir(out)
    argv = ["scene", "--pan1", files["pan1"], "--pan2", files["pan2"],
            "--mss", files["mss"], "--rrc-pan1", files["rrc_pan1"],
            "--rrc-pan2", files["rrc_pan2"], "--mss2", files["mss2"],
            "--slices", str(SLICES), "-s", str(STT), "-c", str(FOLD),
            "--out-dir", out, "-o", os.path.join(out, "STITCHED.RAW"),
            "--device", "cpu", "--mesh", "4"]
    for b in range(1, 5):
        argv += [f"--rrc-msb{b}", files[f"rrc_msb{b}"],
                 f"--rrc-m2b{b}", files[f"rrc_m2b{b}"]]
    if stream:
        argv += ["--stream", "--stream-section-lines", "384"]
    assert cli.main(argv) == 0
    want = single_runs["resident"]
    for key in KEYS:
        with open(os.path.join(out, os.path.basename(want[key])), "rb") as a, \
                open(want[key], "rb") as b:
            assert a.read() == b.read(), key

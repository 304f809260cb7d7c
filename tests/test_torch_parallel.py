"""The port's line mesh (parallel/, models/sharded_*) on the CPU: shards on
``LineMesh([cpu] * N)`` against the port's one-shard and single-device
routes (exact) and against the JAX package's mesh routes on its 8-device
virtual CPU mesh; the offset-write drains; ``--mesh`` and the
``OIP_DIST_*`` launch variables through the CLI."""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from opticalimageprocessor_tpu.formats.rrc_csv import save_rrc_params
from opticalimageprocessor_tpu.models import sharded_prestitch as jprestitch
from opticalimageprocessor_tpu.ops import cv_exact
from opticalimageprocessor_tpu.ops import resample as jres
from opticalimageprocessor_tpu.ops import rrc as jrrc
from opticalimageprocessor_tpu.parallel import halo as jhalo
from opticalimageprocessor_tpu.parallel import mesh as jmesh
from opticalimageprocessor_tpu.parallel import sharded as jsharded
from opticalimageprocessor_tpu_torch import cli
from opticalimageprocessor_tpu_torch.io import tiff as ttiff
from opticalimageprocessor_tpu_torch.models import preprocessor as tpre
from opticalimageprocessor_tpu_torch.models import sharded_align as talign
from opticalimageprocessor_tpu_torch.models import sharded_prestitch as tpst
from opticalimageprocessor_tpu_torch.ops import resample
from opticalimageprocessor_tpu_torch.ops.rrc import params_from_jax_split
from opticalimageprocessor_tpu_torch.parallel import distributed, halo, sharded
from opticalimageprocessor_tpu_torch.parallel.mesh import LineMesh, line_mesh

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cpu_mesh(n):
    return LineMesh(["cpu"] * n)


def _split(k, b):
    """JAX's six-row float32 split and the port's float64 pair rebuilt from
    it: both packages then compute the same RRC."""
    s = np.asarray(jrrc.split_rrc_params(k, b))
    return s, params_from_jax_split(s)


def _envelope(got, want, what):
    """The fast remaps' envelope (tests/test_torch_row_pass.py): within
    1 DN on < 1% of pixels."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (what, d.max(),
                                                     (d > 0).mean())


def _curve_diff(a, b, width):
    x = np.linspace(0.0, width, 257)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return max(np.abs(sum(a[k] * x**k for k in range(a.size))
                      - sum(b[k] * x**k for k in range(b.size))).max(), 0.0)


# -- the mesh and the halo exchange ----------------------------------------

@pytest.mark.parametrize("rows, n, unit", [(64, 8, 1), (61, 8, 1),
                                           (5, 4, 1), (1200, 8, 4),
                                           (300, 8, 1), (12, 1, 4)])
def test_shard_bounds_are_jax_layout_without_padding(rows, n, unit):
    """Consecutive row ranges covering the strip, each a multiple of
    ``unit`` but the last, as long as JAX's padded shards (rows rounded up
    to the mesh); a PAN cut with unit 4 and its MSS with unit 1 line up."""
    b = sharded.shard_bounds(rows, n, unit)
    assert b[0][0] == 0 and b[-1][1] == rows and len(b) == n
    assert all(b[i][1] == b[i + 1][0] for i in range(n - 1))
    assert all((e - a) % unit == 0 for a, e in b if e < rows)
    assert max(e - a for a, e in b) == unit * -(-rows // (n * unit))
    if unit == 4:
        assert [(a // 4, e // 4) for a, e in b] == sharded.shard_bounds(
            rows // 4, n)


@pytest.mark.parametrize("rows, n", [(64, 8), (61, 8), (5, 4), (64, 1)])
def test_exchange_halo_matches_concat(rng, rows, n):
    """Each extended shard is the strip's rows around it, zeros beyond the
    ends (exactly), also where a halo reaches past an uneven or empty
    neighbour; the clipped form is the same rows without the zeros."""
    x = rng.random((rows, 16), dtype=np.float32)
    xs = sharded.ingest_line_sharded(cpu_mesh(n), x)
    top, bottom = 3, 2
    padded = np.concatenate([np.zeros((top, 16), np.float32), x,
                             np.zeros((bottom, 16), np.float32)])
    got = halo.exchange_halo(xs, top, bottom)
    clipped = halo.clipped_halo(xs, top, bottom)
    for i in range(n):
        a, b = xs.bounds(i)
        np.testing.assert_array_equal(got[i].numpy(), padded[a:b + top + bottom])
        win, t = clipped[i]
        assert t == min(top, a)
        np.testing.assert_array_equal(win.numpy(),
                                      x[a - t:min(b + bottom, rows)])


def test_exchange_halo_matches_jax(rng):
    """Against JAX's ppermute halo exchange under shard_map on its 8-device
    mesh, exactly."""
    x = rng.random((64, 16), dtype=np.float32)
    top, bottom = 3, 2
    m = jmesh.line_mesh(8)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda xl: jhalo.exchange_halo(xl, top, bottom, "line"), mesh=m,
        in_specs=P("line", None), out_specs=P("line", None),
        check_vma=False))(x)).reshape(8, -1, 16)
    got = halo.exchange_halo(sharded.ingest_line_sharded(cpu_mesh(8), x),
                             top, bottom)
    for d in range(8):
        np.testing.assert_array_equal(got[d].numpy(), want[d])


def test_line_sharded_rows_and_views(rng):
    """rows_on gathers across shards (columns too), drop_rows trims, band()
    takes a band of a (bands, rows, W) raster, host_blocks walks the rows
    in order."""
    x = rng.integers(0, 65536, (4, 37, 12), dtype=np.uint16)
    xs = sharded.ingest_line_sharded(cpu_mesh(4), x, 1)
    assert xs.shape == (4, 37, 12) and xs.rows == 37
    np.testing.assert_array_equal(xs.rows_on(5, 30, "cpu", (2, 7)).numpy(),
                                  x[:, 5:30, 2:7])
    got = xs.rows_on(-2, 40, "cpu").numpy()
    assert (got[:, :2] == 0).all() and (got[:, -3:] == 0).all()
    np.testing.assert_array_equal(got[:, 2:-3], x)
    np.testing.assert_array_equal(xs.drop_rows(11).gather().numpy(),
                                  x[:, 11:])
    band = xs.band(2)
    np.testing.assert_array_equal(band.gather().numpy(), x[2])
    np.testing.assert_array_equal(
        np.concatenate([blk for _, blk in band.host_blocks(3, 30, 4)]),
        x[2, 3:30])


def test_mesh_must_be_one_device_type_and_cuda_present(monkeypatch):
    with pytest.raises(ValueError, match="one type"):
        LineMesh(["cpu", "meta"])
    assert line_mesh(3, "cpu").devices == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        line_mesh(2, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError,
                       match="--mesh 2 needs 2 devices, only 1 available"):
        line_mesh(2, "cuda")
    # "cuda" is the current device, with its index (tensors carry it)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert LineMesh(["cuda", "cuda:1"]).devices == [
        torch.device("cuda", 0), torch.device("cuda", 1)]


# -- remap_band_dynamic ------------------------------------------------------

CX, CY = [1.25, 2e-4], [-0.5, 1e-4, 2e-8]


@pytest.mark.parametrize("rows, n", [(128, 4), (130, 4), (130, 8)])
def test_remap_band_dynamic_shards_equal_one_shard(rng, rows, n):
    """4 or 8 shards (uneven too) give the one-shard remap exactly: each
    shard reads its neighbours' true rows and 0 past the strip ends."""
    band = rng.integers(0, 65536, (rows, 64), dtype=np.uint16)
    cx = np.float32(CX)
    cy = np.float32(CY)
    one = sharded.remap_band_dynamic(
        sharded.ingest_line_sharded(cpu_mesh(1), band), cx, cy).gather()
    many = sharded.remap_band_dynamic(
        sharded.ingest_line_sharded(cpu_mesh(n), band), cx, cy).gather()
    assert torch.equal(one, many)
    np.testing.assert_array_equal(one.numpy(), resample.remap_band_fast(
        torch.from_numpy(band), cx, cy, sharded.ROW_OFF_BOUND).numpy())


def test_remap_band_dynamic_matches_jax(rng):
    """Against JAX's sharded remap_band_dynamic (ppermute halos, 8
    devices): the fast remaps' envelope of tests/test_torch_row_pass.py."""
    rows, width = 128, 64
    band = rng.integers(0, 65536, (rows, width), dtype=np.uint16)
    cx = jnp.asarray(CX, jnp.float32)
    cy = jnp.asarray(CY, jnp.float32)
    m = jmesh.line_mesh(8)

    def local(bl):
        y0 = jax.lax.axis_index("line").astype(jnp.int32) * (rows // 8)
        return jsharded.remap_band_dynamic(bl, cx, cy, y0, "line")

    want = np.asarray(jax.jit(jax.shard_map(
        local, mesh=m, in_specs=P("line", None), out_specs=P("line", None),
        check_vma=False))(band))
    got = sharded.remap_band_dynamic(
        sharded.ingest_line_sharded(cpu_mesh(4), band), np.float32(CX),
        np.float32(CY)).gather().numpy()
    _envelope(got, want, "remap_band_dynamic")


# -- make_align_step ----------------------------------------------------------

# the sizes of test_parallel.py:116 (1504 MSS lines, 512 px)
ALIGN_W, ALIGN_LINES = 512, 6016     # PAN lines


def _align_scene(rng, lines_pan=ALIGN_LINES, width=ALIGN_W):
    """PAN = x4 upsample of noise, bands rolled by (b mod 2, b - 1), both
    inverse-RRC'd by random per-column near-identity parameters."""
    band_px = width // 4
    scene_lr = rng.integers(2000, 42000, (lines_pan // 4, band_px)).astype(
        np.float32)
    pan_true = np.clip(np.rint(np.asarray(jres.upsample4_f32(scene_lr))),
                       0, 65535)
    bands = np.stack([np.roll(scene_lr, (b % 2, b - 1), (0, 1))
                      for b in range(4)])
    kp = 0.98 + 0.04 * rng.random(width)
    bp = rng.normal(0, 20, width)
    kb = 0.98 + 0.04 * rng.random((4, band_px))
    bb = rng.normal(0, 20, (4, band_px))
    pan = np.clip(np.rint((pan_true - bp) / kp), 0, 65535).astype(np.uint16)
    mss = np.clip(np.rint((bands - bb[:, None]) / kb[:, None]), 0,
                  65535).astype(np.uint16)
    jpan, tpan = _split(kp, bp)
    js = [_split(kb[b], bb[b]) for b in range(4)]
    jmss = np.stack([s[0] for s in js])
    tmss = (np.stack([s[1][0] for s in js]), np.stack([s[1][1] for s in js]))
    return pan, mss, (jpan, jmss), (tpan, tmss)


@pytest.fixture(scope="module")
def align_runs():
    rng = np.random.default_rng(21)
    pan, mss, jp, tp = _align_scene(rng)
    out = {"inputs": (pan, mss, jp, tp)}
    jm = jmesh.line_mesh(4)
    for quantized in (False, True):
        jstep = jsharded.make_align_step(jm, slices=8, sections=1,
                                         quantized=quantized)
        a, cx, cy = jstep(pan, mss, *jp)
        out["jax", quantized] = (np.asarray(a), np.asarray(cx),
                                 np.asarray(cy))
        for n in (1, 4):
            step = sharded.make_align_step(cpu_mesh(n), slices=8, sections=1,
                                           quantized=quantized,
                                           want_pan_c=True)
            a, cx, cy, pan_c = step(pan, mss, *tp)
            out["port", quantized, n] = (a.gather().numpy(), cx, cy,
                                         pan_c.gather().numpy())
    return out


@pytest.mark.parametrize("quantized", [False, True])
def test_align_step_shards_equal_one_shard(align_runs, quantized):
    """4 shards against 1: the same coefficients and the same aligned
    raster, exactly; the corrected PAN is the RRC of the strip."""
    a1, cx1, cy1, pc1 = align_runs["port", quantized, 1]
    a4, cx4, cy4, pc4 = align_runs["port", quantized, 4]
    np.testing.assert_array_equal(cx1, cx4)
    np.testing.assert_array_equal(cy1, cy4)
    np.testing.assert_array_equal(a1, a4)
    np.testing.assert_array_equal(pc1, pc4)
    assert a4.shape == (ALIGN_LINES // 4, ALIGN_W // 4, 4)


@pytest.mark.parametrize("quantized", [False, True])
def test_align_step_coefficients_match_jax(align_runs, quantized):
    """The fitted curves within the 1e-3 px fast-mode envelope of JAX's
    (same tiles, same float64 fit; the FFTs differ in the last bits)."""
    _, jcx, jcy = align_runs["jax", quantized]
    _, cx, cy, _ = align_runs["port", quantized, 4]
    for b in range(4):
        assert _curve_diff(cx[b], jcx[b], ALIGN_W) <= 1e-3, b
        assert _curve_diff(cy[b], jcy[b], ALIGN_W) <= 1e-3, b


def _mss_c(align_runs, n):
    _, mss, _, (_, tmss) = align_runs["inputs"]
    return sharded.rrc_sharded(sharded.ingest_line_sharded(cpu_mesh(n), mss,
                                                           1), *tmss)


def test_align_step_pinned_continuous_matches_jax(align_runs):
    """JAX's coefficients pinned into the port's sharded fast remap
    (kernel (e)'s route): within the fast envelope of JAX's aligned."""
    ja, jcx, jcy = align_runs["jax", False]
    mss_c = _mss_c(align_runs, 4)
    got = sharded.interleave([
        sharded.remap_band_dynamic(mss_c.band(b), jcx[b].astype(np.float32),
                                   jcy[b].astype(np.float32))
        for b in range(4)]).gather().numpy()
    _envelope(got, ja, "aligned")


def _oracle_aligned(src, cx, cy, quantized):
    """cv_exact.remap_cubic_u16_exact of each band with whole-image maps
    (mapx per column, mapy = float32(y + G) from the strip's row 0)."""
    rows, width = src.shape[1:]
    out = np.empty((rows, width, 4), np.uint16)
    for b in range(4):
        plan = resample.plan_for_band_alignment(cx[b], cy[b], width,
                                                quantized)
        xx = np.arange(width, dtype=np.float64) * 4.0
        mapx_cols = (float(cx[b][1]) * xx + float(cx[b][0]) + xx) / 4.0
        mapx = np.tile(mapx_cols.astype(np.float32)[None], (rows, 1))
        mapy = (np.arange(rows, dtype=np.float64)[:, None]
                + plan.g[None]).astype(np.float32)
        out[..., b] = cv_exact.remap_cubic_u16_exact(
            src[b], mapx, mapy, quantized_coords=quantized)
    return out


@pytest.mark.parametrize("n", [1, 4])
def test_align_step_pinned_quantized_matches_oracle(align_runs, n):
    """JAX's coefficients pinned into the port's sharded parity remap
    (quantized grid): 0 DN to the cv::remap oracle with whole-image maps,
    on 1 and 4 shards; JAX's own quantized mesh is within 1 DN of it."""
    ja, jcx, jcy = align_runs["jax", True]
    mss_c = _mss_c(align_runs, n)
    got = sharded.plan_remap_sharded(mss_c, jcx, jcy, True).gather().numpy()
    want = _oracle_aligned(mss_c.gather().numpy(), jcx, jcy, True)
    np.testing.assert_array_equal(got, want)
    assert np.abs(ja.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("quantized", [False, True])
def test_align_step_line_offset(align_runs, quantized):
    """``line_offset`` aligns the rows from it on, with the rows above it
    outside the strip: 4 shards equal 1, and the result is the remap of the
    trimmed bands."""
    pan, mss, _, tp = align_runs["inputs"]
    outs = []
    for n in (1, 4):
        step = sharded.make_align_step(cpu_mesh(n), slices=8, sections=1,
                                       quantized=quantized)
        a, cx, cy = step(pan, mss, *tp, line_offset=37)
        outs.append((a.gather().numpy(), cx, cy))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    a, cx, cy = outs[1]
    assert a.shape == (ALIGN_LINES // 4 - 37, ALIGN_W // 4, 4)
    trimmed = _mss_c(align_runs, 1).drop_rows(37)
    if quantized:
        want = _oracle_aligned(trimmed.gather().numpy(), cx, cy, True)
    else:
        want = np.stack([resample.remap_band_fast(
            trimmed.band(b).gather(), cx[b].astype(np.float32),
            cy[b].astype(np.float32)).numpy() for b in range(4)], -1)
    np.testing.assert_array_equal(a, want)


def test_align_step_min_count_error():
    """Flat tiles give no valid sample: the reference's min-count error
    (test_parallel.py:193), not a fit of garbage."""
    width, band_px = 512, 128
    pan = np.full((256, width), 9000, np.uint16)
    mss = np.full((4, 64, band_px), 9000, np.uint16)
    ones = (np.ones(width), np.zeros(width))
    bands = (np.ones((4, band_px)), np.zeros((4, band_px)))
    step = sharded.make_align_step(cpu_mesh(8), slices=8, sections=1)
    with pytest.raises(RuntimeError, match="Not enough valid correlation"):
        step(pan, mss, ones, bands)


# -- the sharded prestitch -----------------------------------------------------

PST_PPL, PST_OV = 1024, 64


def _write_pair(d, rng, lines, dy=2):
    """CMOS1 / CMOS2 cut from one noise terrain (test_parallel.py:463):
    CMOS2's first PST_OV columns see CMOS1's last ones 3 px on, ``dy``
    rows down; random near-identity RRC CSVs."""
    terrain = rng.integers(2000, 42000, (lines + 16, 2 * PST_PPL)).astype(
        np.uint16)
    files = {"pan1": os.path.join(d, "C1.PAN.RAW"),
             "pan2": os.path.join(d, "C2.PAN.RAW")}
    terrain[4:4 + lines, :PST_PPL].tofile(files["pan1"])
    terrain[4 + dy:4 + dy + lines,
            PST_PPL - PST_OV + 3:2 * PST_PPL - PST_OV + 3].tofile(
        files["pan2"])
    for name in ("rrc1", "rrc2"):
        files[name] = os.path.join(d, f"{name}.csv")
        save_rrc_params(files[name], np.stack(
            [0.98 + 0.04 * rng.random(PST_PPL),
             rng.normal(0, 20, PST_PPL)], 1))
    return files


PST_KW = dict(sections=3, line_per_section=128, overlap_cols=PST_OV,
              threshold=0.05, pixels_per_line=PST_PPL)


@pytest.fixture(scope="module")
def prestitch_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pst"))
    files = _write_pair(d, np.random.default_rng(31), 644)
    out = {"files": files}
    for name, fn, mesh in (("jax", jprestitch.run_sharded_prestitch, 8),
                           ("port8", tpst.run_sharded_prestitch,
                            cpu_mesh(8)),
                           ("port1", tpst.run_sharded_prestitch,
                            cpu_mesh(1))):
        od = os.path.join(d, name)
        os.mkdir(od)
        out[name] = fn(files["pan1"], files["pan2"], files["rrc1"],
                       files["rrc2"], n_devices=mesh, out_dir=od, **PST_KW)
    return out


def _read(path, ppl=PST_PPL):
    return np.fromfile(path, "<u2").reshape(-1, ppl)


def test_sharded_prestitch_shards_equal_one_shard(prestitch_runs):
    """8 uneven shards (644 lines) and 1: the same deltas and byte-identical
    RRC and PRESTT files."""
    dx8, dy8, p8 = prestitch_runs["port8"]
    dx1, dy1, p1 = prestitch_runs["port1"]
    assert (dx8, dy8) == (dx1, dy1)
    for name in ("C1.PAN.RRC.RAW", "C2.PAN.RRC.RAW", "C2.PAN.RRC.PRESTT.RAW"):
        with open(os.path.join(os.path.dirname(p8), name), "rb") as a, \
                open(os.path.join(os.path.dirname(p1), name), "rb") as b:
            assert a.read() == b.read(), name


def test_sharded_prestitch_matches_jax(prestitch_runs):
    """Against JAX's run_sharded_prestitch on its 8-device mesh: deltas
    within 1e-3 px (tests/test_torch_stitcher.py's bar) and the recovered
    translation, the RRC files byte for byte, and JAX's deltas pinned into
    the port's sharded remap within the fast envelope of JAX's PRESTT."""
    jdx, jdy, jpath = prestitch_runs["jax"]
    dx, dy, path = prestitch_runs["port8"]
    assert abs(dx - jdx) <= 1e-3 and abs(dy - jdy) <= 1e-3, (dx, dy, jdx, jdy)
    assert abs(dx + 3) < 0.3 and abs(dy + 2) < 0.3, (dx, dy)
    jdir, pdir = os.path.dirname(jpath), os.path.dirname(path)
    for name in ("C1.PAN.RRC.RAW", "C2.PAN.RRC.RAW"):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(pdir, name), "rb") as b:
            assert a.read() == b.read(), name
    _, _, remap = sharded.make_prestitch_step(cpu_mesh(8), 3, 128, PST_OV)
    rrc2 = _read(os.path.join(pdir, "C2.PAN.RRC.RAW"))
    got = remap(sharded.ingest_line_sharded(cpu_mesh(8), rrc2), jdx,
                jdy).gather().numpy()
    _envelope(got, _read(jpath), "prestt")
    assert os.path.getsize(path) == 644 * PST_PPL * 2


def test_prestitch_correlate_matches_jax(prestitch_runs):
    """make_prestitch_step's correlate against JAX's, section by section,
    within 1e-3 px; only_calculate stops after the estimate."""
    files = prestitch_runs["files"]
    p1, p2 = (_read(files[k]) for k in ("pan1", "pan2"))
    jc, _, _ = jsharded.make_prestitch_step(jmesh.line_mesh(4), 3, 128,
                                            PST_OV)
    want = [np.asarray(v) for v in jc(p1, p2)]
    pc, _, _ = sharded.make_prestitch_step(cpu_mesh(4), 3, 128, PST_OV)
    got = pc(p1, p2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
    dx, dy, path = tpst.run_sharded_prestitch(
        files["pan1"], files["pan2"], n_devices=cpu_mesh(4),
        only_calculate=True, **PST_KW)
    assert path is None and abs(dx + 3) < 0.3


def test_sharded_prestitch_no_valid_delta(tmp_path):
    """Flat strips give no valid correlation: the reference's error
    (test_parallel.py:510)."""
    flat = np.full((512, 1024), 9000, np.uint16)
    p1, p2 = str(tmp_path / "f1.PAN.RAW"), str(tmp_path / "f2.PAN.RAW")
    flat.tofile(p1)
    flat.tofile(p2)
    with pytest.raises(RuntimeError, match="No valid delta value found"):
        tpst.run_sharded_prestitch(
            p1, p2, n_devices=cpu_mesh(8), sections=3, line_per_section=128,
            overlap_cols=64, threshold=0.9, do_rrc=False,
            out_dir=str(tmp_path), pixels_per_line=1024)


# -- the sharded align on files (test_parallel.py:759-946 counterparts) -------

AL_W = 512


@pytest.fixture(scope="module")
def align_files(tmp_path_factory):
    """A 1500-line MSS strip (6000 PAN lines): neither divides 8."""
    d = str(tmp_path_factory.mktemp("al"))
    pan, mss, _, (tpan, tmss) = _align_scene(np.random.default_rng(41),
                                             6000, AL_W)
    files = {"pan": os.path.join(d, "C1.PAN.RAW"),
             "mss": os.path.join(d, "C1.MSS.RAW"),
             "rrc_pan": os.path.join(d, "pan.csv")}
    pan.tofile(files["pan"])
    np.ascontiguousarray(mss.transpose(1, 0, 2)).tofile(files["mss"])
    save_rrc_params(files["rrc_pan"], np.stack(tpan, 1))
    for b in range(4):
        files[f"rrc_b{b}"] = os.path.join(d, f"b{b}.csv")
        save_rrc_params(files[f"rrc_b{b}"], np.stack(
            [tmss[0][b], tmss[1][b]], 1))
    return d, files


def _bands(files):
    return tuple(files[f"rrc_b{b}"] for b in range(4))


def test_mesh_quantized_and_rrcpan_equal_host(align_files):
    """``--coord-mode quantized`` and ``--write-rrcpan`` on 8 uneven shards:
    the aligned raster equals the host PreProcessor's parity route (one
    whole-strip section: whole-image maps, the cv::remap oracle's bytes),
    and the RRC PAN TIFF is its file, byte for byte."""
    d, files = align_files
    host = os.path.join(d, "host_q")
    os.mkdir(host)
    pp = tpre.PreProcessor(files["pan"], files["mss"], files["rrc_pan"],
                           _bands(files), pixels_per_line=AL_W,
                           quantized_coords=True, out_dir=host, device="cpu")
    pp.load_and_rrc(do_rrc_pan=True, do_rrc_mss=True)
    host_rrc = pp.write_rrc_pan_tiff(0)
    pp.calc_inter_band_correlation(slices=8, sections=1)
    want = pp.do_inter_band_alignment(line_per_section=1500,
                                      keep_leading_lines=True,
                                      write_tiff=False)
    out = os.path.join(d, "mesh_q")
    os.mkdir(out)
    got = talign.run_sharded_align(
        files["pan"], files["mss"], files["rrc_pan"], _bands(files),
        n_devices=cpu_mesh(8), do_rrc_pan=True, slices=8, sections=1,
        keep_leading_lines=True, out_dir=out, pixels_per_line=AL_W,
        write_tiff=False, quantized_coords=True, write_rrcpan=True)
    np.testing.assert_array_equal(got, want)
    with open(host_rrc, "rb") as a, \
            open(os.path.join(out, os.path.basename(host_rrc)), "rb") as b:
        assert a.read() == b.read()


def test_mesh_align_uneven_matches_jax_and_one_shard(align_files):
    """The fast route on 8 uneven shards: the ALIGNED.TIFF of 1 shard byte
    for byte, and JAX's mesh route (its zero-pad / mask / trim) within the
    estimate-dependent gates of test_parallel.py:833: mean < 1 DN, > 10 DN
    on < 0.1%, the last rows no worse than the interior."""
    from opticalimageprocessor_tpu.models.sharded_align import (
        run_sharded_align as jrun,
    )

    d, files = align_files
    kw = dict(do_rrc_pan=True, slices=8, sections=1, pixels_per_line=AL_W)
    paths = []
    for n in (8, 1):
        out = os.path.join(d, f"mesh{n}")
        os.mkdir(out)
        paths.append(talign.run_sharded_align(
            files["pan"], files["mss"], files["rrc_pan"], _bands(files),
            n_devices=cpu_mesh(n), out_dir=out, **kw))
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    got = ttiff.read_tiff(paths[0]).astype(np.int64)
    want = jrun(files["pan"], files["mss"], files["rrc_pan"], _bands(files),
                n_devices=8, out_dir=os.path.join(d, "mesh8"),
                write_tiff=False, **kw)[:, :, [2, 1, 0, 3]]
    assert got.shape == want.shape == (1500 - 520, AL_W // 4, 4)
    diff = np.abs(got - want.astype(np.int64))
    assert diff.mean() < 1.0 and (diff > 10).mean() < 1e-3, diff.mean()
    assert diff[-8:].mean() < max(1.0, 3 * diff.mean() + 0.5)


# -- the offset-write drains ---------------------------------------------------

@pytest.mark.parametrize("samples, row0", [(1, 0), (4, 0), (4, 17)])
def test_tiff_drain_equals_the_sequential_writer(rng, tmp_path, samples,
                                                 row0):
    """The shell + offset writes give the sequential TiffStripWriter's
    file byte for byte (4 uneven shards, a channel order, a leading
    trim)."""
    shape = (1100, 24) if samples == 1 else (1100, 24, 4)
    x = rng.integers(0, 65536, shape, dtype=np.uint16)
    xs = sharded.ingest_line_sharded(cpu_mesh(4), x)
    order = [2, 1, 0, 3] if samples == 4 else None
    want = x[row0:1000]
    if order:
        want = want[..., order]
    seq = str(tmp_path / "seq.tif")
    w = ttiff.TiffStripWriter(seq, 24, 1000 - row0, samples=samples)
    w.write_rows(want)
    w.close()
    got = distributed.drain_line_sharded_to_tiff(
        xs, str(tmp_path / "drain.tif"), total=1000, order=order, row0=row0)
    with open(seq, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


def test_raw_drain_writes_rows_in_place(rng, tmp_path):
    x = rng.integers(0, 65536, (77, 16), dtype=np.uint16)
    xs = sharded.ingest_line_sharded(cpu_mesh(8), x)
    path = distributed.drain_line_sharded_to_raw(xs, str(tmp_path / "x.RAW"),
                                                 16, total=70)
    np.testing.assert_array_equal(np.fromfile(path, "<u2").reshape(-1, 16),
                                  x[:70])


# -- the CLI ---------------------------------------------------------------------

def _align_argv(files, out, *extra):
    argv = ["--pan", files["pan"], "--mss", files["mss"], "--do-rrc4pan",
            "--rrc-pan", files["rrc_pan"], "--slices", "8",
            "--ibc-sections", "1", "--out-dir", out]
    for b in range(4):
        argv += [f"--rrc-msb{b + 1}", files[f"rrc_b{b}"]]
    return argv + list(extra)


def test_cli_default_action_mesh_on_the_cpu(align_files, monkeypatch):
    """``--device cpu --mesh 4`` (quantized, with --write-rrcpan) through
    cli.main: the model API's files on one shard, byte for byte."""
    d, files = align_files
    monkeypatch.setattr(talign, "run_sharded_align", functools.partial(
        talign.run_sharded_align, pixels_per_line=AL_W))
    out = os.path.join(d, "cli")
    os.mkdir(out)
    assert cli.main(_align_argv(files, out, "--mesh", "4", "--coord-mode",
                                "quantized", "--write-rrcpan", "--device",
                                "cpu")) == 0
    ref = os.path.join(d, "cli_ref")
    os.mkdir(ref)
    talign.run_sharded_align(
        files["pan"], files["mss"], files["rrc_pan"], _bands(files),
        n_devices=cpu_mesh(1), do_rrc_pan=True, slices=8, sections=1,
        out_dir=ref, quantized_coords=True, write_rrcpan=True)
    for name in ("C1.MSS.ALIGNED.TIFF", "C1.PAN.RRC.TIFF"):
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name


def test_cli_prestitch_mesh_on_the_cpu(prestitch_runs, monkeypatch,
                                       tmp_path):
    """``prestitch --device cpu --mesh 4`` through cli.main: the 8-shard
    model run's files byte for byte."""
    files = prestitch_runs["files"]
    monkeypatch.setattr(tpst, "run_sharded_prestitch", functools.partial(
        tpst.run_sharded_prestitch, pixels_per_line=PST_PPL))
    argv = ["prestitch", "--pan1", files["pan1"], "--pan2", files["pan2"],
            "--rrc1", files["rrc1"], "--rrc2", files["rrc2"], "-s", "3",
            "-l", "128", "--stitch-overlap", str(PST_OV), "--stt-threshold",
            "0.05", "--out-dir", str(tmp_path), "--mesh", "4", "--device",
            "cpu"]
    assert cli.main(argv) == 0
    ref = os.path.dirname(prestitch_runs["port8"][2])
    for name in ("C1.PAN.RRC.RAW", "C2.PAN.RRC.RAW", "C2.PAN.RRC.PRESTT.RAW"):
        with open(tmp_path / name, "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("cmd", ["default", "prestitch", "scene"])
def test_cli_mesh_cuda_without_cuda_is_rc2(align_files, prestitch_runs, cmd,
                                           monkeypatch, caplog, tmp_path):
    """``--mesh 2 --device cuda`` where CUDA is absent raises (rc 2, the
    message names CUDA): the mesh never runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(talign, "run_sharded_align", functools.partial(
        talign.run_sharded_align, pixels_per_line=AL_W))
    _, files = align_files
    pf = prestitch_runs["files"]
    argv = {
        "default": _align_argv(files, str(tmp_path)),
        "prestitch": ["prestitch", "--pan1", pf["pan1"], "--pan2",
                      pf["pan2"], "-s", "1", "-l", "64"],
        "scene": ["scene", "--pan1", pf["pan1"], "--pan2", pf["pan2"],
                  "--mss", pf["pan1"]],
    }[cmd]
    caplog.clear()
    assert cli.main(argv + ["--mesh", "2", "--device", "cuda"]) == 2
    assert "CUDA is not available" in caplog.text
    assert not os.listdir(tmp_path)


def _run_cli_subprocess(env_extra, drop, argv, prelude=""):
    env = dict(os.environ)
    for k in drop:
        env.pop(k, None)
    env.update(env_extra)
    env["PYTHONPATH"] = ROOT
    return subprocess.run(
        [sys.executable, "-c",
         "import sys\nfrom opticalimageprocessor_tpu_torch.cli import main\n"
         f"{prelude}sys.exit(main({argv!r}))"],
        env=env, capture_output=True, text=True, timeout=180, cwd=ROOT)


@pytest.mark.parametrize("env, drop, names", [
    ({"OIP_DIST_COORD": "127.0.0.1:1"}, ["OIP_DIST_NPROCS", "OIP_DIST_PROCID"],
     "OIP_DIST_NPROCS"),
    ({"OIP_DIST_COORD": "127.0.0.1:1", "OIP_DIST_NPROCS": "2"},
     ["OIP_DIST_PROCID"], "OIP_DIST_PROCID"),
    ({"OIP_DIST_COORD": "127.0.0.1:1", "OIP_DIST_NPROCS": "2",
      "OIP_DIST_PROCID": "2"}, [], "OIP_DIST_PROCID=2 outside"),
])
def test_cli_fails_loudly_on_a_partial_distributed_env(env, drop, names,
                                                       tmp_path):
    """A partial OIP_DIST_* env aborts the CLI before any work, naming the
    variable (the JAX CLI's regression test, test_parallel.py:947): no
    output file is written."""
    a = tmp_path / "L.RAW"
    np.zeros((4, 12288), np.uint16).tofile(a)
    out = tmp_path / "O.RAW"
    res = _run_cli_subprocess(env, drop, [
        "stitch", "--image1", str(a), "--image2", str(a), "-o", str(out),
        "-c", "4"])
    assert res.returncode != 0
    assert names in res.stderr + res.stdout
    assert not out.exists()


def test_cli_refuses_a_complete_distributed_env(tmp_path):
    """A complete OIP_DIST_* env whose peer never joins is refused within
    the join timeout (lowered here from 300 s to 3 s): a non-zero rc
    naming the coordinator, no output -- one process never runs alone in
    place of N, and never hangs."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    a = tmp_path / "L.RAW"
    np.zeros((4, 12288), np.uint16).tofile(a)
    out = tmp_path / "O.RAW"
    res = _run_cli_subprocess(
        {"OIP_DIST_COORD": f"127.0.0.1:{port}", "OIP_DIST_NPROCS": "2",
         "OIP_DIST_PROCID": "0"}, [],
        ["stitch", "--image1", str(a), "--image2", str(a), "-o", str(out),
         "-c", "4"],
        prelude="from opticalimageprocessor_tpu_torch.parallel import "
                "distributed\ndistributed._DEFAULT_TIMEOUT_S = 3.0\n")
    assert res.returncode != 0
    assert (f"process 0 of 2 could not join the process group at "
            f"127.0.0.1:{port} within 3 s") in res.stderr + res.stdout
    assert not out.exists()

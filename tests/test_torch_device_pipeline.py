"""Port scene pipeline (models/device_pipeline) against the JAX package:
the float64 fit, the fast registration and the stt estimate on the same
strips, and the module's staged/fused forms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu.models import device_pipeline as jdp
from opticalimageprocessor_tpu.ops import resample as jres
from opticalimageprocessor_tpu.ops import rrc as jrrc
from opticalimageprocessor_tpu_torch.models import device_pipeline as dp

torch.set_num_threads(2)

STRIP_X = np.linspace(0.0, 3072.0, 513)


def _eval(c, x=STRIP_X):
    c = np.asarray(c, np.float64)
    return sum(c[k] * x**k for k in range(c.size))


@pytest.mark.parametrize("deg", [1, 2])
def test_fit_poly_matches_jax(rng, deg):
    cx = np.tile((np.arange(10) * 1228.8 + 614.4).astype(np.float32), 5)
    y = (0.73 + 2.1e-4 * cx - 3.7e-9 * cx.astype(np.float64) ** 2
         + rng.normal(0, 0.03, cx.size)).astype(np.float32)
    w = (rng.random(cx.size) > 0.2).astype(np.float32)
    want = np.asarray(
        jdp._fit_poly(jnp.asarray(cx), jnp.asarray(y), deg, jnp.asarray(w))
    )
    got = dp._fit_poly(torch.from_numpy(cx), torch.from_numpy(y), deg,
                       torch.from_numpy(w)).numpy()
    x = np.linspace(0.0, 12288.0, 2049)
    assert np.abs(_eval(got, x) - _eval(want, x)).max() <= 1e-5


def _scene(rng, lines_mss=512, band_px=768):
    """tests/test_device_pipeline.py:28-41's geometry: PAN = x4 upsample
    of a noise scene, band b = the scene rolled by (vy[b], vx[b])."""
    scene = rng.integers(2000, 42000, (lines_mss, band_px)).astype(np.uint16)
    pan = np.clip(
        np.rint(np.asarray(jres.upsample4_f32(scene.astype(np.float32)))),
        0, 65535,
    ).astype(np.uint16)
    vy, vx = [0, -1, 1, 0], [1, 0, -1, 2]
    mss = np.stack(
        [np.roll(np.roll(scene, vy[b], 0), vx[b], 1) for b in range(4)]
    )
    return pan, mss


@pytest.mark.parametrize("inline_rrc", [False, True], ids=["raw", "rrc"])
def test_register_fast_matches_jax(rng, inline_rrc):
    pan, mss = _scene(rng)
    jkw, tkw = {}, {}
    if inline_rrc:
        pk, pb = 0.98 + 0.04 * rng.random(3072), rng.normal(0, 20, 3072)
        mk, mb = 0.99 + 0.02 * rng.random((4, 768)), rng.normal(0, 10,
                                                                (4, 768))
        jkw = dict(
            pan_params=jnp.asarray(jrrc.split_rrc_params(pk, pb)),
            mss_params=jnp.asarray(
                np.stack([jrrc.split_rrc_params(mk[i], mb[i])
                          for i in range(4)])
            ),
        )
        tkw = dict(
            pan_params=(torch.from_numpy(pk), torch.from_numpy(pb)),
            mss_params=(torch.from_numpy(mk), torch.from_numpy(mb)),
        )
    want, nv_want = jdp.register_fast(
        jnp.asarray(pan), jnp.asarray(mss), slices=8, n_sections=1,
        win=(16, 16), **jkw,
    )
    got, nv_got = dp.register_fast(
        torch.from_numpy(pan), torch.from_numpy(mss), slices=8,
        n_sections=1, win=(16, 16), **tkw,
    )
    np.testing.assert_array_equal(nv_got.numpy(), np.asarray(nv_want))
    for b in range(4):
        for k in range(2):
            d = np.abs(_eval(got[b][k].numpy()) - _eval(want[b][k])).max()
            assert d <= 1e-3, (b, k, d)
    # and the constructed shifts come back (cx0 ~ 4 vx, cy0 ~ 4 vy)
    for b, (vy, vx) in enumerate(zip([0, -1, 1, 0], [1, 0, -1, 2])):
        assert abs(float(got[b][0][0]) - 4 * vx) < 0.3
        assert abs(float(got[b][1][0]) - 4 * vy) < 0.3


def test_register_fast_two_sections_tile_order(rng):
    """A strip longer than the 16000-line correlation window: two distinct
    sections batch into one FFT and one cross-power launch in (section,
    slice) tile order, and counts and fits match the JAX path."""
    pan, mss = _scene(rng, lines_mss=4032, band_px=128)
    kw = dict(slices=4, n_sections=2, win=(16, 16))
    want, nv_want = jdp.register_fast(jnp.asarray(pan), jnp.asarray(mss),
                                      **kw)
    got, nv_got = dp.register_fast(torch.from_numpy(pan),
                                   torch.from_numpy(mss), **kw)
    np.testing.assert_array_equal(nv_got.numpy(), np.asarray(nv_want))
    assert nv_got.tolist() == [8, 8, 8, 8]
    x = np.linspace(0.0, 512.0, 129)
    for b in range(4):
        for k in range(2):
            d = np.abs(_eval(got[b][k].numpy(), x) - _eval(want[b][k], x))
            assert d.max() <= 1e-3, (b, k, d.max())


def test_resident_tiles_are_views_of_the_strips(rng, monkeypatch):
    """ScenePipeline.estimate's row source hands _section_tiles views of
    the resident strips: every row block shares its strip's storage,
    nothing is copied before the RRC and the cast."""
    pan, mss = _scene(rng, lines_mss=4032, band_px=128)
    pan_t, mss_t = torch.from_numpy(pan), torch.from_numpy(mss)
    strips = {t.untyped_storage().data_ptr() for t in (pan_t, mss_t)}
    seen = []
    real = dp._section_tiles

    def spy(blk, params, cols):
        seen.append(blk.untyped_storage().data_ptr())
        return real(blk, params, cols)

    monkeypatch.setattr(dp, "_section_tiles", spy)
    ident = (np.ones(512), np.zeros(512))
    pipe = dp.ScenePipeline(ident, ident, (np.ones((4, 128)),
                                           np.zeros((4, 128))),
                            slices=4, n_sections=2)
    pipe.estimate(pan_t, pan_t, mss_t)
    assert len(seen) == 4 and set(seen) == strips


def _cmos_pair(rng, lines=1024, width=1024, ov=200):
    """tests/test_device_pipeline.py:191-201: PAN2's left block is PAN1's
    right block shifted by (rows +2, cols -3)."""
    wide = rng.integers(2000, 42000, (lines + 8, 2 * width)).astype(np.uint16)
    pan1 = np.ascontiguousarray(wide[4:4 + lines, :width])
    pan2 = np.ascontiguousarray(
        wide[2:2 + lines, width - ov + 3:2 * width - ov + 3]
    )
    return pan1, pan2


def test_stt_estimate_fast_matches_jax(rng):
    pan1, pan2 = _cmos_pair(rng)
    want = jdp.stt_estimate_fast(
        jnp.asarray(pan1), jnp.asarray(pan2), sections=4, overlap_cols=200
    )
    got = dp.stt_estimate_fast(
        torch.from_numpy(pan1), torch.from_numpy(pan2), sections=4,
        overlap_cols=200,
    )
    assert int(got[3]) == int(want[3]) == 4
    for k in range(3):
        assert abs(float(got[k]) - float(want[k])) <= 1e-3, k
    assert abs(float(got[0]) + 3.0) < 0.2 and abs(float(got[1]) - 2.0) < 0.2


def test_stt_estimate_fast_no_overlap_fails(rng):
    pan1, _ = _cmos_pair(rng)
    other = rng.integers(2000, 42000, pan1.shape).astype(np.uint16)
    *_, n = dp.stt_estimate_fast(
        torch.from_numpy(pan1), torch.from_numpy(other), sections=4,
        overlap_cols=200,
    )
    with pytest.raises(RuntimeError, match="No valid delta value"):
        dp.check_stt_valid(n)
    with pytest.raises(ValueError, match="less than sections times"):
        dp.stt_estimate_fast(torch.from_numpy(pan1[:512]),
                             torch.from_numpy(pan1[:512]), sections=10,
                             overlap_cols=32)


def test_check_registration_valid_message():
    dp.check_registration_valid(torch.tensor([5, 9, 12, 5]))
    with pytest.raises(RuntimeError,
                       match="Not enough valid correlation values for band#3"):
        dp.check_registration_valid(torch.tensor([5, 9, 4, 5]))


def test_flat_scene_registers_no_valid_sample():
    pan = np.full((2048, 3072), 9000, np.uint16)
    mss = np.full((4, 512, 768), 9000, np.uint16)
    _, n_valid = dp.register_fast(torch.from_numpy(pan),
                                  torch.from_numpy(mss), slices=8,
                                  n_sections=1, win=(16, 16))
    assert n_valid.tolist() == [0, 0, 0, 0]


def test_pipeline_forward_equals_staged(rng):
    """forward() is estimate() then transform(); the buffers hold float64
    RRC parameters and the outputs have the JAX pipeline's layouts."""
    lines, width = 1024, 3072
    scene = rng.integers(2000, 42000, (lines // 4, width // 4)).astype(
        np.float32)
    up = np.clip(np.rint(np.asarray(jres.upsample4_f32(scene))), 0, 65535)
    pan1 = up.astype(np.uint16)
    pan2 = np.roll(np.roll(up, 2, 0), 200 - 3 - width, 1).astype(np.uint16)
    mss = np.stack([np.roll(scene, (b % 2, b - 1), (0, 1))
                    for b in range(4)]).astype(np.uint16)
    params = [(0.98 + 0.04 * rng.random(n), rng.normal(0, 20, n))
              for n in (width, width)]
    mparams = (0.98 + 0.04 * rng.random((4, width // 4)),
               rng.normal(0, 20, (4, width // 4)))
    cfg = dict(slices=8, fold=100, stt_sections=4, overlap_cols=200)
    pipe = dp.make_device_pipeline(*params, mparams, **cfg)
    assert pipe.pan1_k.dtype == torch.float64
    args = [torch.from_numpy(x) for x in (pan1, pan2, mss)]
    aligned, stitched, n_valid, n_stt, prm = pipe(*args)
    assert aligned.shape == (lines // 4, width // 4, 4)
    assert stitched.shape == (lines, 2 * (width - 100))
    assert aligned.dtype == stitched.dtype == torch.uint16
    dp.check_registration_valid(n_valid)
    dp.check_stt_valid(n_stt)
    estimate, transform = dp.make_device_pipeline_staged(
        *params, mparams, **cfg
    )
    cx, cy, nv2, rdx, rdy, ns2 = estimate(*args)
    a2, s2 = transform(*args, cx, cy, rdx, rdy)
    assert torch.equal(nv2, n_valid) and int(ns2) == int(n_stt)
    assert torch.equal(cx, prm[0]) and torch.equal(cy, prm[1])
    assert np.array_equal(a2.numpy(), aligned.numpy())
    assert np.array_equal(s2.numpy(), stitched.numpy())
    # the prestitched PAN2 on request
    pipe_p = dp.ScenePipeline(*params, mparams, return_prestt=True, **cfg)
    _, s3, prestt = pipe_p.transform(*args, cx, cy, rdx, rdy)
    assert prestt.shape == (lines, width)
    assert np.array_equal(s3.numpy(), stitched.numpy())
    assert np.array_equal(s3.numpy()[:, width - 100:],
                          prestt.numpy()[:, 100:])

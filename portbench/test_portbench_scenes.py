"""The traffic generator: CMOS2's MSS where a mix asks for it, and the
same scenes and tables byte for byte where it does not."""

import hashlib
import json

import pytest
import torch

from portbench import harness, scenes

# the seed and the small size of test_portbench_runs.py
SEED = 2**31 + 977
WIDTH, LINES, OVERLAP = 1280, 2048, 200
# chip_smoke.mss2_rolls' own part: ((b + 1) mod 2, 1 - b)
MSS2_ROLLS = [[(b + 1) % 2, 1 - b] for b in range(4)]
# make_pool's tensors for SEED at that size, traffic scene_160k, pinned:
# a change to the generator that moves any of them fails here
DIGEST = "38df78c7235ed0fb6ed8bdc800e07ebde23532a6fd20c5310dcd907efe1dde4b"


def traffic(**more):
    t = json.loads((harness.HERE / "traffic" / "scene_160k.json").read_text())
    t.update(scene_lines=LINES, **more)
    return t


def pool(t):
    return scenes.make_pool(SEED, t, WIDTH, OVERLAP, "cpu")


@pytest.fixture(scope="module")
def plain():
    return pool(traffic())


@pytest.fixture(scope="module")
def dual():
    return pool(traffic(mss2_rolls=MSS2_ROLLS))


def test_without_mss2_rolls_the_pool_is_pinned(plain):
    tables, scs = plain
    h = hashlib.sha256()
    for t in [*tables.pan1, *tables.pan2, *tables.mss] + [
            x for s in scs for x in (s.pan1, s.pan2, s.mss)]:
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == DIGEST
    assert tables.mss2 is None and all(s.mss2 is None for s in scs)


def test_mss2_is_the_noise_scene_rolled_under_pan2(dual):
    _tables, scs = dual
    rolls = traffic()["band_rolls"]
    shift = (OVERLAP - WIDTH) // 4      # PAN2's prestitch shift, band px
    assert shift == -270
    for s in scs:
        assert s.mss2.dtype == torch.uint16
        assert tuple(s.mss2.shape) == (4, LINES // 4, WIDTH // 4)
        # every MSS band is the one noise scene, rolled
        noise = [torch.roll(s.mss[b], (-r, -c), (0, 1))
                 for b, (r, c) in enumerate(rolls)]
        assert all(torch.equal(noise[0], n) for n in noise[1:])
        for b, (r, c) in enumerate(MSS2_ROLLS):
            want = torch.roll(noise[0], (r, shift + c), (0, 1))
            assert torch.equal(s.mss2[b], want)
        assert not torch.equal(s.mss2, s.mss)


def test_pixels_count_mss2(plain, dual):
    s, d = plain[1][0], dual[1][0]
    assert s.pixels == 2 * LINES * WIDTH + LINES * WIDTH // 4
    assert d.pixels == s.pixels + LINES * WIDTH // 4


def test_mss2_leaves_the_rest_byte_for_byte(plain, dual):
    (pt, ps), (dt, ds) = plain, dual
    for name in ("pan1", "pan2", "mss"):
        for a, b in zip(getattr(pt, name), getattr(dt, name)):
            assert torch.equal(a, b), name
        for s, d in zip(ps, ds):
            assert torch.equal(getattr(s, name), getattr(d, name)), name
    # CMOS2's MSS table: drawn after the pool, with the MSS table's spread
    k, b = dt.mss2
    lo, hi = traffic()["rrc_gain"]
    assert k.dtype == b.dtype == torch.float64
    assert tuple(k.shape) == tuple(b.shape) == (4, WIDTH // 4)
    assert lo <= float(k.min()) and float(k.max()) <= hi
    assert not torch.equal(k, dt.mss[0])

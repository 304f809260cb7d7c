"""Port package contracts: no jax import, no CPU fallback for CUDA work,
the build's failure mode, and the launch counters."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu_torch import _build
from opticalimageprocessor_tpu_torch.models import scene
from opticalimageprocessor_tpu_torch.ops import phasecorr_cuda, resample, rrc

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

PORT_MODULES = [
    "opticalimageprocessor_tpu_torch",
    "opticalimageprocessor_tpu_torch._build",
    "opticalimageprocessor_tpu_torch.cli",
    "opticalimageprocessor_tpu_torch.constants",
    "opticalimageprocessor_tpu_torch.formats",
    "opticalimageprocessor_tpu_torch.formats.aos",
    "opticalimageprocessor_tpu_torch.formats.crc16",
    "opticalimageprocessor_tpu_torch.formats.naming",
    "opticalimageprocessor_tpu_torch.formats.rrc_csv",
    "opticalimageprocessor_tpu_torch.io",
    "opticalimageprocessor_tpu_torch.io.raw",
    "opticalimageprocessor_tpu_torch.io.streaming",
    "opticalimageprocessor_tpu_torch.io.tiff",
    "opticalimageprocessor_tpu_torch.models",
    "opticalimageprocessor_tpu_torch.models.auxsep",
    "opticalimageprocessor_tpu_torch.models.device_pipeline",
    "opticalimageprocessor_tpu_torch.models.preprocessor",
    "opticalimageprocessor_tpu_torch.models.scene",
    "opticalimageprocessor_tpu_torch.models.scene_stream",
    "opticalimageprocessor_tpu_torch.models.sharded_align",
    "opticalimageprocessor_tpu_torch.models.sharded_prestitch",
    "opticalimageprocessor_tpu_torch.models.stitcher",
    "opticalimageprocessor_tpu_torch.ops",
    "opticalimageprocessor_tpu_torch.ops.phasecorr",
    "opticalimageprocessor_tpu_torch.ops.phasecorr_cuda",
    "opticalimageprocessor_tpu_torch.ops.polyfit",
    "opticalimageprocessor_tpu_torch.ops.resample",
    "opticalimageprocessor_tpu_torch.ops.rrc",
    "opticalimageprocessor_tpu_torch.parallel",
    "opticalimageprocessor_tpu_torch.parallel.distributed",
    "opticalimageprocessor_tpu_torch.parallel.halo",
    "opticalimageprocessor_tpu_torch.parallel.mesh",
    "opticalimageprocessor_tpu_torch.parallel.sharded",
    "opticalimageprocessor_tpu_torch.parallel.sharded_scene",
    "opticalimageprocessor_tpu_torch.utils",
    "opticalimageprocessor_tpu_torch.utils.logging",
    "opticalimageprocessor_tpu_torch.utils.native",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _port_sys_modules(code: str) -> str:
    """Run ``code`` in a fresh interpreter, then list every module of the
    JAX package in its ``sys.modules``."""
    code += (
        "\nimport sys\n"
        "print(sorted(m for m in sys.modules if m == "
        "'opticalimageprocessor_tpu' or "
        "m.startswith('opticalimageprocessor_tpu.')))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    return res.stdout.strip().splitlines()[-1]


def test_port_imports_nothing_of_the_jax_package():
    """Every module of the port, and chip_smoke.py, load no module of
    ``opticalimageprocessor_tpu`` (not even its jax-free host modules)."""
    mods = _port_sys_modules(
        "import importlib\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
    )
    assert mods == "[]", mods


def test_port_cli_runs_without_the_jax_package(tmp_path):
    """A CLI run (a ``stitch`` of two RAW files, and a usage error) through
    the port's own logging, naming and RAW modules loads nothing of the
    JAX package."""
    a = (np.arange(4 * 12288) % 65536).astype(np.uint16).reshape(4, 12288)
    a.tofile(tmp_path / "L.RAW")
    a.tofile(tmp_path / "R.RAW")
    mods = _port_sys_modules(
        "import os\n"
        f"os.environ['LOGFILE'] = {str(tmp_path / 'oip.log')!r}\n"
        "from opticalimageprocessor_tpu_torch import cli\n"
        f"assert cli.main(['stitch', '--image1', {str(tmp_path / 'L.RAW')!r},"
        f" '--image2', {str(tmp_path / 'R.RAW')!r}, '-o', "
        f"{str(tmp_path / 'O.RAW')!r}, '-c', '4']) == 0\n"
        "assert cli.main(['stitch', '--image1', 'x', '--image2', 'y', "
        "'-c', '1']) == 254\n"
    )
    assert mods == "[]", mods
    out = np.fromfile(tmp_path / "O.RAW", dtype=np.uint16).reshape(4, -1)
    np.testing.assert_array_equal(out[:, :12286], a[:, :12286])
    np.testing.assert_array_equal(out[:, 12286:], a[:, 2:])


def test_run_scene_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scene.run_scene("a", "b", "c", device="cuda")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("which", ["rrc", "crosspower", "remap_band",
                                   "stitch_tail", "row_pass"])
def test_kernel_wrappers_raise_instead_of_falling_back(monkeypatch, which):
    """A tensor off the CPU never takes the plain version: without a CUDA
    device the wrapper raises (here with meta tensors, which no kernel
    accepts)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = dict(_build.LAUNCHES)
    u16, f64 = torch.uint16, torch.float64
    with pytest.raises(RuntimeError, match="no kernel for meta"):
        if which == "rrc":
            rrc.rrc_apply(_meta((8, 16), u16), _meta((16,), f64),
                          _meta((16,), f64))
        elif which == "crosspower":
            phasecorr_cuda.windowed_crosspower_fused_tiles(
                _meta((1, 64, 9), torch.complex64),
                _meta((1, 4, 16, 4), torch.complex64), (64, 16), 16, 8, 4,
            )
        elif which == "remap_band":
            resample._remap_band_cuda(
                _meta((32, 128), u16), torch.zeros(2), torch.zeros(3), 3,
                128, 16,
            )
        elif which == "row_pass":
            resample.fast_row_pass(_meta((55, 128), torch.float32),
                                   _meta((24, 128), torch.float32), 32)
        else:
            resample._stitch_tail_cuda(
                _meta((32, 128), u16), _meta((32, 128), u16),
                *(_meta((128,), f64) for _ in range(4)), 0.0, 0.0, 16, 128,
                16, False,
            )
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("which", ["crosspower", "remap_band",
                                   "stitch_tail", "row_pass"])
def test_kernel_wrappers_reject_mismatched_shapes(which):
    """Shapes that would send a kernel out of bounds are refused before
    any launch (here on meta tensors, checked ahead of the device)."""
    before = dict(_build.LAUNCHES)
    u16, f64, c64 = torch.uint16, torch.float64, torch.complex64
    with pytest.raises(ValueError, match="shape|got"):
        if which == "crosspower":
            phasecorr_cuda._crosspower_cuda(
                _meta((2, 64, 9), c64), _meta((1, 4, 16, 4), c64),
                _meta((64,), c64), _meta((9,), c64),
                _meta((9, 9), torch.float32), _meta((9, 9), torch.float32),
                _meta((1, 2, 4, 136, 8), torch.bfloat16),
            )
        elif which == "remap_band":
            resample._remap_band_cuda(
                _meta((32, 128), u16), torch.zeros(2), torch.zeros(2), 3,
                128, 16,
            )
        elif which == "row_pass":
            resample._fast_row_pass_cuda(_meta((54, 128), torch.float32),
                                         _meta((24, 128), torch.float32), 32)
        else:
            resample._stitch_tail_cuda(
                _meta((32, 128), u16), _meta((16, 128), u16),
                *(_meta((128,), f64) for _ in range(4)), 0.0, 0.0, 16, 128,
                16, False,
            )
    assert _build.LAUNCHES == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()


class _FakeLib:
    def __init__(self, rc):
        self.rc = rc

    def oip_rrc(self, *args):
        return self.rc


def test_launch_counts_only_successful_launches(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(_build, "library", lambda: _FakeLib(0))
    _build.launch("rrc", "oip_rrc")
    _build.launch("rrc", "oip_rrc")
    assert _build.LAUNCHES["rrc"] == 2
    monkeypatch.setattr(_build, "library", lambda: _FakeLib(700))
    with pytest.raises(RuntimeError, match="error 700"):
        _build.launch("rrc", "oip_rrc")
    assert _build.LAUNCHES["rrc"] == 2
    _build.reset_launch_counts()
    assert set(_build.LAUNCHES.values()) == {0}


def test_library_path_keys_on_sources(monkeypatch, tmp_path):
    """The built library's name hashes the sources and flags: an edited
    kernel source gives a new library, an unchanged tree the same one."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// a\n")
    monkeypatch.setattr(_build, "CSRC", src)
    p1 = _build._library_path()
    assert p1 == _build._library_path()
    (src / "a.cu").write_text("// b\n")
    assert _build._library_path() != p1


@pytest.mark.parametrize("halo", [0, 3])
def test_stream_process_writes_the_strip_in_order(rng, tmp_path, halo):
    """stream_process on the CPU: sections with their clipped halo rows
    reach ``fn``, and ``write`` gets every payload in line order."""
    from opticalimageprocessor_tpu_torch.io.raw import RawStrip
    from opticalimageprocessor_tpu_torch.io.streaming import stream_process

    img = rng.integers(0, 65536, (103, 16), dtype=np.uint16)
    img.tofile(tmp_path / "s.RAW")
    strip = RawStrip(str(tmp_path / "s.RAW"), 16)
    seen, out = [], []

    def fn(sec):
        seen.append((sec.line_offset, sec.lines, sec.halo_top,
                     sec.halo_bottom))
        np.testing.assert_array_equal(
            sec.data.numpy(),
            img[sec.line_offset - sec.halo_top:
                sec.line_offset + sec.lines + sec.halo_bottom])
        payload = sec.data[sec.halo_top:sec.halo_top + sec.lines]
        return (payload.to(torch.int32) ^ 0x5A5A).to(torch.uint16)

    n = stream_process(strip, fn, out.append, 40, "cpu", halo)
    assert n == 103
    assert [s[:2] for s in seen] == [(0, 40), (40, 40), (80, 23)]
    assert seen[0][2] == 0 and seen[-1][3] == 0
    assert all(s[2] == halo for s in seen[1:])
    np.testing.assert_array_equal(np.concatenate(out), img ^ 0x5A5A)


def test_cpu_tensors_take_the_plain_versions(rng):
    """On the CPU no kernel is built or counted."""
    before = dict(_build.LAUNCHES)
    src = torch.from_numpy(rng.integers(0, 65536, (8, 16), dtype=np.uint16))
    rrc.rrc_apply(src, torch.ones(16, dtype=torch.float64),
                  torch.zeros(16, dtype=torch.float64))
    assert _build.LAUNCHES == before
    assert _build._lib is None

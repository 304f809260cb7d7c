"""Build and load the hand-written Hopper kernels under ``csrc/``.

The CUDA sources have a plain C interface.  The first time a kernel is
launched, every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library,
loaded with ``ctypes``.  The library lands in ``_build/`` beside this file, named
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  A failed build raises: there is no
fallback to the plain PyTorch versions for CUDA tensors.

Every wrapper counts its launches in :data:`LAUNCHES` (one per kernel
launch, nowhere else), so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

LAUNCHES: dict[str, int] = {
    "rrc": 0,
    "crosspower": 0,
    "remap_band": 0,
    "stitch_tail": 0,
    "row_pass": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points (csrc/*.cu): name -> argtypes; every entry returns the
# cudaError_t of its launch as an int
_SIGNATURES = {
    "oip_rrc": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _P],
    "oip_crosspower": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    "oip_remap_bands": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P],
    "oip_stitch_tail": [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P,
    ],
    "oip_row_pass": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: str = ""  # nvcc's output (ptxas register/spill report)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_files() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _source_files():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"liboiptorch_{h.hexdigest()[:16]}.so"


def library() -> ctypes.CDLL:
    """The kernel library, built on first use; raises if the build fails."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so = _library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            tag = f"{so.stem}.{os.getpid()}"
            sources = sorted(CSRC.glob("*.cu"))
            objs = [BUILD_DIR / f"{tag}.{f.stem}.o" for f in sources]
            procs = [
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(f), "-o", str(o)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                for f, o in zip(sources, objs)
            ]
            logs = [p.communicate()[0] for p in procs]
            build_log = "".join(logs)
            failed = [f.name for f, p in zip(sources, procs) if p.returncode]
            if not failed:
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                res = subprocess.run(
                    [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                    capture_output=True, text=True)
                build_log += res.stdout + res.stderr
                failed = ["link"] if res.returncode else []
            for o in objs:
                o.unlink(missing_ok=True)
            if failed:
                raise RuntimeError(
                    f"nvcc failed ({', '.join(failed)}):\n{build_log}"
                )
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(kernel: str, entry: str, *args,
           device: torch.device | None = None) -> None:
    """Call C entry ``entry`` with ``device`` current, raise on a launch
    error, count one launch of ``kernel``.  The C entry points launch on,
    and set their kernels' attributes for, the calling thread's current
    device: on a line mesh over several cards that must be the device of
    the tensors (and of the stream) they are given.  The wrappers always
    pass it."""
    with (torch.cuda.device(device) if device is not None
          else contextlib.nullcontext()):
        rc = getattr(library(), entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {rc}")
    LAUNCHES[kernel] += 1


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Check that every tensor lies on one CUDA device and is contiguous
    in its last dimension."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(
            f"{name}: no kernel for {dev} tensors (CPU tensors take the "
            "plain PyTorch version, CUDA tensors the kernel)"
        )
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dim() and t.stride(-1) != 1:
            raise ValueError(f"{name}: last dimension must be contiguous")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: CUDA tensor but no CUDA device")

"""Logging and per-stage timing: the reference's libimsux logger and its
``stop_watch``/``comma_sep`` MB/s reports (``oipshared.h:70-84``,
``main.cpp:319-329``).  A trace-level file logger (path from the ``LOGFILE``
environment variable, default ``oip.log``), timestamped lines, and a
:func:`stage` span around every IO and compute stage, accumulated into
:func:`stage_report`.

Copied from ``opticalimageprocessor_tpu/utils/logging.py``, with
torch.profiler in place of the JAX profiler: each stage is a
``record_function`` span, and :func:`device_profile` writes a
torch.profiler trace.  The logger keeps the reference package's name,
``oiptpu``, so both packages in one process share one file handler and
write the same lines.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from dataclasses import dataclass


def comma_sep(value) -> str:
    """Format numbers with thousands separators, like libimsux ``comma_sep``."""
    if isinstance(value, float):
        return f"{value:,.3f}"
    return f"{value:,}"


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("oiptpu")
    if logger.handlers:
        return logger
    logger.setLevel(logging.DEBUG)
    fmt = logging.Formatter(
        "%(asctime)s.%(msecs)03d [%(levelname).1s] %(message)s", "%Y-%m-%d %H:%M:%S"
    )
    logfile = os.environ.get("LOGFILE", "oip.log")
    try:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        fh.setLevel(logging.DEBUG)
        logger.addHandler(fh)
    except OSError:
        pass
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    sh.setLevel(
        logging.DEBUG if os.environ.get("OIP_VERBOSE") else logging.WARNING
    )
    logger.addHandler(sh)
    return logger


LOG = _build_logger()


def olog(msg: str, *args) -> None:
    """Trace log (reference ``OLOG`` macro)."""
    LOG.debug(msg, *args)


def rlog(msg: str, *args) -> None:
    """Raw table-row log (reference ``RLOG``): the de-facto QA report rows."""
    LOG.debug(msg, *args)


def logw(msg: str, *args) -> None:
    LOG.warning(msg, *args)


def loge(msg: str, *args) -> None:
    LOG.error(msg, *args)


@dataclass
class _StageStats:
    seconds: float = 0.0
    bytes: int = 0
    calls: int = 0


_STAGES: dict[str, _StageStats] = {}


@contextlib.contextmanager
def stage(name: str, nbytes: int = 0, log: bool = True):
    """Time a pipeline stage and log ``<bytes> in <secs> (<MBps>)``, the
    reference's ``stop_watch::rst()/tik()`` + MB/s OLOG pattern (e.g.
    imageop.h:116-125).  Every stage is also a :func:`trace_annotation`
    span, so a profiler trace shows the pipeline's stages."""
    t0 = time.perf_counter()
    try:
        with trace_annotation(name):
            yield
    finally:
        es = time.perf_counter() - t0
        st = _STAGES.setdefault(name, _StageStats())
        st.seconds += es
        st.bytes += nbytes
        st.calls += 1
        if log:
            if nbytes:
                olog(
                    "[%s] %s bytes in %s seconds (%s MBps).",
                    name,
                    comma_sep(nbytes),
                    comma_sep(es),
                    comma_sep(nbytes / max(es, 1e-12) / 1024.0 / 1024.0),
                )
            else:
                olog("[%s] done in %s seconds.", name, comma_sep(es))


def stage_report() -> dict[str, dict[str, float]]:
    """Accumulated per-stage seconds / bytes / MBps."""
    return {
        k: {
            "seconds": v.seconds,
            "bytes": v.bytes,
            "calls": v.calls,
            "MBps": v.bytes / max(v.seconds, 1e-12) / 1024.0 / 1024.0,
        }
        for k, v in _STAGES.items()
    }


def reset_stage_report() -> None:
    _STAGES.clear()


@contextlib.contextmanager
def trace_annotation(name: str):
    """A ``torch.profiler.record_function`` span named ``name``; nothing
    where torch is not imported (no profiler can be recording there: the
    host-only ``auxsep`` never loads torch).

    Only the annotation's setup and teardown are guarded: exceptions raised
    by the annotated body propagate untouched (a guard spanning the yield
    would catch them and yield again, turning every stage error into
    contextlib's "generator didn't stop after throw()")."""
    torch = sys.modules.get("torch")
    try:
        cm = torch.profiler.record_function(name) if torch else None
        if cm is not None:
            cm.__enter__()
    except Exception:  # noqa: BLE001 — the span is best-effort
        cm = None
    try:
        yield
    finally:
        if cm is not None:
            try:
                cm.__exit__(None, None, None)
            except Exception:  # noqa: BLE001
                pass  # profiler teardown must never mask the body's result


def device_profile(trace_dir: str, device="cuda"):
    """A torch.profiler session over the body that writes a TensorBoard
    trace (``<worker>.<time>.pt.trace.json``) into ``trace_dir``: host
    activity, plus the card's (CUPTI) when ``device`` is a CUDA device.  A
    no-op when ``trace_dir`` is empty.  Exceptions from the body propagate
    untouched; the trace of the run up to them is still written."""
    if not trace_dir:
        return contextlib.nullcontext()
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    olog("Profiling device execution to %s", trace_dir)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(trace_dir))

"""Logging and per-stage timing: the reference's libimsux logger and its
``stop_watch``/``comma_sep`` MB/s reports (``oipshared.h:70-84``,
``main.cpp:319-329``).  A trace-level file logger (path from the ``LOGFILE``
environment variable, default ``oip.log``), timestamped lines, and a
:func:`stage` span around every IO and compute stage, accumulated into
:func:`stage_report`.

Copied from ``opticalimageprocessor_tpu/utils/logging.py``, with
torch.profiler in place of the JAX profiler: :func:`device_profile` writes
a torch.profiler trace, and while a profiler records, every stage and
every :func:`span` of the scene path is a ``record_function`` range timed
on the device and kept for :func:`span_report`, beside the counters of
:func:`count`; every place where the host waits for the card is one
:data:`SYNC_SPAN` span (:class:`host_wait`, :func:`to_host`,
:func:`to_device`), listed by site by :func:`wait_report`.  With no
profiler recording a span is one flag check.  The
logger keeps the reference package's name, ``oiptpu``, so both packages in
one process share one file handler and write the same lines.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import threading
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
    imageop.h:116-125).  Every stage is also a :func:`span`, so a
    profiler trace shows the pipeline's stages."""
    t0 = time.perf_counter()
    try:
        with span(name):
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


# ---- spans and counters (on only while a torch profiler records)

SCENE_SPAN = "oip.scene"
SYNC_SPAN = "oip.sync"


@dataclass
class _Record:
    """A closed span (host start and end; ``events`` its CUDA event pair,
    None on the host clock) or, with ``counter``, a counter's increment
    ``n``."""

    name: str
    parent: str | None
    scene: int
    t0_ns: int = 0
    t1_ns: int = 0
    events: tuple | None = None
    n: int = 0
    counter: bool = False


_RECORDS: list[_Record] = []
_OPEN = threading.local()      # .names: the thread's open spans
_SCENES = [0]                  # oip.scene spans opened since the reset


def tracing() -> bool:
    """Whether a torch profiler is recording (never where torch is not
    imported: the host-only ``auxsep`` never loads it)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


def _open_names() -> list[str]:
    names = getattr(_OPEN, "names", None)
    if names is None:
        names = _OPEN.names = []
    return names


def _device_stream(device):
    """The current stream of ``device`` (the current CUDA device when
    None, if CUDA is in use), or None for the host clock."""
    torch = sys.modules["torch"]
    if device is None:
        if not torch.cuda.is_initialized():
            return None
        return torch.cuda.current_stream()
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_stream(device)


class span:
    """A span named ``name`` around the body of a ``with`` block.

    Off (no torch profiler recording) it is one flag check: no
    ``record_function``, no CUDA event, nothing kept.  On, it is a
    ``torch.profiler.record_function`` range (in the profiler's trace, on
    the clock of its kernel events), a CUDA event pair on the current
    stream of ``device`` (the current CUDA device when None; the host
    clock for a CPU device or where CUDA is not in use), and a record of
    its name, its parent span, its scene (the count of :data:`SCENE_SPAN`
    spans) and its host start and end, read by :func:`span_report`.

    A body's exception propagates as itself; the span is closed and
    recorded all the same."""

    __slots__ = ("name", "device", "_on", "_rf", "_rec", "_stream")

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device
        self._on = False

    def __enter__(self):
        if not tracing():
            return self
        torch = sys.modules["torch"]
        self._on = True
        names = _open_names()
        if self.name == SCENE_SPAN:
            _SCENES[0] += 1
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._stream = _device_stream(self.device)
        start = None
        if self._stream is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
        self._rec = _Record(self.name, names[-1] if names else None,
                            _SCENES[0], time.perf_counter_ns(),
                            events=start)
        names.append(self.name)
        return self

    def __exit__(self, *exc):
        if not self._on:
            return False
        self._on = False
        rec = self._rec
        if self._stream is not None:
            torch = sys.modules["torch"]
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            rec.events = (rec.events, end)
        rec.t1_ns = time.perf_counter_ns()
        _open_names().pop()
        _RECORDS.append(rec)
        try:
            self._rf.__exit__(None, None, None)
        except Exception:  # noqa: BLE001
            pass  # profiler teardown must never mask the body's result
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records (nothing
    otherwise); :func:`span_report` sums it."""
    if tracing():
        names = _open_names()
        _RECORDS.append(_Record(name, names[-1] if names else None,
                                _SCENES[0], n=n, counter=True))


class host_wait(span):
    """A :data:`SYNC_SPAN` span around a place where the host waits for a
    card: a read back, an upload from pageable memory, an event's
    ``synchronize``, a torch op that synchronizes inside.  It runs on the
    host clock (no CUDA event pair: the wait is the host's), so its extent
    in the trace is the wait.  ``device`` names the device of a wait that
    only a card makes (an upload, an op's hidden sync): for any other
    device it opens no span; None, the default, always opens one.

    While a profiler records it also lifts ``torch.cuda``'s sync debug
    mode for its own wait, so that a traced forward under
    ``torch.cuda.set_sync_debug_mode("error")`` raises at any wait outside
    one."""

    __slots__ = ("_waits_on", "_debug")

    def __init__(self, device=None):
        super().__init__(SYNC_SPAN, "cpu")
        self._waits_on = device
        self._debug = 0

    def __enter__(self):
        if not tracing():
            return self
        torch = sys.modules["torch"]
        if (self._waits_on is not None
                and torch.device(self._waits_on).type != "cuda"):
            return self
        super().__enter__()
        if torch.cuda.is_initialized():
            self._debug = torch.cuda.get_sync_debug_mode()
            if self._debug:
                torch.cuda.set_sync_debug_mode(0)
        return self

    def __exit__(self, *exc):
        if self._debug:
            sys.modules["torch"].cuda.set_sync_debug_mode(self._debug)
            self._debug = 0
        return super().__exit__(*exc)


def _read(x):
    return x.item() if x.dim() == 0 else x.cpu()


def to_host(x):
    """``x`` read back to the host, counted as one ``host_syncs`` (from a
    device, the read waits for the work queued before it) and timed as a
    :class:`host_wait`: a 0-d tensor's number (``item()``, what
    ``float()`` reads), another tensor's CPU copy; anything else as it
    is.  Every blocking read of the scene path goes through here."""
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(x, torch.Tensor):
        return x
    if not tracing():
        return _read(x)
    count("host_syncs")
    with host_wait():
        return _read(x)


def to_device(array, device):
    """``array`` (a host tensor or a numpy array, shared, not copied, as
    ``torch.as_tensor`` shares it) copied to ``device`` by ``.to(device)``:
    from pageable memory a blocking upload, which on a card waits for the
    stream to drain first.  A :class:`host_wait` for a host-to-card copy
    only.  Every upload of the scene forwards goes through here."""
    torch = sys.modules["torch"]
    t = torch.as_tensor(array)
    if not tracing() or t.device.type != "cpu":
        return t.to(device)
    with host_wait(device):
        return t.to(device)


def span_report() -> dict[str, dict]:
    """The spans and counters recorded since :func:`reset_span_report`,
    per name: ``calls``, ``parent`` (the first record's), and for a span
    ``device_ms`` (its CUDA event pairs' total; the host clock's where it
    ran on the host), for a counter ``count`` (the sum of its
    increments).  Waits for each span's end event."""
    out: dict[str, dict] = {}
    for r in _RECORDS:
        e = out.setdefault(r.name, {"calls": 0, "parent": r.parent})
        e["calls"] += 1
        if r.counter:
            e["count"] = e.get("count", 0) + r.n
            continue
        if r.events is None:
            dev = (r.t1_ns - r.t0_ns) / 1e6
        else:
            r.events[1].synchronize()
            dev = r.events[0].elapsed_time(r.events[1])
        e["device_ms"] = e.get("device_ms", 0.0) + dev
    return out


def wait_report() -> dict[str | None, dict]:
    """The :data:`SYNC_SPAN` spans recorded since :func:`reset_span_report`
    by site, the span that encloses each (None outside any): ``calls``
    and ``host_ms``, the host clock's total."""
    out: dict[str | None, dict] = {}
    for r in _RECORDS:
        if r.name == SYNC_SPAN and not r.counter:
            e = out.setdefault(r.parent, {"calls": 0, "host_ms": 0.0})
            e["calls"] += 1
            e["host_ms"] += (r.t1_ns - r.t0_ns) / 1e6
    return out


def reset_span_report() -> None:
    _RECORDS.clear()
    _SCENES[0] = 0


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

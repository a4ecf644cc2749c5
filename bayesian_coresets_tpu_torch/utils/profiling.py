"""The program's spans, phase timing and device traces.

Port of ``bayesian_coresets_tpu/utils/profiling.py`` (named phase timers
and ``xla_trace``), grown into the program's span recorder:

- :func:`span` marks a stretch of the program's work by name.  It has two
  sinks, each on by itself.  While a ``torch.profiler`` session is active
  it opens ``record_function(name)``, so the profiler's trace shows it on
  the profiler's clock, whether or not the program's own tracing is on.
  Between :func:`enable` and :func:`disable` it is recorded here: its name
  and attrs, its parent (the innermost open span), the ``coreset`` serial
  of the request it belongs to (given to a root span, inherited by its
  children), the host's ``perf_counter`` at entry and exit and, on a CUDA
  device, a pair of timing events on that device's current stream, never
  inside a stream capture.  With both sinks off a span is a shared no-op
  context: one or two flag reads.
- :func:`spans` synchronizes once and places every device interval on the
  host's clock, against the reference event that :func:`enable` records
  right after a synchronize; on CPU tensors the device interval is the host
  interval.  At most :data:`LIMIT` records are kept; past it spans are
  counted in ``dropped`` and not recorded.
- :func:`phase` is a span that always records and synchronizes its device
  before it stops the clock; :func:`report` aggregates the records by name.
- :func:`trace` profiles a block and writes a Chrome trace.

Spans are opened and closed by one thread, the program's.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _profiler

LIMIT = 200_000     # records kept between resets
dropped = 0         # spans not recorded, past LIMIT

_on = False         # the program's own sink
_NOOP = contextlib.nullcontext()
_records: list = []
_stack: list = []   # open records, innermost last
_refs: dict = {}    # CUDA device index -> (reference event, host time of it)
_pool: dict = {}    # CUDA device index -> free timing events


class _Record:
    __slots__ = ("index", "name", "attrs", "parent", "coreset", "device", "host_start",
                 "host_end", "events", "dev_start", "dev_end", "error")

    def __init__(self, name, attrs, parent, coreset, device):
        self.name, self.attrs, self.parent = name, attrs, parent
        self.coreset, self.device = coreset, device
        self.index = -1             # position in _records; -1 past LIMIT
        self.events = None          # (device index, start event, end event)
        self.host_start = self.host_end = self.dev_start = self.dev_end = None
        self.error = None

    def as_dict(self) -> dict:
        cpu = self.device is None or self.device.type != "cuda"
        parent = self.parent.index if self.parent is not None else -1
        return {"name": self.name, "attrs": self.attrs,
                "parent": parent if parent >= 0 else None, "coreset": self.coreset,
                "host_start": self.host_start, "host_end": self.host_end,
                "dev_start": self.host_start if cpu else self.dev_start,
                "dev_end": self.host_end if cpu else self.dev_end, "error": self.error}


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _event(idx: int) -> torch.cuda.Event:
    free = _pool.get(idx)
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _open(name: str, device, coreset, attrs) -> _Record:
    global dropped
    parent = _stack[-1] if _stack else None
    if parent is not None:
        device = parent.device if device is None else device
        coreset = parent.coreset if coreset is None else coreset
    rec = _Record(name, attrs, parent, coreset, device)
    rec.host_start = time.perf_counter()
    if len(_records) < LIMIT:
        rec.index = len(_records)
        _records.append(rec)
        if (device is not None and device.type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            idx = _index(device)
            if idx in _refs:
                start = _event(idx)
                start.record(torch.cuda.current_stream(idx))
                rec.events = (idx, start, None)
    else:
        dropped += 1
    _stack.append(rec)
    return rec


def _close(rec: _Record, error, sync=()) -> None:
    if rec.events is not None:
        idx, start, _ = rec.events
        if torch.cuda.is_current_stream_capturing():
            rec.events = None
        else:
            end = _event(idx)
            end.record(torch.cuda.current_stream(idx))
            rec.events = (idx, start, end)
    for dev in sync:
        torch.cuda.synchronize(dev)
    rec.host_end = time.perf_counter()
    if error is not None:
        rec.error = error.__name__
    if _stack and _stack[-1] is rec:
        _stack.pop()
    elif rec in _stack:
        _stack.remove(rec)


class _Span:
    __slots__ = ("name", "device", "coreset", "attrs", "record", "sync", "rf", "rec")

    def __init__(self, name, device, coreset, attrs, record, sync=()):
        self.name, self.device, self.coreset, self.attrs = name, device, coreset, attrs
        self.record, self.sync = record, sync
        self.rf = self.rec = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        if self.record:
            self.rec = _open(self.name, self.device, self.coreset, self.attrs)

    def __exit__(self, exc_type, exc, tb):
        if self.rec is not None:
            _close(self.rec, exc_type, self.sync)
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        return False


def span(name: str, *, device=None, coreset=None, **attrs):
    """A context that marks the program's work ``name`` (see the module's
    docstring).  ``device``: where the work runs (a ``torch.device``;
    inherited from the parent where not given), a CUDA device's giving the
    record timing events on its current stream.  ``coreset``: the serial of
    the request the span belongs to (inherited where not given).  ``attrs``
    are kept with the record."""
    if not _on and not _profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, device, coreset, attrs, _on)


def enable() -> None:
    """Start recording spans.  On a machine with a CUDA device, the current
    device is synchronized and a reference event recorded, paired with the
    host's clock: device intervals are placed on the host's clock from it.
    Records made before are resolved first and kept."""
    global _on
    _resolve()
    if torch.cuda.is_available():
        idx = torch.cuda.current_device()
        torch.cuda.synchronize(idx)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(idx))
        _refs[idx] = (ev, time.perf_counter())
    _on = True


def disable() -> None:
    """Stop recording spans; the records stay until :func:`reset`."""
    global _on
    _on = False


def _resolve() -> None:
    """Synchronize each device with pending events once, and place the
    closed records' device intervals on the host's clock."""
    pending = [r for r in _records if r.events is not None and r.events[2] is not None]
    for idx in {r.events[0] for r in pending}:
        torch.cuda.synchronize(idx)
    for r in pending:
        idx, start, end = r.events
        ref, t = _refs[idx]
        r.dev_start = t + 1e-3 * ref.elapsed_time(start)
        r.dev_end = t + 1e-3 * ref.elapsed_time(end)
        _pool.setdefault(idx, []).extend((start, end))
        r.events = None


def spans() -> list[dict]:
    """The records in the order they were opened, each a dict: ``name``,
    ``attrs``, ``parent`` (the parent's position in the list, or None),
    ``coreset``, ``host_start``, ``host_end``, ``dev_start``, ``dev_end``
    (seconds on the host's ``perf_counter``; the device interval None where
    no events were recorded: inside a capture, or on a device without a
    reference) and ``error`` (the exception's type name that closed it).
    A span still open has ``host_end`` None.  Synchronizes once."""
    _resolve()
    return [r.as_dict() for r in _records]


@contextlib.contextmanager
def phase(name: str, sync=None):
    """Time a named phase: a span that is recorded whether or not tracing is
    on.  ``sync`` (a CUDA tensor or device, or a tuple of tensors):
    synchronize its device before stopping the clock, so the time includes
    the device work the phase queued."""
    devs = tuple(_cuda_devices(sync))
    with _Span(name, devs[0] if len(devs) == 1 else None, None, {}, True, devs):
        yield


def _cuda_devices(sync) -> set[torch.device]:
    """The CUDA devices that ``sync`` names: a tensor's, a device, or those
    of the tensors in a tuple, list or NamedTuple of them."""
    if isinstance(sync, torch.Tensor):
        sync = sync.device
    if isinstance(sync, torch.device):
        return {sync} if sync.type == "cuda" else set()
    if isinstance(sync, (tuple, list)):
        return set().union(*(_cuda_devices(x) for x in sync))
    return set()


def report() -> dict[str, dict[str, float]]:
    """The closed records aggregated by name: {name: {count, total_s,
    mean_s}}, host seconds, and ``device_s``, the sum of their device
    intervals, where they have them."""
    out: dict = {}
    for r in spans():
        if r["host_end"] is None:
            continue
        e = out.setdefault(r["name"], {"count": 0, "total_s": 0.0})
        e["count"] += 1
        e["total_s"] += r["host_end"] - r["host_start"]
        if r["dev_end"] is not None:
            e["device_s"] = e.get("device_s", 0.0) + r["dev_end"] - r["dev_start"]
    for e in out.values():
        e["mean_s"] = e["total_s"] / e["count"]
    return out


def reset() -> None:
    """Drop every record and the count of those dropped."""
    global dropped
    _records.clear()
    _stack.clear()
    dropped = 0


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and the CUDA
    card where there is one) and write a Chrome trace into ``logdir``
    (open it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))

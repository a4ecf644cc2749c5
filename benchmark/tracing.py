"""What a traced stretch of jobs shows: the device's busy time, the kernels by
name, and the idle gaps by what the host was doing.

The stretch runs under ``torch.profiler`` inside one host span named
:data:`WINDOW_SPAN`; its events are read here, in memory, and nothing is
written to disk.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW_SPAN = "bench.traced_window"
TOP = 10              # entries of each list of the breakdown
NAME_CHARS = 160      # a kernel's or a host call's name is cut to this length


@dataclass
class Kernels:
    count: int = 0
    seconds: float = 0.0


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)     # name -> Kernels
    gaps: dict = field(default_factory=dict)        # host call -> idle seconds

    def matching(self, part: str) -> Kernels:
        """The kernels whose name holds ``part``, summed."""
        out = Kernels()
        for name, k in self.kernels.items():
            if part in name:
                out.count += k.count
                out.seconds += k.seconds
        return out

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1].seconds)[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], k.seconds] for n, k in ops],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps]}


@contextlib.contextmanager
def traced(dev: torch.device):
    """Profile the block (the host, and the card where ``dev`` is one) inside
    the window span; yields a list that receives the :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = []
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            yield out
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    out.append(summarize(prof.events()))


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events) -> Trace:
    """A :class:`Trace` from the profiler's events (times in microseconds)."""
    dev_type = torch.autograd.DeviceType.CUDA
    window = [e for e in events if e.name == WINDOW_SPAN]
    if not window:
        raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    kernels = defaultdict(Kernels)
    device, host = [], []
    # a host span (record_function) is mirrored on the device's timeline as
    # an annotation that covers the work it launched: no operation of its own
    spans = {e.name for e in events
             if e.device_type != dev_type and getattr(e, "is_user_annotation", False)}
    spans.add(WINDOW_SPAN)
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == dev_type and (getattr(e, "is_user_annotation", False)
                                          or e.name in spans):
            continue
        if e.device_type == dev_type:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            device.append((a, b))
            k = kernels[e.name]
            k.count += 1
            k.seconds += 1e-6 * (b - a)
        elif e.name != WINDOW_SPAN and b > a:
            host.append((a, b, e.name))
    busy = _merge(device)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host.sort()
    by_call = defaultdict(float)
    # a sweep over the gaps' middles with the stack of host calls open
    # there (they nest): its top is the innermost call running
    stack, i = [], 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        by_call[stack[-1][2] if stack else "(no host call)"] += 1e-6 * (b - a)
    return Trace(window_s=1e-6 * (w1 - w0),
                 busy_s=1e-6 * sum(b - a for a, b in busy),
                 kernels=dict(kernels), gaps=dict(by_call))

"""The traced window read from ``torch.profiler``: the device's busy time
(the union of its kernels, copies and sets inside the window), the device
time of named kernels, the device operations that took most time, and the
longest idle gaps, each named by the innermost host operation running
when it began."""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

import torch

WINDOW = "portbench.window"


@contextlib.contextmanager
def profiled(on: bool, cuda: bool):
    """A profiler over the block (host and device activity; host alone
    where there is no card), or nothing when ``on`` is false."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof


def window_mark():
    return torch.profiler.record_function(WINDOW)


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    by_name: dict[str, list] = field(default_factory=dict)  # name -> [seconds, calls]
    gaps: list[tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name holds one of ``names``."""
        return sum(s for n, (s, _) in self.by_name.items() if any(k in n for k in names))

    def kernel_calls(self, names) -> int:
        return sum(c for n, (_, c) in self.by_name.items() if any(k in n for k in names))

    def top(self, k: int = 10) -> list[list]:
        return [[n[:160], s] for n, (s, _) in sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:k]]


def read(prof) -> Trace:
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    dev, host, win = [], [], None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not e.is_user_annotation():
            dev.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() == cpu:
            if e.name() == WINDOW:
                win = (e.start_ns(), e.end_ns())
            else:
                host.append((e.start_ns(), e.end_ns(), e.name()))
    out = Trace()
    if win is None:
        return out
    lo, hi = win
    out.window_s = (hi - lo) / 1e9
    spans = sorted((max(a, lo), min(b, hi)) for a, b, _ in dev if b > lo and a < hi)
    for a, b, name in dev:
        if b > lo and a < hi:
            row = out.by_name.setdefault(name, [0.0, 0])
            row[0] += (min(b, hi) - max(a, lo)) / 1e9
            row[1] += 1
    busy, gaps, at = 0, [], lo
    for a, b in spans:
        if a > at:
            gaps.append((at, a))
        if b > at:
            busy += b - max(a, at)
            at = b
    if hi > at:
        gaps.append((at, hi))
    out.busy_s = busy / 1e9
    host.sort()
    starts = [h[0] for h in host]
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        out.gaps.append((_host_at(host, starts, a), (b - a) / 1e9))
    return out


def _host_at(host, starts, t) -> str:
    """The innermost host operation running at ``t`` (the latest started
    that has not ended), or ``python`` where none is."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 20000, -1), -1):
        a, b, name = host[j]
        if a <= t < b:
            return name[:160]
    return "python"

"""A traced stretch of work: torch.profiler around it, reduced to device
intervals, busy time, kernel time by name and the breakdown.

The stretch is the span of the host annotation TRACED; device work is
the profiler's kernel, memcpy and memset records clipped to it (GPU-side
annotations are not work). An idle gap is labelled with the innermost
host operation that was running at its middle.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

TRACED = "bench.traced"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _ns(e, end: bool = False) -> int:
    if hasattr(e, "start_ns"):
        return int(e.end_ns() if end else e.start_ns())
    return int((e.start_us() + (e.duration_us() if end else 0)) * 1000)


@dataclass
class Trace:
    start: int                                   # ns, the stretch on the host's clock
    end: int
    device: list = field(default_factory=list)   # (name, start, end) ns
    host: list = field(default_factory=list)     # (name, start, end) ns

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_intervals(self) -> list:
        merged = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_s(self, patterns) -> float:
        """Device seconds of the records whose name matches any regex."""
        rx = [re.compile(p) for p in patterns]
        return sum(e - s for n, s, e in self.device if any(r.search(n) for r in rx)) / 1e9

    def breakdown(self, top: int = 10, width: int = 160) -> dict:
        ops = {}
        for n, s, e in self.device:
            ops[n[:width]] = ops.get(n[:width], 0.0) + (e - s) / 1e9
        gaps = {}
        host = sorted(self.host, key=lambda h: h[1])
        active, nxt, prev = [], 0, self.start
        for s, e in self.busy_intervals() + [[self.end, self.end]]:
            if s > prev:
                mid = (prev + s) // 2
                while nxt < len(host) and host[nxt][1] <= mid:
                    active.append(host[nxt])
                    nxt += 1
                # kept in start order: the last one still running is the innermost
                active = [h for h in active if h[2] > mid]
                name = active[-1][0] if active else "host (no op)"
                gaps[name[:width]] = gaps.get(name[:width], 0.0) + (s - prev) / 1e9
            prev = max(prev, e)
        order = sorted(ops.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n, t] for n, t in order],
                "idle_gaps": [[n, t] for n, t in sorted(gaps.items(), key=lambda x: -x[1])[:top]]}


def traced(fn) -> Trace:
    """Run fn() under the profiler, with the device drained before and
    after, and reduce what it recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(TRACED):
            fn()
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    span = [e for e in events if e.name() == TRACED and not _on_device(e)]
    if not span:
        raise RuntimeError("the profiler recorded no traced stretch")
    t = Trace(_ns(span[0]), _ns(span[0], end=True))
    for e in events:
        s, x = _ns(e), _ns(e, end=True)
        if _on_device(e):
            # a GPU-side annotation spans work; it is none itself
            if e.name() != TRACED and not _annotation(e) and x > t.start and s < t.end:
                t.device.append((e.name(), max(s, t.start), min(x, t.end)))
        elif e.name() != TRACED:
            t.host.append((e.name(), s, x))
    return t


def _on_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _annotation(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() not in _DEVICE_KINDS
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False

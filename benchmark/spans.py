"""What the port's own spans and counters (`cffm_tpu_torch.utils.profiling`)
give a per-layer metric: the device time a span kept the card busy, the
host synchronizes inside the top-level spans, and the counters.

A span is a host record of the trace under its name (`record_function`).
The kernels and copies it launched are the device records whose
launching call (a kernel launch, copy or memset) starts inside it: on one
stream the trace's k-th launching call launched its k-th device record,
so the readers pair them by order and need no clock shared by host and
device. A span's busy time is the union of its device records: the
host's stalls inside the span do not count.

A reader returns None from a port without the spans or counters, unless
there is one top-level span (a train step or a forward) for each traced
item, or unless the launching calls and the device records number the
same.
"""

from __future__ import annotations

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel", "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync",
            "cudaMemset")


def counts():
    """The port's counters over the traced stretch, or None without them."""
    try:
        from cffm_tpu_torch.utils.profiling import counts
    except ImportError:
        return None
    return counts()


def _marks(run, name: str) -> list:
    """The trace's host records of span `name`: (start, end), in order."""
    return sorted((s, e) for n, s, e in run.trace.host if n == name)


def _tops(run, top: str):
    if run.trace is None:
        return None
    tops = _marks(run, top)
    return tops if tops and len(tops) == len(run.items) else None


def launched(run):
    """(launching call's start, record's start, record's end) of each
    device record of the stretch, or None unless calls and records
    number the same."""
    tr = run.trace
    calls = sorted(s for n, s, _ in tr.host if n in LAUNCHES and tr.start <= s <= tr.end)
    recs = sorted((s, e) for _, s, e in tr.device)
    if len(calls) != len(recs):
        return None
    return [(c, s, e) for c, (s, e) in zip(calls, recs)]


def busy_ms(run, top: str, child: str):
    """Device ms a `top` span keeps the card busy with what its `child`
    span launched, over the top-level spans."""
    tops = _tops(run, top)
    if tops is None:
        return None
    kids = [k for k in _marks(run, child) if any(a <= k[0] and k[1] <= b for a, b in tops)]
    pairs = launched(run)
    if len(kids) != len(tops) or pairs is None:
        return None
    ns = 0
    for a, b in kids:
        end = 0
        for s, e in sorted((s, e) for c, s, e in pairs if a <= c <= b):
            ns += max(0, e - max(s, end))
            end = max(end, e)
    return ns / 1e6 / len(tops)


def syncs(run, top: str):
    """Host synchronizes that start inside a `top` span, over those spans."""
    tops = _tops(run, top)
    if tops is None:
        return None
    n = sum(1 for name, start, _ in run.trace.host
            if name in SYNCS and any(a <= start <= b for a, b in tops))
    return n / len(tops)

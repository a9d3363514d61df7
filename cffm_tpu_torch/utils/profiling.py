"""Tracing: the profiler over a block, and the spans and counters that the
port's step and forward record inside it.

The port's counterpart of `cffm_tpu/utils/profiling.py`:

- `trace(dir)` runs `torch.profiler` (CPU and CUDA activities) over its
  block and writes a Chrome trace (Perfetto-viewable) into dir; it yields
  the profiler, whose `key_averages()` sums device time by kernel.
- `span(name)` names a block in the profiler's records: while a torch
  profiler runs (`torch.autograd._profiler_enabled()`, one cheap test) it
  is `record_function(name)`, so the Chrome trace shows the block and its
  kernels under the name; otherwise one shared no-op context, nothing
  allocated. A reader of the trace finds each span as a host record and
  each kernel it launched by the launching call inside it.
- `count(name, value)` adds to one registry of counters of the process,
  and only while a torch profiler runs outside `trace()` (whose runs read
  none, however long): host numbers are added, a device tensor is kept
  by reference and summed in `counts()`, so no counter drains the
  stream. `counts()` returns the totals since `reset()`. Whoever runs a
  profiler of their own over many steps and reads nothing calls
  `reset()`.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block on the CPU and the card; the Chrome trace lands in
    log_dir/trace.json when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _REG.muted += 1
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        _REG.muted -= 1
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _Registry:
    def __init__(self):
        self.muted = 0      # trace() blocks running: no counter is kept
        self.reset()

    def reset(self):
        self.host = {}      # counter -> sum of host numbers
        self.device = {}    # counter -> [device tensors]


_REG = _Registry()


def span(name: str):
    """`record_function(name)` while a torch profiler runs, else a shared
    no-op context."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return record_function(name)


def count(name: str, value=1):
    """Add value (a number, or a tensor summed in `counts()`) to counter
    `name` while a torch profiler runs outside `trace()`."""
    if not torch.autograd._profiler_enabled() or _REG.muted:
        return
    if isinstance(value, torch.Tensor):
        _REG.device.setdefault(name, []).append(value.detach())
    else:
        _REG.host[name] = _REG.host.get(name, 0) + value


def counts() -> dict:
    """{counter: total} since the last reset."""
    out = dict(_REG.host)
    for name, tensors in _REG.device.items():
        out[name] = out.get(name, 0) + sum(t.sum().item() for t in tensors)
    return out


def reset():
    """Forget every counter recorded so far."""
    _REG.reset()

"""Tracing, step timing and structured logging.

The port's counterpart of `cffm_tpu/utils/profiling.py`:

- `trace(dir)` runs `torch.profiler` (CPU and CUDA activities) over its
  block and writes a Chrome trace (Perfetto-viewable) into dir; it yields
  the profiler, whose `key_averages()` sums device time by kernel.
- `StepTimer` measures examples/s per window of steps, draining the CUDA
  queue with a synchronize every `sync_every` steps.
- `JsonlLogger` appends one JSON object per line (metrics, events).
- `device_memory_stats` reads `torch.cuda.memory_stats`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block on the CPU and the card; the Chrome trace lands in
    log_dir/trace.json when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Examples/s over windows of `sync_every` steps.

    Call .step(batch_size) once per step. Every `sync_every` steps it
    synchronizes the CUDA device (when one is in use), so the window's wall
    time covers the device's work, and updates `examples_per_s`; it returns
    the latest value (nan before the first window ends)."""

    def __init__(self, sync_every: int = 50, device=None):
        if sync_every < 1:
            raise ValueError(f"sync_every must be positive, got {sync_every}")
        self.sync_every = sync_every
        self._cuda = torch.device(device).type == "cuda" if device is not None else (
            torch.cuda.is_available())
        self._count = 0
        self._examples = 0
        self._t0 = time.perf_counter()
        self.examples_per_s = float("nan")

    def step(self, batch_size: int) -> float:
        self._count += 1
        self._examples += batch_size
        if self._count % self.sync_every == 0:
            if self._cuda:
                torch.cuda.synchronize()
            now = time.perf_counter()
            self.examples_per_s = self._examples / max(now - self._t0, 1e-12)
            self._t0 = now
            self._examples = 0
        return self.examples_per_s


class JsonlLogger:
    """Structured records -> stdout and/or a JSONL file (appended)."""

    def __init__(self, path: Optional[str] = None, also_stdout: bool = True):
        self._fh = open(path, "a") if path else None
        self._stdout = also_stdout

    def log(self, record: dict):
        line = json.dumps(record)
        if self._stdout:
            print(line, flush=True)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def device_memory_stats(device=None) -> dict:
    """Bytes in use, peak bytes and the device's total memory, from the
    CUDA caching allocator; {} without a CUDA device."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": torch.cuda.get_device_properties(device or 0).total_memory,
    }

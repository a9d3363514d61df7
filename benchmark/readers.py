"""What a per-layer metric reads, and the readers the metric files share.

A metric file (`metrics/<name>.py`) defines `read(run) -> float | None`.
A reader that finds nothing to read returns None, and the metric is left
out of the result's line: a roofline share is never reported as 0.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from benchmark import work


@dataclass
class Run:
    model: dict                     # the configuration's model section
    train: bool                     # the window trains (else it serves)
    window_s: float                 # the measured window, host clock
    window_examples: int            # examples trained or candidates scored in it
    trace: object = None            # trace.Trace of the traced stretch
    items: list = field(default_factory=list)     # one dict per traced step or request
    launches: dict = field(default_factory=dict)  # the port's launch counters over the stretch
    table_bytes: int = 4
    optimizer: str = "adagrad"


class Laps:
    """Named seconds of set-up, each from the previous mark (host clock)."""

    def __init__(self):
        self.seconds = {}
        self._t = time.perf_counter()

    def mark(self, name: str):
        t = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + t - self._t
        self._t = t


def launch_counts() -> dict:
    """The port's kernel wrappers' launch counters, by wrapper name."""
    import importlib

    out = {}
    for mod in ("interaction_conv", "sorted_segment", "streamed_update"):
        m = importlib.import_module(f"cffm_tpu_torch.ops.{mod}")
        for name, fn in vars(m).items():
            n = getattr(fn, "launches", None)
            if callable(fn) and isinstance(n, int) and not name.startswith("_"):
                out[name] = n
    return out


def idle_share(run: Run):
    """Percent of the traced stretch in which no kernel or copy ran."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu(run: Run):
    """The window's model FLOPs over the card's bf16 dense peak, percent."""
    if run.window_s <= 0 or not run.window_examples:
        return None
    flops = run.window_examples * work.example_flops(run.model, run.train)
    return 100.0 * flops / (run.window_s * work.PEAK_FLOPS["bfloat16"])


def roofline(run: Run, patterns, work_of, counter: str):
    """Percent of the kernels' device time that their bound accounts for,
    over the traced stretch: sum of each item's bound / device time of
    the records matching `patterns`. None unless the wrapper `counter`
    launched exactly once per item and the trace holds the kernels."""
    if run.trace is None or not run.items:
        return None
    if run.launches.get(counter, 0) != len(run.items):
        return None
    t = run.trace.kernel_s(patterns)
    if t <= 0:
        return None
    return 100.0 * sum(work.bound_of(work_of(item)) for item in run.items) / t

"""Preemption-safe shutdown: a SIGTERM becomes a cooperative stop.

The port's counterpart of `cffm_tpu/utils/preemption.py`. A preempted
job gets a SIGTERM and a grace window. The guard turns the signal into a
flag; the train loop checks it at step boundaries, saves a final
checkpoint and exits cleanly, and the next run resumes from that step
through the normal restore path (`train.run`).

In a group of more than one process each process gets its own signal,
possibly at other times, or only some of them get one. A rank that stops
while its peers go on issuing collectives hangs the group, so `sync()`
agrees on the flag with one all-reduce (MAX) over the default group:
every rank stops at the same step or none does. With one process there
is no collective.
"""

from __future__ import annotations

import signal
import threading

import torch
import torch.distributed as dist


class PreemptionGuard:
    """Installs handlers for `signals` that set a flag instead of killing
    the process. `sync()` at step boundaries returns True on every rank
    once any rank saw the signal. `close()` restores the previous
    handlers."""

    def __init__(self, signals=(signal.SIGTERM,), install: bool = True):
        self._flag = threading.Event()
        self._prev = {}
        self._installed = False
        if install:
            try:
                for s in signals:
                    self._prev[s] = signal.signal(s, self._on_signal)
                self._installed = True
            except ValueError:
                # not the main thread: a guard that only request() trips
                self._prev = {}

    def _on_signal(self, signum, frame):  # noqa: ARG002
        self._flag.set()

    @property
    def requested(self) -> bool:
        return self._flag.is_set()

    def request(self) -> None:
        """Trip the guard from code (tests, an embedding framework)."""
        self._flag.set()

    def sync(self) -> bool:
        """True iff any rank of the default group has the flag. A
        collective when the group has more than one process: call it at
        the same point on every rank."""
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
            return self.requested
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        flag = torch.tensor([int(self.requested)], dtype=torch.int32, device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def close(self) -> None:
        if self._installed:
            for s, prev in self._prev.items():
                try:
                    signal.signal(s, prev)
                except ValueError:
                    pass
            self._installed = False

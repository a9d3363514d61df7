"""Collective-order debug probes.

The port's counterpart of `cffm_tpu/utils/debugging.py`. The failure
that replaces a data race in the sharded step is a collective-order
mismatch: one rank runs another program, or reads another stream, and
every rank blocks inside an all-to-all, silently. With
`TrainConfig.debug_barriers=True` the sharded step prints a line before
and after each collective region; when a run hangs, the last line of
each rank names the collective it is stuck in and which side of it the
rank reached.

NCCL calls return before the collective finishes, so an ":exit" line
printed at once would claim too much: the probe synchronizes the
current CUDA stream first. Disabled, it does nothing at all.
"""

from __future__ import annotations

import torch


def collective_probe(tag: str, rank: int, enabled: bool) -> None:
    """Print `[collective] <tag> shard=<rank>` when enabled; for a tag
    ending in ":exit", after the current CUDA stream has finished."""
    if not enabled:
        return
    if tag.endswith(":exit") and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()
    print(f"[collective] {tag} shard={rank}", flush=True)

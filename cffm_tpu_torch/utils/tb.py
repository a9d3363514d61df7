"""Optional TensorBoard scalar logging.

The port's counterpart of `cffm_tpu/utils/tb.py`. Stdout JSON lines stay
the primary metrics channel; with `TrainConfig.tensorboard_dir` set,
`train.run` mirrors the same scalars into event files through
`torch.utils.tensorboard.SummaryWriter`. The writer is imported on first
use, and any failure to import or to write turns it into a no-op: the
training loop never dies on a logger. Only rank 0 of a group writes.
"""

from __future__ import annotations

import sys
import types
from typing import Optional


def _summary_writer():
    """torch's SummaryWriter, with tensorboard held to its own TensorFlow
    stub: left alone, tensorboard imports TensorFlow when it is installed
    (seconds of import, a second framework in the process). A
    `tensorboard.compat.notf` module is tensorboard's own switch for the
    stub; the event files are the same."""
    if "tensorflow" not in sys.modules:
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
    from torch.utils.tensorboard import SummaryWriter

    return SummaryWriter


class ScalarWriter:
    """Scalar event-file writer; a no-op without a directory, on a rank
    other than 0, or when tensorboard is missing or fails."""

    def __init__(self, logdir: Optional[str], rank: int = 0):
        self._writer = None
        if not logdir or rank != 0:
            return
        try:
            self._writer = _summary_writer()(log_dir=logdir)
        except Exception:  # noqa: BLE001 -- a logger must never stop training
            self._writer = None

    def scalars(self, step: int, values: dict) -> None:
        """Write the int and float entries of values at step; skip the rest."""
        if self._writer is None:
            return
        try:
            for k, v in values.items():
                if isinstance(v, (int, float)):
                    self._writer.add_scalar(k, v, global_step=step)
            self._writer.flush()
        except Exception:  # noqa: BLE001
            self._writer = None

    def close(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:  # noqa: BLE001
                pass
            self._writer = None

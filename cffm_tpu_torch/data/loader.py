"""Batcher: config -> iterator of host batches with global ids.

The port's counterpart of `cffm_tpu/data/loader.py`, for the synthetic
stream only: per-host sample streams over one planted world, field
offsets applied, optional background prefetch. The file readers
(Criteo, Avazu, MovieLens, pre-hashed .cfb), the packed wire format and
train-stream shuffling and downsampling arrive with the port's data
slice; until then a config that asks for them raises.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from cffm_tpu_torch.config import TrainConfig
from cffm_tpu_torch.data.synthetic import SyntheticCTR
from cffm_tpu_torch.models.cffm import field_offsets


class Batch(dict):
    """dict with attribute access: ids (B,F) int32 global, dense, labels."""

    __getattr__ = dict.__getitem__


def _raw_iterator(cfg: TrainConfig, process_index: int, process_count: int,
                  split: str):
    d = cfg.data
    if d.path is not None:
        raise NotImplementedError(
            "file datasets (data.path) arrive with the port's data slice; "
            "only the synthetic stream is ported")
    if split == "train" and (d.shuffle or 0.0 < d.neg_downsample < 1.0
                             or d.wire_format != "raw"):
        raise NotImplementedError(
            "train-stream shuffle, negative downsampling and the packed wire "
            "format arrive with the port's data slice")
    # All hosts and splits share one planted WORLD (seed); each host draws
    # its own sample stream, and the val stream is disjoint from every
    # host's train stream by a large seed offset.
    stream = d.seed + process_index + (104729 if split == "val" else 0)
    return iter(SyntheticCTR(cfg.model, d.batch_size // process_count,
                             seed=d.seed, stream_seed=stream))


def make_dataset(cfg: TrainConfig, process_index: int = 0,
                 process_count: int = 1, prefetch: int = 2,
                 split: str = "train", skip_batches: int = 0,
                 repeat: bool = True) -> Iterator[Batch]:
    """Host batches for this process: Batch(ids, dense, labels) of numpy
    arrays, ids global (offset-applied) int32.

    split="val" yields the held-out stream. The synthetic stream is
    infinite and ignores repeat: callers bound it. skip_batches
    fast-forwards the stream. prefetch > 0 makes batches on a background
    thread, that many ahead."""
    offsets = field_offsets(cfg.model)[None, :].astype(np.int32)
    raw = _raw_iterator(cfg, process_index, process_count, split)
    for _ in range(skip_batches):
        next(raw)

    def to_batch(item) -> Batch:
        ids, dense, labels = item
        return Batch(
            ids=(ids + offsets).astype(np.int32),
            dense=None if dense is None else dense.astype(np.float32),
            labels=labels.astype(np.float32),
        )

    if prefetch <= 0:
        return (to_batch(x) for x in raw)

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        try:
            for item in raw:
                if stop.is_set():
                    return
                q.put(to_batch(item))
        finally:
            q.put(None)

    threading.Thread(target=producer, daemon=True).start()

    def consumer():
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()

    return consumer()

"""Batcher and sharder: config -> iterator of host batches with global ids,
and the staging of those batches on the card.

The port's counterpart of `cffm_tpu/data/loader.py`, batch for batch the
same: the synthetic stream, the Criteo and Avazu file readers (native
multi-threaded, native or Python, picked as the JAX loader picks them),
MovieLens, pre-hashed .cfb files (detected by their magic), the
train-stream shuffle buffer and negative downsampling, the held-out
split, `repeat=False` passes that end with a partial batch, and the
packed wire format. Field offsets are applied on the host for raw
batches and on the device for packed ones (`data/wire.py`).

`device_prefetch` stages batches on the card ahead of the step: pinned
host buffers, non-blocking copies on a side CUDA stream, and an event
the consuming stream waits on.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from cffm_tpu_torch.config import TrainConfig
from cffm_tpu_torch.data.prehashed import is_prehashed, prehashed_batches
from cffm_tpu_torch.data.readers import file_batches, movielens_batches, resolve_paths
from cffm_tpu_torch.data.synthetic import SyntheticCTR
from cffm_tpu_torch.data.wire import host_tensor
from cffm_tpu_torch.models.cffm import field_offsets


class Batch(dict):
    """dict with attribute access: ids (B,F) int32 global, dense, labels;
    or wire (the packed wire dict, data/wire.py)."""

    __getattr__ = dict.__getitem__


def shuffled_batches(raw, buffer_rows: int, seed: int = 0):
    """Uniform shuffle buffer over a stream of exact-size batches.

    Keep a `buffer_rows` pool; for each incoming batch of B rows, emit B
    rows drawn (without replacement) from uniformly random pool positions
    and write the incoming rows into those slots. Emission starts once the
    pool is full; at the end of the stream the pool flushes in permuted
    order as full batches (the final partial batch is dropped).
    """
    rng = np.random.default_rng(seed)
    raw = iter(raw)
    first = next(raw, None)
    if first is None:
        return
    batch = len(first[0])
    buffer_rows = max(buffer_rows, batch)  # must hold >= one emit's worth
    has_dense = first[1] is not None

    def split_rows(pool, pos):
        return tuple(None if c is None else c[pos] for c in pool)

    pool = None
    for item in itertools.chain([first], raw):
        ids, dense, label = item
        if pool is None or len(pool[0]) < buffer_rows:
            cols = (ids, dense if has_dense else None, label)
            if pool is None:
                pool = tuple(None if c is None else np.array(c) for c in cols)
            else:
                pool = tuple(
                    None if c is None else np.concatenate([p, c])
                    for p, c in zip(pool, cols))
            continue
        pos = rng.choice(len(pool[0]), size=batch, replace=False)
        yield split_rows(pool, pos)
        pool[0][pos] = ids
        if has_dense:
            pool[1][pos] = dense
        pool[2][pos] = label
    if pool is not None:
        perm = rng.permutation(len(pool[0]))
        for s in range(0, len(perm) - batch + 1, batch):
            yield split_rows(pool, perm[s:s + batch])


def downsampled_batches(raw, keep_rate: float, seed: int = 0):
    """Negative downsampling over a stream of exact-size batches.

    Keeps every positive, keeps each negative with probability keep_rate,
    and re-accumulates the survivors into exact-size batches. The model
    then over-predicts by odds 1/keep_rate, which eval and serving correct
    by adding ln(keep_rate) to the logit (metrics.calibration_offset).
    """
    rng = np.random.default_rng(seed)
    pool = None
    batch = None
    for ids, dense, labels in raw:
        if batch is None:
            batch = len(labels)
        keep = (labels > 0.5) | (rng.random(len(labels)) < keep_rate)
        cols = (ids[keep], None if dense is None else dense[keep],
                labels[keep])
        pool = cols if pool is None else tuple(
            None if c is None else np.concatenate([p, c])
            for p, c in zip(pool, cols))
        while len(pool[2]) >= batch:
            yield tuple(None if c is None else c[:batch] for c in pool)
            pool = tuple(None if c is None else c[batch:] for c in pool)


def _raw_iterator(cfg: TrainConfig, process_index: int, process_count: int,
                  split: str = "train", repeat: bool = True):
    it = _raw_iterator_inner(cfg, process_index, process_count,
                             split=split, repeat=repeat)
    r = cfg.data.neg_downsample
    if split == "train" and 0.0 < r < 1.0:
        # train stream only: eval and serving see the true distribution
        it = downsampled_batches(it, r, seed=cfg.data.seed + process_index)
    return it


def _raw_iterator_inner(cfg: TrainConfig, process_index: int,
                        process_count: int,
                        split: str = "train", repeat: bool = True):
    d = cfg.data
    # path may be a file, a directory of files (full Criteo's day_0..day_23)
    # or a glob; a path that matches nothing takes the synthetic stream
    path_ok = d.path is not None and bool(resolve_paths(d.path))
    per_host = d.batch_size // process_count
    ve = d.val_every
    if path_ok and (d.dataset == "prehashed" or (
            d.dataset != "movielens" and is_prehashed(d.path))):
        # pre-hashed .cfb: shuffle only the train stream (eval order is
        # irrelevant, and determinism simplifies AUC comparisons)
        return prehashed_batches(
            d.path, cfg.model, per_host, process_index, process_count,
            split=split, val_every=ve, repeat=repeat,
            shuffle=d.shuffle and split == "train", seed=d.seed)
    if d.dataset in ("criteo", "avazu") and path_ok:
        it = file_batches(d.dataset, d.path, cfg.model, per_host, process_index,
                          process_count, split=split, val_every=ve, repeat=repeat,
                          reader_threads=d.reader_threads)
        if d.shuffle and split == "train" and d.shuffle_buffer > 0:
            it = shuffled_batches(it, d.shuffle_buffer, seed=d.seed)
        return it
    if d.dataset == "movielens" and path_ok:
        return movielens_batches(d.path, cfg.model, per_host,
                                 seed=d.seed + process_index,
                                 split=split, val_every=ve, repeat=repeat)
    # Synthetic: all hosts and splits share one planted WORLD (seed); each
    # host draws its own sample stream, and the val stream is disjoint
    # from every host's train stream by a large seed offset.
    stream = d.seed + process_index + (104729 if split == "val" else 0)
    return iter(SyntheticCTR(cfg.model, per_host, seed=d.seed,
                             stream_seed=stream))


def _threaded(items: Iterator, fn, depth: int) -> Iterator:
    """fn over items on a background thread, at most depth ahead. An
    exception of the thread is raised at the consumer, after the items
    made before it; closing the consumer stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for item in items:
                if not put(fn(item)):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised at the consumer
            put(e)
        finally:
            put(end)

    threading.Thread(target=producer, daemon=True).start()

    def consumer():
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    return consumer()


def _arrays(batch: dict) -> dict:
    """The host arrays of a batch: the wire dict, or ids, dense, labels."""
    if "wire" in batch:
        return batch["wire"]
    return {k: batch[k] for k in ("ids", "dense", "labels") if batch[k] is not None}


def _device_item(batch: dict, tensors: dict):
    """What device_prefetch yields: the wire dict of tensors, or
    (ids, dense | None, labels)."""
    if "wire" in batch:
        return tensors
    return tensors["ids"], tensors.get("dense"), tensors["labels"]


def device_prefetch(batches: Iterator[dict], device, depth: int = 2) -> Iterator:
    """Stage host batches on device, up to depth ahead, from a background
    thread.

    Yields (ids, dense | None, labels) tensors for raw batches, or the
    packed wire dict of tensors (data/wire.py) for Batch(wire=...).

    On a CUDA device each array goes into pinned host memory and is copied
    with non_blocking on a side stream, which records an event; the
    consumer's current stream waits on that event before the batch is
    handed over, and each device tensor is marked as used on the
    consumer's stream (record_stream), so the allocator does not reuse its
    block while the step still reads it. The host allocator keeps a pinned
    block from reuse until the copy recorded on it has finished. On the
    CPU the arrays are handed over as tensors unchanged, with no thread.
    """
    device = torch.device(device)
    if device.type != "cuda":
        return (_device_item(b, {k: host_tensor(v).to(device)
                                 for k, v in _arrays(b).items()})
                for b in batches)
    copy_stream = torch.cuda.Stream(device)

    def stage(b):
        with torch.cuda.stream(copy_stream):
            host = {k: host_tensor(v).pin_memory() for k, v in _arrays(b).items()}
            dev = {k: h.to(device, non_blocking=True) for k, h in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return b, dev, done

    def consume(staged):
        for b, dev, done in staged:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            for t in dev.values():
                t.record_stream(stream)
            yield _device_item(b, dev)

    return consume(_threaded(iter(batches), stage, depth))


def make_dataset(
    cfg: TrainConfig,
    process_index: int = 0,
    process_count: int = 1,
    prefetch: int = 2,
    split: str = "train",
    skip_batches: int = 0,
    repeat: bool = True,
) -> Iterator[Batch]:
    """Host batches for this process: Batch(ids, dense, labels) of numpy
    arrays, ids global (offset-applied) int32; or Batch(wire=...) of the
    packed wire format for the repeat-mode train stream when
    cfg.data.wire_format == "packed".

    split="val" yields the held-out stream (cfg.data.val_every).
    repeat=False ends a file stream after one pass (full-pass eval); its
    final batch may be PARTIAL. The synthetic stream is infinite and
    ignores repeat: callers bound it. skip_batches fast-forwards the
    stream (resume). prefetch > 0 makes batches on a background thread,
    that many ahead."""
    offsets = field_offsets(cfg.model)[None, :].astype(np.int32)
    raw = _raw_iterator(cfg, process_index, process_count, split=split,
                        repeat=repeat)
    for _ in range(skip_batches):
        next(raw)

    if cfg.data.wire_format == "packed" and split == "train" and repeat:
        # local ids in narrow dtypes; the step unpacks them and applies the
        # field offsets on the device. Only the repeat-mode train stream
        # packs: eval streams may end with a partial batch and feed the
        # eval step's raw signature.
        from cffm_tpu_torch.data import wire as wire_lib

        spec = wire_lib.spec_for_model(cfg.model)

        def to_batch(item) -> Batch:
            ids, dense, labels = item
            return Batch(wire=wire_lib.pack(ids, dense, labels, spec))
    else:
        def to_batch(item) -> Batch:
            ids, dense, labels = item
            return Batch(
                ids=(ids + offsets).astype(np.int32),
                dense=None if dense is None else dense.astype(np.float32),
                labels=labels.astype(np.float32),
            )

    if prefetch <= 0:
        return (to_batch(x) for x in raw)
    return _threaded(raw, to_batch, prefetch)

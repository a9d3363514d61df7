"""Ordered parallel map: the multi-threaded native parse pipeline.

The port's copy of `cffm_tpu/data/parallel_reader.py`. Byte chunks fan
out to a small thread pool; the ctypes call into the C++ parser releases
the GIL, so parsing scales with the threads until memory bandwidth. The
results come back IN INPUT ORDER, so the example stream is bit-equal to
the single-threaded readers' whatever the thread count.

Pipeline: feeder (file I/O) -> in_q -> N parse workers -> ordered
reassembly -> exact-batch_size rebatcher (readers._rebatch).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


def ordered_parallel_map(
    items: Iterator,
    fn: Callable,
    num_threads: int = 4,
    depth: int = 16,
) -> Iterator:
    """Apply fn to items on a thread pool, yielding results in input
    order. Backpressure: at most depth + num_threads items are unconsumed
    at once. An exception of fn, or of the items iterator itself, surfaces
    at the consumer in order, after every earlier result. fn must release the GIL to actually parallelize
    (C calls, file I/O)."""
    if num_threads < 1:
        raise ValueError(f"num_threads must be positive, got {num_threads}")
    in_q: "queue.Queue" = queue.Queue(maxsize=depth)
    results: dict = {}
    cv = threading.Condition()
    end_seq = [None]  # total item count once the feeder finishes
    stop = threading.Event()
    # Bounds TOTAL unconsumed items (queued + parsing + reassembled):
    # without it a stalled consumer lets the workers parse the entire
    # input into the reassembly dict. Gating the FEEDER (not the workers)
    # cannot deadlock: the next-needed seq is always already admitted.
    slots = threading.Semaphore(depth + num_threads)

    def feeder():
        seq = 0
        try:
            for item in items:
                slots.acquire()
                if stop.is_set():
                    return
                in_q.put((seq, item))
                seq += 1
        except Exception as e:  # noqa: BLE001 - the items' own error, surfaced in order
            with cv:
                results[seq] = e
            seq += 1
        finally:
            for _ in range(num_threads):
                in_q.put(None)
            with cv:
                end_seq[0] = seq
                cv.notify_all()

    def worker():
        while True:
            entry = in_q.get()
            if entry is None:
                return
            seq, item = entry
            try:
                res = fn(item)
            except Exception as e:  # noqa: BLE001 - surfaced at the consumer, in order
                res = e
            with cv:
                results[seq] = res
                cv.notify_all()

    threads = [threading.Thread(target=feeder, daemon=True)]
    threads += [threading.Thread(target=worker, daemon=True)
                for _ in range(num_threads)]
    for t in threads:
        t.start()

    def gen():
        nxt = 0
        try:
            while True:
                with cv:
                    while nxt not in results and end_seq[0] != nxt:
                        if end_seq[0] is not None and nxt >= end_seq[0]:
                            return
                        cv.wait()
                    if nxt not in results:
                        return
                    res = results.pop(nxt)
                slots.release()
                nxt += 1
                if isinstance(res, Exception):
                    raise res
                yield res
        finally:
            stop.set()
            slots.release()  # unblock a feeder parked in acquire()

    return gen()

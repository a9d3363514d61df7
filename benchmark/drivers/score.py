"""Offline scoring on one card: `models.cffm.forward` under inference
mode, with the sigmoid and calibration offset of `score.score`, over
batches read from pinned host memory.

Each batch's ids and dense features are copied to the card, scored, and
its probabilities copied back to pinned host memory, all enqueued on
one stream with no synchronize between batches: the host dispatches the
next batch while the card scores this one, as a scoring job over a day
of logs would. The window ends in a synchronize. The pool of batches is
made in set-up from the seed and cycled; each pool entry's slice of the
output buffer holds its last answer, which the reference checks once
the window has closed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import readers, reference, traffic, weights

SOURCES = ("cross_conv1_fwd",)


def make_pool(job):
    """Pinned host inputs of the pool's batches and their slices."""
    model, tr = job.model, job.traffic
    sizes = [int(tr["batch_size"])] * int(tr["pool_batches"])
    world = traffic.PlantedCTR(model["vocab_sizes"], model["num_dense"], job.seed, tr["ids"])
    gen = traffic.rng(job.seed, 1)
    offs = traffic.field_offsets(model["vocab_sizes"]).astype(np.int32)
    ids, dense = [], []
    for b in sizes:
        i, d, _ = world.batch(gen, b)
        ids.append(i + offs[None, :])
        dense.append(d)
    ids_h = torch.from_numpy(np.concatenate(ids))
    dense_h = None if dense[0] is None else torch.from_numpy(np.concatenate(dense))
    if job.device.type == "cuda":
        ids_h = ids_h.pin_memory()
        dense_h = None if dense_h is None else dense_h.pin_memory()
    starts = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    return sizes, starts, ids_h, dense_h


def run(job) -> dict:
    from cffm_tpu_torch import metrics as pm
    from cffm_tpu_torch.models.cffm import forward
    from cffm_tpu_torch.ops import _build
    from cffm_tpu_torch.train import default_interaction_fn

    dev = job.device
    laps = readers.Laps()
    cfg = job.train_config()
    if dev.type == "cuda":
        _build.build(SOURCES)
    laps.mark("build")
    sizes, starts, ids_h, dense_h = make_pool(job)
    laps.mark("pool")
    out_h = torch.empty((starts[-1],), dtype=torch.float32)
    if dev.type == "cuda":
        out_h = out_h.pin_memory()
    params = weights.make_params(job.model, job.seed, dev)
    fn = default_interaction_fn(cfg)
    cal = pm.calibration_offset(cfg.data)
    nb = dev.type == "cuda"

    def score(ids, dense):
        return torch.sigmoid(forward(params, ids, dense, cfg.model, interaction_fn=fn) + cal)

    score = job.wrap_step(score)

    def enqueue(e: int):
        s, x = starts[e], starts[e + 1]
        with torch.inference_mode():
            ids = ids_h[s:x].to(dev, non_blocking=nb)
            dense = None if dense_h is None else dense_h[s:x].to(dev, non_blocking=nb)
            out_h[s:x].copy_(score(ids, dense), non_blocking=nb)

    def sync():
        if nb:
            torch.cuda.synchronize(dev)

    laps.mark("weights")
    # set-up: one pass over the pool
    for e in range(len(sizes)):
        enqueue(e)
    sync()
    laps.mark("warm-up")

    if nb:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_end = time.time()
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < job.seconds:
        enqueue(n % len(sizes))
        n += 1
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if nb else 0
    served = np.zeros(len(sizes), dtype=bool)
    served[: min(n, len(sizes))] = True
    cands = sum(sizes[i % len(sizes)] for i in range(n))

    run_ = readers.Run(model=job.model, train=False, window_s=window_s, window_examples=cands)
    if job.trace:
        from benchmark import trace

        k = int(job.traffic["trace_batches"])
        before = readers.launch_counts()
        run_.trace = trace.traced(lambda: [enqueue((n + i) % len(sizes)) for i in range(k)])
        after = readers.launch_counts()
        run_.launches = {name: after[name] - before[name] for name in after}
        run_.items = [{"batch": sizes[(n + i) % len(sizes)]} for i in range(k)]

    # the reference, on weights drawn again, once the program's are freed
    del params
    if nb:
        torch.cuda.empty_cache()
    got = out_h.clone()
    ref_p = reference_probs(job, ids_h, dense_h, served, starts)
    gap = 0.0
    for e in np.flatnonzero(served):
        s, x = starts[e], starts[e + 1]
        d = float((got[s:x] - ref_p[e]).abs().max())
        gap = max(gap, d if np.isfinite(d) else float("inf"))
    failed = int(sum(int((~torch.isfinite(got[starts[e]:starts[e + 1]])).sum()) > 0
                     for e in np.flatnonzero(served)))
    return {"metrics": {"score_ex_per_s": cands / window_s},
            "setup_end": setup_end, "check_s": 0.0, "setup_laps": laps.seconds, "run": run_,
            "numbers": {"prob_gap": gap},
            "attempted": n, "failed": failed, "memory_peak_bytes": peak}


def reference_probs(job, ids_h, dense_h, served, starts, low: bool = False) -> dict:
    """The reference's probabilities of each served pool entry, {entry: (b,) cpu}."""
    params = weights.make_params(job.model, job.seed, job.device)
    cal = reference.log_downsample(job.config["data"]["neg_downsample"])
    out = {}
    for e in np.flatnonzero(served):
        s, x = starts[e], starts[e + 1]
        ids = ids_h[s:x].to(job.device)
        dense = None if dense_h is None else dense_h[s:x].to(job.device)
        logits = reference.forward(params, ids, dense, job.model, low=low)
        out[int(e)] = reference.probabilities(logits, cal).cpu()
    return out


def control_numbers(job) -> dict:
    """The control's number: the reference in fp8 in the program's place,
    over every request of the pool."""
    sizes, starts, ids_h, dense_h = make_pool(job)
    every = np.ones(len(sizes), dtype=bool)
    ctl = reference_probs(job, ids_h, dense_h, every, starts, low=True)
    ref = reference_probs(job, ids_h, dense_h, every, starts)
    return {"prob_gap": max(float((ctl[e] - ref[e]).abs().max()) for e in ref)}

"""Training on one card: the port's `train.train_step` (with
`train.default_interaction_fn`) on a pool of batches staged on the card.

Set-up makes the weights and the pool from the seed, builds the train
state once and drives it through its first CHECK_STEPS steps through the
window's own call on the pool's first batches, reading what the checks
need (each leaf's change and the rows that moved; with `job.readings`
also the losses and the first gradient from the optimizer state). The window then runs the same state on, cycling the pool, for
the run's seconds, and ends in a synchronize. Once it has closed the
state is freed and the reference trains the same weights on the same
CHECK_STEPS batches.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import checks, readers, reference, traffic, weights, work

SOURCES = ("cross_conv1_fwd", "cross_conv1_bwd", "sorted_segment", "streamed_update")
CHECK_STEPS = 3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_pool(job):
    """The pool's batches: host ids (local) and the card's tensors (global
    int32 ids, dense, labels), and the work items of each batch."""
    model, tr = job.model, job.traffic
    b = int(tr["batch_size"])
    world = traffic.PlantedCTR(model["vocab_sizes"], model["num_dense"], job.seed, tr["ids"])
    gen = traffic.rng(job.seed, 1)
    offs = traffic.field_offsets(model["vocab_sizes"]).astype(np.int32)
    fs = work.small_prefix(model)
    host, pool, items = [], [], []
    for _ in range(int(tr["pool_batches"])):
        ids, dense, labels = world.batch(gen, b)
        gids = ids + offs[None, :]
        host.append(gids)
        pool.append((torch.from_numpy(gids).to(job.device),
                     None if dense is None else torch.from_numpy(dense).to(job.device),
                     torch.from_numpy(labels).to(job.device)))
        big = gids[:, fs:]
        items.append({"batch": b, "ids": int(big.size),
                      "distinct": int(sum(np.unique(big[:, f]).size
                                          for f in range(big.shape[1])))})
    return host, pool, items


def dense_norms(tree: dict, scale: float = 1.0) -> dict:
    """Norms of the port's dense tree (conv, tower, linear_bias) by leaf name."""
    leaves = reference.dense_leaves({"conv": tree["conv"], "tower": tree["tower"],
                                     "linear": {"bias": tree["linear_bias"]}})
    return {k: float(v.float().norm()) * scale for k, v in leaves.items()}


def table_change(table, accum, job, touched) -> dict:
    """Each table leaf's change from the weights as drawn, the rows that
    changed outside `touched` (a bool mask of the rows) and the rows of
    `touched` that did not: every touched row moves in f32, if only in its
    first-order column, whose gradient is (p - y) / B per example."""
    rows = table.shape[0]
    init = float(job.config["optim"]["adagrad_init"])
    sq, untouched, unmoved = 0.0, 0, 0
    for b in weights.blocks(rows):
        start = b * weights.BLOCK_ROWS
        drawn = weights.table_block(job.model, job.seed, b, rows, table.device).to(table.dtype)
        part = table[start:start + drawn.shape[0]]
        diff = part.float() - drawn.float()
        sq += float((diff * diff).sum())
        hit = touched[start:start + drawn.shape[0]]
        moved = (part != drawn).any(dim=1)
        untouched += int(((moved | (accum[start:start + drawn.shape[0], 0] != init)) & ~hit).sum())
        unmoved += int((~moved & hit).sum())
        del drawn, diff
    return {"embed.table": math.sqrt(sq), "embed.accum": float((accum - init).norm()),
            "untouched": untouched, "unmoved": unmoved}


def touched_ids(host_batches, device) -> torch.Tensor:
    """The rows that the batches' ids touch, ascending."""
    return torch.from_numpy(np.unique(np.concatenate(host_batches))).to(device).long()


def reference_readings(job, batches, rows, low: bool = False) -> dict:
    """The reference's readings on the first batches, from weights drawn
    again from the seed (f32 table); `rows` are the touched rows, whose
    values before and after come back on the host."""
    params = weights.make_params(job.model, job.seed, job.device)
    table = params["embed"]["table"] = params["embed"]["table"].float()
    before = {k: p.clone() for k, p in reference.dense_leaves(params).items()}
    rows0 = table.index_select(0, rows).cpu()
    out = reference.train(params, batches, job.model, job.config["optim"], low=low)
    change = {k: float((p - before[k]).norm()) for k, p in reference.dense_leaves(params).items()}
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device=job.device)
    tab = table_change(table, out["accum"], job, touched)
    change["embed.table"], change["embed.accum"] = tab["embed.table"], tab["embed.accum"]
    return {"loss": out["loss"], "grad": out["grad"], "change": change,
            "untouched_changed": 0, "touched_unmoved": 0,
            "rows0": rows0, "rows": table.index_select(0, rows).cpu()}


def judged(prog: dict, ref: dict) -> dict:
    """The cell's numbers; the touched rows' values leave both readings."""
    prog["rows_gap"] = checks.rows_gap(prog.pop("rows"), ref["rows"], ref["rows0"])
    for k in ("rows", "rows0"):
        ref.pop(k)
    return checks.train_numbers(prog, ref)


def run(job) -> dict:
    from cffm_tpu_torch import train as tr
    from cffm_tpu_torch.ops import _build
    from cffm_tpu_torch.optim import rowwise

    dev = job.device
    laps = readers.Laps()
    cfg = job.train_config()
    optim = job.config["optim"]
    if dev.type == "cuda":
        _build.build(SOURCES)
    laps.mark("build")
    host, pool, items = make_pool(job)
    laps.mark("pool")
    params = weights.make_params(job.model, job.seed, dev)
    dense_p = tr.split_dense_params(params)
    table = params["embed"]["table"]
    state = tr.TrainState(0, params, rowwise.make_dense_optimizer(cfg.optim).init(dense_p),
                          {"embed": rowwise.rowwise_init(table, cfg.optim)})
    fn = tr.default_interaction_fn(cfg)
    step = job.wrap_step(lambda st, batch: tr.train_step(st, *batch, cfg, fn))
    _sync(dev)
    laps.mark("weights")

    # set-up: the first steps through the window's call, read for the checks
    check_s = 0.0
    t = time.perf_counter()
    if job.readings:
        first = torch.from_numpy(np.unique(host[0])).to(dev).long()
        rows0 = table.index_select(0, first).float()
    dense0 = {k: p.clone() for k, p in reference.dense_leaves(params).items()}
    check_s += time.perf_counter() - t
    prog = {"loss": []}
    for s in range(CHECK_STEPS):
        state, m = step(state, pool[s])
        prog["loss"].append(float(m["loss"]))
        laps.mark(f"step {s + 1}")
        if s == 0 and job.readings:
            t = time.perf_counter()
            lr = float(optim["sparse_lr"])
            acc = state.sparse_opt_state["embed"]["accum"].index_select(0, first)
            g = -(table.index_select(0, first).float() - rows0) * (acc.sqrt() + optim["eps"]) / lr
            prog["grad"] = dense_norms(state.dense_opt_state["mu"], 1.0 / (1.0 - optim["adam_b1"]))
            prog["grad"]["embed.table"] = float(g.norm())
            del g, acc, rows0, first
            check_s += time.perf_counter() - t
            laps.mark("checks")
    t = time.perf_counter()
    rows = touched_ids(host[:CHECK_STEPS], dev)
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    touched[rows] = True
    prog["rows"] = table.index_select(0, rows).float().cpu()
    prog["change"] = {k: float((p - dense0[k]).norm())
                      for k, p in reference.dense_leaves(state.params).items()}
    tab = table_change(table, state.sparse_opt_state["embed"]["accum"], job, touched)
    prog["untouched_changed"] = tab.pop("untouched")
    prog["touched_unmoved"] = tab.pop("unmoved")
    prog["change"].update(tab)
    del touched, dense0
    _sync(dev)
    check_s += time.perf_counter() - t
    laps.mark("checks")

    # the window
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n, losses = 0, []
    _sync(dev)
    setup_end = time.time()
    t0 = time.perf_counter()
    while True:
        state, m = step(state, pool[(CHECK_STEPS + n) % len(pool)])
        losses.append(m["loss"])
        n += 1
        if time.perf_counter() - t0 >= job.seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    b = int(job.traffic["batch_size"])

    run_ = readers.Run(model=job.model, train=True, window_s=window_s, window_examples=n * b,
                       table_bytes=table.element_size(), optimizer=optim["sparse_optimizer"])
    if job.trace:
        from benchmark import trace

        k = int(job.traffic["trace_steps"])
        first_item = CHECK_STEPS + n

        def stretch():
            nonlocal state
            for i in range(k):
                state, _ = step(state, pool[(first_item + i) % len(pool)])

        before = readers.launch_counts()
        run_.trace = trace.traced(stretch)
        after = readers.launch_counts()
        run_.launches = {name: after[name] - before[name] for name in after}
        run_.items = [items[(first_item + i) % len(pool)] for i in range(k)]

    # the reference, once the program's state is freed
    del state, params, table, dense_p, m, losses
    batches = pool[:CHECK_STEPS]
    del pool
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(job, batches, rows)
    numbers = judged(prog, ref)
    return {"metrics": {"train_ex_per_s": n * b / window_s},
            "setup_end": setup_end, "check_s": check_s, "setup_laps": laps.seconds, "run": run_,
            "numbers": numbers, "readings": {"program": prog, "reference": ref},
            "attempted": n, "failed": failed, "memory_peak_bytes": peak}


def control_numbers(job) -> dict:
    """The control's numbers: the reference in fp8 in the program's place."""
    host, pool, _ = make_pool(job)
    batches = pool[:CHECK_STEPS]
    rows = touched_ids(host[:CHECK_STEPS], job.device)
    ctl = reference_readings(job, batches, rows, low=True)
    ctl.pop("rows0")
    ref = reference_readings(job, batches, rows)
    return dict(judged(ctl, ref), **checks.train_readings(ctl, ref),
                readings={"program": ctl, "reference": ref})

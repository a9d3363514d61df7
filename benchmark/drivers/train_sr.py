"""Training on one card with a bf16 table rounded stochastically: the
port's `train.train_step` on a pool of batches staged on the card, as in
`drivers/train.py` (whose pool, table check and touched rows this takes
by import), judged by numbers that hold under stochastic rounding against
a reference that fits beside a table of tens of GB.

Under stochastic rounding most touched elements move by far less than
one bf16 ulp a step: such an element moves by one whole ulp with a small
probability, or not at all. The table's change norm, its rows' gaps and
the touched rows left unmoved then measure the rounding's noise, not the
step. The cell compares instead, after the CHECK_STEPS set-up steps:

- sr_gain_gap: over the elements of the touched rows whose reference
  change is under SMALL_ULP of their bf16 ulp, |1 - sum(sign(reference
  change) * port's change) / sum(|reference change|)|. Unbiased rounding
  reads near 0; rounding to nearest drops those changes and reads near 1;
- moved_gap: over the elements whose reference change is at least
  MOVED_ULPS of their ulps, sum(|port's change - reference change|) /
  sum(|reference change|);
- change_gap_median, conv0_w_change_gap, accum_change_gap and
  untouched_rows_changed (exactly 0), as `checks.train_numbers` computes
  them for the f32 cells.

The reference (`benchmark/reference.py`, as it is) trains a compact
table: the rows the check batches touch, drawn again from the seed and
cast as the table is, in f32, with the ids remapped to it. A row no id
touches takes no part in a step, so the compact table's losses,
gradients and changes are the whole table's. The control puts that
reference in fp8, with its table stored in bf16 and rounded to nearest
after each step, in the program's place.

The cell runs the configuration as it is deployed, its dither drawn on
the card (a 33 GB table's touched rows take tens of millions of 16-bit
draws a step, which one host core cannot keep up with). On a card the
run reads the port's count of the dithers it drew by device
(`ops/rounding.DRAWS`): a port that keeps no such count, or whose check
steps drew dither on the host, cannot run the cell, and the run stops
with run.py's code for that, 2, before its set-up or its window.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from benchmark import checks, readers, reference, weights, work
from benchmark.drivers import train as base

CHECK_STEPS = base.CHECK_STEPS
SMALL_ULP = 0.25
MOVED_ULPS = 4.0
# the numbers of checks.train_numbers that stochastic rounding leaves sound
KEPT = ("change_gap_median", "conv0_w_change_gap", "accum_change_gap", "untouched_rows_changed")
CHUNK_ROWS = 1 << 14


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at each element of x: 2^(e - 8) for |x| in [2^(e-1), 2^e)."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)


def drawn_rows(job, rows: torch.Tensor) -> torch.Tensor:
    """The table's rows `rows` (ascending, on the job's device) as drawn
    from the seed and cast to the table's dtype, in f32: only the blocks
    that hold one of them are drawn."""
    model = job.model
    total = sum(model["vocab_sizes"])
    dt = weights.dtype(model["table_dtype"])
    out = torch.empty((rows.numel(), work.table_width(model)), device=rows.device)
    edges = np.searchsorted(rows.cpu().numpy(),
                            np.arange(len(weights.blocks(total)) + 1) * weights.BLOCK_ROWS)
    for b in weights.blocks(total):
        i0, i1 = int(edges[b]), int(edges[b + 1])
        if i1 > i0:
            block = weights.table_block(model, job.seed, b, total, rows.device)
            out[i0:i1] = block[rows[i0:i1] - b * weights.BLOCK_ROWS].to(dt).float()
            del block
    return out


def reference_readings(job, batches, rows: torch.Tensor, low: bool = False,
                       nearest: bool = False) -> dict:
    """The reference's readings on the batches from the compact table of
    `rows` (the rows they touch, ascending): losses, the first gradient,
    each leaf's change, and the rows before and after (f32, on the
    device). nearest: store the table in bf16, rounded to nearest after
    each step (the control)."""
    dense = weights.make_dense(job.model, job.seed, job.device)
    table = drawn_rows(job, rows)
    params = {"embed": {"table": table}, "linear": {"bias": dense["bias"]},
              "conv": dense["conv"], "tower": dense["tower"]}
    before = {k: p.clone() for k, p in reference.dense_leaves(params).items()}
    rows0 = table.clone()
    local = [(torch.searchsorted(rows, ids.long()), dn, y) for ids, dn, y in batches]

    def to_bf16(step, p, accum):
        p["embed"]["table"].copy_(p["embed"]["table"].to(torch.bfloat16).float())

    out = reference.train(params, local, job.model, job.config["optim"], low=low,
                          on_step=to_bf16 if nearest else None)
    change = {k: float((p - before[k]).norm()) for k, p in reference.dense_leaves(params).items()}
    change["embed.table"] = float((table - rows0).norm())
    change["embed.accum"] = float((out["accum"] - float(job.config["optim"]["adagrad_init"])).norm())
    return {"loss": out["loss"], "grad": out["grad"], "change": change,
            "untouched_changed": 0, "rows0": rows0, "rows": table}


def rounding_numbers(prog_rows, ref_rows, rows0) -> dict:
    """sr_gain_gap and moved_gap of the touched rows' values (f32, one row
    each; rows0 as drawn and cast), in f64 sums over blocks of rows."""
    gain = small = err = moved = 0.0
    for s in range(0, rows0.shape[0], CHUNK_ROWS):
        r0 = rows0[s:s + CHUNK_ROWS]
        d_ref = ref_rows[s:s + CHUNK_ROWS] - r0
        d_prog = prog_rows[s:s + CHUNK_ROWS] - r0
        ulp, size = bf16_ulp(r0), d_ref.abs()
        lo = size < SMALL_ULP * ulp
        gain += float((torch.sign(d_ref) * d_prog)[lo].double().sum())
        small += float(size[lo].double().sum())
        hi = size >= MOVED_ULPS * ulp
        err += float((d_prog - d_ref).abs()[hi].double().sum())
        moved += float(size[hi].double().sum())
    return {"sr_gain_gap": abs(1.0 - gain / small) if small > 0 else math.inf,
            "moved_gap": err / moved if moved > 0 else math.inf}


def judged(prog: dict, ref: dict) -> dict:
    """The cell's numbers; the touched rows' values leave both readings."""
    rows, ref_rows, rows0 = prog.pop("rows"), ref.pop("rows"), ref.pop("rows0")
    # train_numbers also reads the two row numbers this cell leaves out
    shared = checks.train_numbers(dict(prog, rows_gap=math.nan, touched_unmoved=math.nan), ref)
    return dict({k: shared[k] for k in KEPT}, **rounding_numbers(rows, ref_rows, rows0))


def first_grads(state, optim: dict, width: int) -> dict:
    """Norms of the first step's gradients: the dense leaves' from Adam's
    first moment, the table's from the row-wise accumulator (f32, exact
    under any table rounding): accum - init = mean(g^2) over a row's
    width."""
    out = base.dense_norms(state.dense_opt_state["mu"], 1.0 / (1.0 - optim["adam_b1"]))
    acc = state.sparse_opt_state["embed"]["accum"]
    out["embed.table"] = math.sqrt(width * float((acc - optim["adagrad_init"]).double().sum()))
    return out


def _stop(job, why: str):
    """End the run with run.py's code for a port that cannot run the cell."""
    print(f"benchmark: {job.workload}: {why}", file=sys.stderr, flush=True)
    raise SystemExit(2)


def card_draws(rounding, job) -> dict | None:
    """The port's dithers drawn so far by device type on a card (None on
    the CPU, where the dither is the CPU generator's). A port that keeps
    no such count stops the run."""
    if job.device.type != "cuda":
        return None
    draws = getattr(rounding, "DRAWS", None)
    if draws is None:
        _stop(job, "the port keeps no count of where it draws the stochastic rounding's "
                   "dither (ops/rounding.DRAWS); this cell draws it on the card")
    return dict(draws)


def check_card_draws(rounding, job, before: dict | None) -> None:
    """Stop the run unless the steps since `before` (card_draws) drew
    dither on the card and none on the host."""
    if before is None:
        return
    host = rounding.DRAWS.get("cpu", 0) - before.get("cpu", 0)
    card = rounding.DRAWS.get("cuda", 0) - before.get("cuda", 0)
    if host or not card:
        _stop(job, f"the check steps drew {host} dithers on the host and {card} on the card; "
                   "this cell draws them on the card")


def run(job) -> dict:
    from cffm_tpu_torch import train as tr
    from cffm_tpu_torch.ops import _build, rounding
    from cffm_tpu_torch.optim import rowwise

    dev = job.device
    drawn = card_draws(rounding, job)
    laps = readers.Laps()
    cfg = job.train_config()
    optim = job.config["optim"]
    if dev.type == "cuda":
        _build.build(base.SOURCES)
    laps.mark("build")
    host, pool, items = base.make_pool(job)
    laps.mark("pool")
    params = weights.make_params(job.model, job.seed, dev)
    dense_p = tr.split_dense_params(params)
    table = params["embed"]["table"]
    state = tr.TrainState(0, params, rowwise.make_dense_optimizer(cfg.optim).init(dense_p),
                          {"embed": rowwise.rowwise_init(table, cfg.optim)})
    fn = tr.default_interaction_fn(cfg)
    step = job.wrap_step(lambda st, batch: tr.train_step(st, *batch, cfg, fn))
    base._sync(dev)
    laps.mark("weights")

    # set-up: the first steps through the window's call, read for the checks
    t = time.perf_counter()
    dense0 = {k: p.clone() for k, p in reference.dense_leaves(params).items()}
    check_s = time.perf_counter() - t
    prog = {"loss": []}
    for s in range(CHECK_STEPS):
        state, m = step(state, pool[s])
        prog["loss"].append(float(m["loss"]))
        laps.mark(f"step {s + 1}")
        if s == 0 and job.readings:
            t = time.perf_counter()
            prog["grad"] = first_grads(state, optim, table.shape[1])
            check_s += time.perf_counter() - t
            laps.mark("checks")
    check_card_draws(rounding, job, drawn)
    t = time.perf_counter()
    rows = base.touched_ids(host[:CHECK_STEPS], dev)
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    touched[rows] = True
    prog["rows"] = table.index_select(0, rows).float()
    prog["change"] = {k: float((p - dense0[k]).norm())
                      for k, p in reference.dense_leaves(state.params).items()}
    tab = base.table_change(table, state.sparse_opt_state["embed"]["accum"], job, touched)
    prog["untouched_changed"] = tab.pop("untouched")
    tab.pop("unmoved")
    prog["change"].update(tab)
    del touched, dense0
    base._sync(dev)
    check_s += time.perf_counter() - t
    laps.mark("checks")
    # the rest of the pool once, so that the window meets no batch first
    for i in range(CHECK_STEPS, len(pool)):
        state, m = step(state, pool[i])
    base._sync(dev)
    laps.mark("warm-up")

    # the window
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n, losses = 0, []
    base._sync(dev)
    setup_end = time.time()
    t0 = time.perf_counter()
    while True:
        state, m = step(state, pool[(CHECK_STEPS + n) % len(pool)])
        losses.append(m["loss"])
        n += 1
        if time.perf_counter() - t0 >= job.seconds:
            break
    base._sync(dev)
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
    """The control's numbers: the reference in fp8, its table stored in
    bf16 and rounded to nearest after each step, in the program's place."""
    host, pool, _ = base.make_pool(job)
    batches = pool[:CHECK_STEPS]
    rows = base.touched_ids(host[:CHECK_STEPS], job.device)
    ctl = reference_readings(job, batches, rows, low=True, nearest=True)
    ctl.pop("rows0")
    ref = reference_readings(job, batches, rows)
    numbers = judged(ctl, ref)
    return dict(numbers, **checks.train_readings(ctl, ref),
                readings={"program": ctl, "reference": ref})

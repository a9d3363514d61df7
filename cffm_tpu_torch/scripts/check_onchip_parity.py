"""On-card parity sweep of the kernels' numeric contracts.

    python -m cffm_tpu_torch.scripts.check_onchip_parity

The port's counterpart of `scripts/check_onchip_parity.py`, with its
cases, numpy references and tolerances. The CPU tests reach only the
plain versions, so a fault in a CUDA kernel's compiled code shows only
here (on the TPU a `<< 16` passed every interpret-mode test and then
corrupted ids >= 2^16 on the chip). Six checks:

  sorted_segment       kernel 3 at five (n, vmax) streams, W = 256: ids
                       >= 2^16 and >= 2^24, n not a multiple of the
                       kernel's chunk, a heavy-duplicate stream; uids and
                       count exact, gsum within 0.05 relative (bf16 grads).
                       The JAX kernel's `max_id` hint (its two rider paths)
                       has no counterpart: the CUDA kernel stores ids whole.
  streamed_apply       adagrad on a 140,000 x 256 f32 table, 4096 ids:
                       `optim.rowwise.rowwise_update` with streamed_update
                       "on" (kernels 3-4) against "off" (the scatter path):
                       table within 5e-3, accumulator within 5e-4.
  scatter_update       the scatter route's kernels (`sorted_segment.
                       scatter_segment_sum`, `streamed_update.
                       scatter_rowwise_apply`; no JAX counterpart) at
                       full-train-zipf's shapes on the card: 851,968 bf16
                       grads of W = 640 (26 fields of 32,768 zipf ids into
                       1M buckets each, ~50k live rows, the rows past
                       criteo_full's 832 prefix rows of its 26,000,832);
                       a small case on the CPU. Sums within f32
                       reassociation of the eager route's (2 (len - 1)
                       2^-24 sum|g| a segment) and bit-equal from call to
                       call. `optim.rowwise.rowwise_update`, kernels (bf16
                       grads) against the eager route (the same grads in
                       f32), for adagrad, sgd and rowwise_adam on an f32
                       table of the live rows with an untouched row between
                       each two: table steps within 1e-4 of the largest,
                       state within 1e-5 of its largest, untouched rows
                       bit-equal (rowwise_adam's state within 3e-5: the
                       kernel's (1 - b2) in f32 is 1.3e-5 below 0.001).
                       Adagrad and sgd into the cell's 26M-row
                       bf16 table rounded stochastically (rowwise_adam,
                       whose first moment is (V, W) f32, into the compact
                       table in bf16) against the eager route's f32 result:
                       each element within one bf16 ulp of it (and 1e-4 of
                       the step), their mean gap within 4 standard errors,
                       the state as above, two calls with one key
                       bit-equal and every row no id touches bit-equal. The
                       rounding unbiased over 8 values x 327,680 draws (4
                       standard errors, both ways taken).
  interaction_kernel   f = 15, d = 16, conv (16,), k = 3, B = 256, f32,
                       first-order column fused: kernel 1 on the
                       field-major and batch-major full-rows routes
                       (`models.cffm.forward_from_rows`) against the
                       reference conv (1e-3), and kernel 2 through autograd
                       on both routes against the reference's gradients
                       (2e-2 of the largest, rows and conv weight). TF32 is
                       off while it runs.
  embed_lookup         the field-major lookup (`ops.embed_lookup`, no JAX
                       counterpart) on a 140,000 x 256 table, B = 4096, 15
                       fields with a 5-field prefix of 64 ids each: f32 and
                       bf16 tables, int32, int64 and strided ids, bf16 and
                       f32 outputs, prefix ids outside their block and big
                       ids outside the table; bit-equal to the plain version.
  conv_tail_grad       a train step's forward and backward through the conv
                       tail's Function (its forward and backward kernels):
                       f = 15, d = 16, conv (64, 64), k = 3, pool 2, B = 300,
                       bf16, first-order column fused, on the field-major
                       full-rows route
                       (`models.cffm.forward_from_rows`); the logits and the
                       gradients to the rows and every conv leaf against the
                       same step on the CPU, whose tail is eager (2e-2 of the
                       largest, as the interaction check holds bf16).

On the card each check also requires its kernels' launch counts to rise:
a route that fell to a plain version fails. Prints `ONCHIP PARITY: OK` or
`FAIL` and exits 0 or 1; without a CUDA card it exits 2, refusing to pass
on the plain versions. The functions take `device` ("cpu" runs the plain
versions, as the tests do).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys

import numpy as np
import torch

# (n, vmax) of the kernel-3 streams; W of their rows
SORTED_SEGMENT_CASES = ((8000, 26_000_000), (8192, 2_600_000), (12345, 70_000),
                        (8192, 3_000), (300, 17_000_000))
SEGMENT_W = 256


def _launched(fns, before, device: torch.device) -> bool:
    """On the card, every wrapper in fns launched since `before` (their
    counts then); on the CPU the plain versions ran and nothing is owed."""
    if device.type != "cuda":
        return True
    return all(fn.launches > n for fn, n in zip(fns, before))


def check_sorted_segment(device="cuda") -> bool:
    """uids, gsum and count of kernel 3 against a numpy reference."""
    from cffm_tpu_torch.ops.sorted_segment import sorted_segment_sum_compact

    device = torch.device(device)
    ok = True
    for trial, (n, vmax) in enumerate(SORTED_SEGMENT_CASES):
        rng = np.random.default_rng(trial)
        sid = np.sort(rng.integers(0, vmax, size=n)).astype(np.int32)
        grads = rng.normal(size=(n, SEGMENT_W)).astype(np.float32)
        uu, inv = np.unique(sid, return_inverse=True)
        m_pad = ((len(uu) + 255) // 128) * 128
        before = [sorted_segment_sum_compact.launches]
        uids, gsum, count = sorted_segment_sum_compact(
            torch.from_numpy(sid).to(device), torch.from_numpy(grads).to(device), m_pad)
        uids = uids.cpu().numpy()
        ref = np.zeros((len(uu), SEGMENT_W), np.float32)
        np.add.at(ref, inv, grads)
        got = gsum[: len(uu)].float().cpu().numpy()
        gerr = float(np.max(np.abs(got - ref) / (np.abs(ref) + 1)))
        good = (np.array_equal(uids[: len(uu)], uu)
                and int(count) == len(uu)
                and bool(np.all(uids[int(count):] == -1))
                and gerr < 0.05  # bf16 grad inputs
                and _launched([sorted_segment_sum_compact], before, device))
        print(f"sorted_segment[{trial}] n={n} vmax={vmax} uniq={len(uu)} gerr={gerr:.4f} "
              f"-> {'ok' if good else 'FAIL'}", flush=True)
        ok &= good
    return ok


def check_streamed_apply(device="cuda") -> bool:
    """The streamed adagrad apply (kernels 3-4) against the scatter path
    on a table with ids past 2^16 rows."""
    from cffm_tpu_torch.config import OptimizerConfig
    from cffm_tpu_torch.ops.sorted_segment import sorted_segment_sum_compact
    from cffm_tpu_torch.ops.streamed_update import streamed_rowwise_apply
    from cffm_tpu_torch.optim.rowwise import rowwise_init, rowwise_update

    device = torch.device(device)
    rng = np.random.default_rng(7)
    v, w, n = 140_000, 256, 4096
    table = (0.01 * rng.normal(size=(v, w))).astype(np.float32)
    ids = rng.integers(0, v, size=n).astype(np.int32)
    grads = (0.01 * rng.normal(size=(n, w))).astype(np.float32)
    opt_s = OptimizerConfig(sparse_optimizer="adagrad", sparse_lr=0.05, streamed_update="on")
    opt_x = dataclasses.replace(opt_s, streamed_update="off")
    kernels = [sorted_segment_sum_compact, streamed_rowwise_apply]
    outs, launched = {}, True
    for name, opt in (("streamed", opt_s), ("scatter", opt_x)):
        t = torch.from_numpy(table).to(device)
        st = rowwise_init(t, opt)
        before = [fn.launches for fn in kernels]
        rowwise_update(t, st, torch.from_numpy(ids).to(device),
                       torch.from_numpy(grads).to(device), opt, max_unique=n + 1)
        if name == "streamed":
            launched = _launched(kernels, before, device)
        outs[name] = (t.cpu().numpy(), st["accum"].cpu().numpy())
    dt = float(np.max(np.abs(outs["streamed"][0] - outs["scatter"][0])))
    da = float(np.max(np.abs(outs["streamed"][1] - outs["scatter"][1])))
    # the streamed route sums bf16 grads; the scatter path sums f32
    good = dt < 5e-3 and da < 5e-4 and launched
    print(f"streamed_apply dtable={dt:.2e} daccum={da:.2e} -> {'ok' if good else 'FAIL'}",
          flush=True)
    return good


# (ids a field, buckets a field) of check_scatter_update by device type: on
# the card full-train-zipf's 26 fields of 32,768 ids into criteo_full's 1M
# buckets each, past its 832 prefix rows; a small case on the CPU
SCATTER_CASES = {"cuda": (32_768, 1_000_000), "cpu": (512, 1_500)}
SCATTER_FIELDS, SCATTER_PREFIX, SCATTER_W = 26, 832, 640
SCATTER_CHUNK = 1 << 20  # rows of the cell's table drawn from one seed
# the state's gap over its largest value: kernel 4 takes rowwise_adam's
# (1 - b2) in f32, 1.3e-5 below the eager route's 0.001, and so its v
SCATTER_STATE_GAP = {"adagrad": 1e-5, "sgd": 1e-5, "rowwise_adam": 3e-5}


def _scatter_ids(b: int, buckets: int, rng) -> np.ndarray:
    """A field-major (fields, b) block of zipf(1.3) ids, field f in its rows
    [SCATTER_PREFIX + f buckets, + buckets), flattened: the scatter route's
    traffic."""
    ids = np.minimum(rng.zipf(1.3, size=(SCATTER_FIELDS, b)) - 1, buckets - 1)
    base = SCATTER_PREFIX + buckets * np.arange(SCATTER_FIELDS)[:, None]
    return (ids + base).astype(np.int32).reshape(-1)


def _scatter_rows(c: int, v: int, w: int, seed: int, device) -> torch.Tensor:
    """Chunk c of a v-row bf16 start table, its rows [c C, (c + 1) C) for
    C = SCATTER_CHUNK, drawn from a seed of its own, so that any chunk can
    be drawn again."""
    gen = torch.Generator(device=device).manual_seed(seed + c)
    rows = min(SCATTER_CHUNK, v - c * SCATTER_CHUNK)
    return (0.01 * torch.randn((rows, w), generator=gen, device=device)).to(torch.bfloat16)


def _route(table, ids, g, opt, key=None) -> dict:
    """`rowwise_update` of a fresh state; returns the state."""
    from cffm_tpu_torch.optim import rowwise

    state = rowwise.rowwise_init(table, opt)
    rowwise.rowwise_update(table, state, ids, g, opt, max_unique=ids.numel() + 1,
                           mask_sentinels=False, sr_key=key)
    return state


def _state_err(got: dict, want: dict) -> float:
    """The largest gap of the row states, each over its largest value."""
    return max((float((got[k] - want[k]).abs().max() / want[k].abs().max())
                for k in want if want[k].dim()), default=0.0)


def _sr_gaps(got: torch.Tensor, want: torch.Tensor, step: float) -> tuple:
    """bf16 rows rounded stochastically against their f32 expectation:
    (each element within one bf16 ulp of it and 1e-4 of the step, the mean
    gap over its 4 standard errors)."""
    d = got.float() - want
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 8)
    within = bool((d.abs() <= ulp + 1e-4 * step).all())
    mean_se = float(d.mean().abs() / (d.std() / d.numel() ** 0.5 * 4))
    return within, mean_se


def check_scatter_update(device="cuda", report: dict | None = None) -> bool:
    """The scatter route's sums and apply against its eager code (see the
    module note). report: a dict that takes the sums' and the f32 apply's
    largest gaps from the eager route."""
    from cffm_tpu_torch.config import OptimizerConfig
    from cffm_tpu_torch.ops import sorted_segment as ss
    from cffm_tpu_torch.ops import streamed_update as su
    from cffm_tpu_torch.optim import rowwise

    device = torch.device(device)
    b, buckets = SCATTER_CASES[device.type]
    w, v = SCATTER_W, SCATTER_PREFIX + SCATTER_FIELDS * buckets
    ids = torch.from_numpy(_scatter_ids(b, buckets, np.random.default_rng(11))).to(device)
    n_ids = ids.numel()
    gen = torch.Generator(device=device).manual_seed(3)
    grads = (1e-3 * torch.randn((n_ids, w), generator=gen, device=device)).to(torch.bfloat16)
    kernels = [ss.scatter_segment_sum, su.scatter_rowwise_apply]
    before = [fn.launches for fn in kernels]

    # the sums: against the eager route's, and from call to call
    order, seg, uids, bounds = rowwise.scatter_plan(ids, v, n_ids + 1)
    lo, n = bounds()
    live = uids[lo:lo + n].long()
    got = ss.scatter_segment_sum(order, seg, grads, lo, n)
    again = ss.scatter_segment_sum(order, seg, grads, lo, n)
    m = uids.shape[0]
    want = rowwise._segment_sums(grads, order, seg, m)[lo:lo + n]
    abs_sum = rowwise._segment_sums(grads.abs(), order, seg, m)[lo:lo + n]
    lens = torch.bincount(seg, minlength=m)[lo:lo + n].float()[:, None]
    sums_err = float((got - want).abs().max())
    excess = float(((got - want).abs() - 2 * (lens - 1).clamp(min=0) * 2.0**-24 * abs_sum).max())
    sums_ok = excess <= 0 and torch.equal(got.view(torch.int32), again.view(torch.int32))
    del got, again, want, abs_sum, lens, order, seg, uids

    # the cell's bf16 table, each chunk of rows from its own seed
    seed, chunks = 7, range(-(-v // SCATTER_CHUNK))
    table = torch.empty((v, w), dtype=torch.bfloat16, device=device)
    for c in chunks:
        table[c * SCATTER_CHUNK:(c + 1) * SCATTER_CHUNK] = _scatter_rows(c, v, w, seed, device)
    start_live = table[live].clone()

    # every optimizer on an f32 table of the live rows' start, an untouched
    # row after each: the kernels (bf16 grads) against the eager route (f32)
    cids = 2 * torch.searchsorted(live, ids.long())
    cstart = 0.01 * torch.randn((2 * n, w), generator=gen, device=device)
    cstart[0::2] = start_live.float()
    f32, expect = {}, {}
    for name in ("adagrad", "sgd", "rowwise_adam"):
        opt = OptimizerConfig(sparse_optimizer=name, sparse_lr=0.05, streamed_update="off")
        tk, te = cstart.clone(), cstart.clone()
        sk, se = _route(tk, cids, grads, opt), _route(te, cids, grads.float(), opt)
        step = float((te - cstart).abs().max())
        f32[name] = (float((tk - te).abs().max()), step, _state_err(sk, se))
        f32[name] += (torch.equal(tk[1::2], cstart[1::2]),)
        expect[name] = (te[0::2], se, step)
    f32_ok = all(e <= 1e-4 * st and se <= SCATTER_STATE_GAP[k] and keep
                 for k, (e, st, se, keep) in f32.items())
    apply_err = max(e for e, _, _, _ in f32.values())
    del cstart

    # bf16 tables rounded stochastically against those f32 expectations:
    # adagrad and sgd into the cell's table, rowwise_adam into the compact
    # one; one key twice gives the same bits
    sr = {}
    cbf = torch.zeros((2 * n, w), dtype=torch.bfloat16, device=device)
    cbf[0::2] = start_live
    for name, tab, at, bids in (("adagrad", table, live, ids), ("sgd", table, live, ids),
                                ("rowwise_adam", cbf, 2 * torch.arange(n, device=device),
                                 cids)):
        opt = OptimizerConfig(sparse_optimizer=name, sparse_lr=0.05, streamed_update="off",
                              table_rounding="stochastic")
        te, se, step = expect[name]
        runs = []
        for _ in range(2):
            tab[at] = start_live
            state = _route(tab, bids, grads, opt, key=torch.Generator().manual_seed(5))
            runs.append((tab[at].clone(), {k: t[at] for k, t in state.items() if t.dim()}))
        (r, st), (r2, _) = runs
        within, mean_se = _sr_gaps(r, te, step)
        err = _state_err(st, {k: t[0::2] for k, t in se.items() if t.dim()})
        same = torch.equal(r.view(torch.int16), r2.view(torch.int16))
        moved = float((r.view(torch.int16) != start_live.view(torch.int16)).any(dim=1)
                      .float().mean())
        sr[name] = (within, mean_se, err, same, moved)
        del runs, r, r2, st, state
    sr_ok = all(within and mean_se <= 1 and err <= SCATTER_STATE_GAP[k] and same and moved > 0.5
                for k, (within, mean_se, err, same, moved) in sr.items())
    # every row no id touched, drawn again from its seed: bit-equal
    touched = torch.zeros(v, dtype=torch.bool, device=device)
    touched[live] = True
    kept = True
    for c in chunks:
        rows = slice(c * SCATTER_CHUNK, (c + 1) * SCATTER_CHUNK)
        again = _scatter_rows(c, v, w, seed, device)
        kept &= torch.equal(table[rows][~touched[rows]].view(torch.int16),
                            again[~touched[rows]].view(torch.int16))
    kept = kept and torch.equal(cbf[1::2].view(torch.int16),
                                torch.zeros_like(cbf[1::2]).view(torch.int16))
    del table, cbf, touched

    # unbiased: x = 1 + k/8 ulp (k = 1..8, a value a column group), sgd by lr 1
    rows_n, ulp = 4096, 2.0**-7
    frac = (torch.arange(w, device=device) % 8 + 1).float() / 8.0 * ulp * 0.999
    table = torch.ones((rows_n, w), dtype=torch.bfloat16, device=device)
    s = (-frac).expand(rows_n, w).contiguous()
    su.scatter_rowwise_apply(table, {}, torch.arange(rows_n, dtype=torch.int32, device=device),
                             s, OptimizerConfig(sparse_optimizer="sgd",
                                                table_rounding="stochastic"),
                             1.0, sr_key=torch.Generator().manual_seed(12345))
    x = 1.0 + frac
    r = table.float()
    mean = torch.stack([r[:, k::8].mean() for k in range(8)])
    target = x[:8]
    draws = rows_n * (w // 8)
    unbiased = bool(((mean - target).abs() <= 4 * ulp / np.sqrt(draws)).all())
    both = all(len(torch.unique(r[:, k::8])) == 2 for k in range(8))
    launched = _launched(kernels, before, device)
    good = sums_ok and f32_ok and sr_ok and kept and unbiased and both and launched
    if report is not None:
        report.update(sums_max_abs_err=sums_err, apply_max_abs_err=apply_err)
    def show(parts):
        return {k: tuple(f"{x:.3g}" if isinstance(x, float) else x for x in t)
                for k, t in parts.items()}

    print(f"scatter_update n_ids={n_ids} live={n} W={w} table={v}: sums err {sums_err:.2e}, "
          f"over their f32 limit by {max(excess, 0.0):.2e}, two calls equal {sums_ok}; f32 "
          f"tables (table err, step, state err, untouched equal): {show(f32)}; bf16 "
          f"stochastic (within an ulp, mean gap over 4 s.e., state err, repeatable, moved): "
          f"{show(sr)}, untouched equal {kept}; mean - x in ulps "
          f"{[round(float(d), 5) for d in (mean - target) / ulp]}, unbiased {unbiased}, both "
          f"ways {both}; launched {launched} -> {'ok' if good else 'FAIL'}", flush=True)
    return good


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _interaction_case(device: torch.device):
    from cffm_tpu_torch.config import ModelConfig
    from cffm_tpu_torch.models import cffm as model_lib

    f, d = 15, 16
    cfg = ModelConfig(num_fields=f, vocab_sizes=(32,) * f, embed_dim=d, cross="field_aware",
                      conv_channels=(16,), conv_kernel=3, compute_dtype="float32",
                      use_first_order=True)
    params = model_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(5)
    rows = torch.from_numpy((rng.normal(size=(256, f, cfg.table_width)) * 0.1)
                            .astype(np.float32)).to(device)
    return cfg, params, rows


def check_interaction_kernel(device="cuda") -> bool:
    """Kernel 1 (forward) and kernel 2 (backward through autograd) on the
    field-major and batch-major full-rows routes against the reference."""
    from cffm_tpu_torch.models import cffm as model_lib
    from cffm_tpu_torch.ops import interaction_conv as ic

    device = torch.device(device)
    cfg, params, rows = _interaction_case(device)
    if not cfg.fused_linear:
        raise AssertionError("the case needs the fused first-order column")
    fn = ic.make_interaction_fn(use_kernel=True)

    fm = model_lib.Route(full_rows=True, field_major=True, prefix=0)
    routes = {"fm": fm, "bm": fm.batch_major(), "ref": model_lib.Route(False, False, 0)}

    def forward(route, p, r):
        rows = [r.transpose(0, 1)] if route == "fm" else [r]
        return model_lib.forward_from_rows(p, routes[route], rows, None, cfg,
                                           interaction_fn=None if route == "ref" else fn)

    def grads(route):
        w = params["conv"][0]["w"].detach().clone().requires_grad_()
        p = dict(params, conv=[dict(params["conv"][0], w=w)])
        r = rows.clone().requires_grad_()
        loss = (forward(route, p, r) ** 2).sum()
        return torch.autograd.grad(loss, [r, w])

    entry = {"fm": ic.cross_conv1_lin_fm, "bm": ic.cross_conv1_lin}
    with _no_tf32(), torch.no_grad():
        ref = forward("ref", params, rows)
        before = [entry["bm"].launches, entry["fm"].launches]
        got_bm = forward("bm", params, rows)
        got_fm = forward("fm", params, rows)
        fwd_launched = _launched([entry["bm"], entry["fm"]], before, device)
    e_bm = float((got_bm - ref).abs().max())
    e_fm = float((got_fm - ref).abs().max())
    good = e_bm < 1e-3 and e_fm < 1e-3 and fwd_launched
    print(f"interaction fwd err bm={e_bm:.2e} fm={e_fm:.2e} -> {'ok' if good else 'FAIL'}",
          flush=True)

    with _no_tf32():
        gr_r, gr_w = grads("ref")
        scale = float(gr_r.abs().max()) + 1e-9
        w_scale = float(gr_w.abs().max()) + 1e-9
        ok = good
        for route, what in (("fm", "bwd"), ("bm", "bwd(bm full-rows)")):
            before = [entry[route].launches, ic.cross_conv1_bwd.launches]
            g_r, g_w = grads(route)
            launched = _launched([entry[route], ic.cross_conv1_bwd], before, device)
            e_r = float((g_r - gr_r).abs().max())
            e_w = float((g_w - gr_w).abs().max())
            good_b = e_r / scale < 2e-2 and e_w / w_scale < 2e-2 and launched
            print(f"interaction {what} err drows={e_r:.2e} (rel {e_r / scale:.2e}) "
                  f"dw={e_w:.2e} -> {'ok' if good_b else 'FAIL'}", flush=True)
            ok &= good_b
    return ok


def check_embed_lookup(device="cuda") -> bool:
    """Both operands of the field-major lookup against its plain version,
    bit for bit, in every table, id and output dtype it takes."""
    from cffm_tpu_torch.ops import embed_lookup as el

    device = torch.device(device)
    rng = np.random.default_rng(11)
    v, w, b, f, fs = 140_000, 256, 4096, 15, 5
    bounds = tuple(range(0, 64 * fs + 1, 64))
    ids = rng.integers(-50, v + 50, size=(b, f))
    ids[:, :fs] = rng.integers(0, 64 * fs, size=(b, fs))  # about 4 in 5 outside their block
    table = torch.from_numpy(rng.normal(size=(v, w)).astype(np.float32)).to(device)
    ids32 = torch.from_numpy(ids.astype(np.int32)).to(device)
    wide = torch.zeros((b, 2 * f), dtype=torch.int32, device=device)
    wide[:, ::2] = ids32
    ok = True
    for tdt in (torch.float32, torch.bfloat16):
        for name, i in (("int32", ids32), ("int64", ids32.long()), ("strided", wide[:, ::2])):
            for odt in (torch.bfloat16, torch.float32):
                before = [el.lookup_fm.launches]
                got = el.lookup_fm(table.to(tdt), i, bounds, odt)
                want = el.lookup_fm_reference(table.to(tdt), i, bounds, odt)
                good = (all(torch.equal(g.view(torch.int16), x.view(torch.int16))
                            for g, x in zip(got, want))
                        and _launched([el.lookup_fm], before, device))
                print(f"embed_lookup {str(tdt)[6:]} table, {name} ids -> {str(odt)[6:]} "
                      f"-> {'ok' if good else 'FAIL'}", flush=True)
                ok &= good
    return ok


def check_conv_tail_grad(device="cuda") -> bool:
    """A train step's forward and backward through the conv tail's kernels
    against the same step on the CPU, whose tail is the eager chain."""
    from cffm_tpu_torch.config import ModelConfig
    from cffm_tpu_torch.models import cffm as model_lib
    from cffm_tpu_torch.ops import interaction_conv as ic
    from cffm_tpu_torch.optim.rowwise import tree_map

    device = torch.device(device)
    f = 15
    cfg = ModelConfig(num_fields=f, vocab_sizes=(32,) * f, embed_dim=16, cross="field_aware",
                      conv_channels=(64, 64), conv_kernel=3, conv_pool=2,
                      compute_dtype="bfloat16", use_first_order=True)
    if not (ic.tail_kernel_takes(cfg) and cfg.fused_linear):
        raise AssertionError("the case needs the fused first-order column and a conv stack "
                             "the tail's kernels take")
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(8)
    rows = torch.from_numpy((rng.normal(size=(300, f, cfg.table_width)) * 0.3)
                            .astype(np.float32))
    fm = model_lib.Route(full_rows=True, field_major=True, prefix=0)
    fn = ic.make_interaction_fn(use_kernel=True)

    def step(dev):
        p = tree_map(lambda t: t.detach().to(dev), params)
        conv = p["conv"] = tree_map(lambda t: t.requires_grad_(), p["conv"])
        r = rows.to(dev).requires_grad_()
        out = model_lib.forward_from_rows(p, fm, [r.transpose(0, 1)], None, cfg,
                                          interaction_fn=fn)
        leaves = [r] + [t for lay in conv for t in lay.values()]
        return [out.detach()] + list(torch.autograd.grad((out ** 2).sum(), leaves))

    with _no_tf32():
        want = step(torch.device("cpu"))
        before = [ic.conv_tail.launches, ic.conv_tail_bwd.launches]
        got = [t.cpu() for t in step(device)]
        launched = _launched([ic.conv_tail, ic.conv_tail_bwd], before, device)
    names = ["logits", "drows"] + [f"d{n}{i}" for i, lay in enumerate(params["conv"])
                                   for n in lay]
    rel = {n: float((a.float() - b.float()).abs().max()) / (float(b.float().abs().max()) + 1e-9)
           for n, a, b in zip(names, got, want)}
    good = all(v < 2e-2 for v in rel.values()) and launched
    print("conv_tail_grad rel err " + " ".join(f"{n}={v:.2e}" for n, v in rel.items())
          + f" -> {'ok' if good else 'FAIL'}", flush=True)
    return good


CHECKS = (check_sorted_segment, check_streamed_apply, check_interaction_kernel,
          check_embed_lookup, check_conv_tail_grad, check_scatter_update)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this sweep only means something on the card; refusing to "
              "pass on the plain versions", flush=True)
        return 2
    from cffm_tpu_torch.bench import card_line

    ok = True
    for check in CHECKS:
        ok &= check("cuda")
    print(f"card: {card_line()}", flush=True)
    print("ONCHIP PARITY: " + ("OK" if ok else "FAIL"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

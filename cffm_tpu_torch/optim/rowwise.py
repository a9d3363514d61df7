"""Per-row sparse optimizers for embedding tables + the dense optimizer chain.

The port's counterpart of `cffm_tpu/optim/rowwise.py`. Optimizer state
is allocated row for row with the table. The train step hands over
the touched rows as (row_ids (N,), grads (N, W)); ids may repeat and are
segment-summed before the state update, so adagrad sees one
accumulation per row per step.

Unlike JAX, the updates here work IN PLACE: `rowwise_update` writes the
table and the state tensors it is given and returns them (the JAX step
donates its state, so no caller sees the difference). Sentinel ids
(< 0) are dropped, and rows that no id touches keep table and state bit
for bit.

Two routes, with the JAX gate (`_should_stream`) choosing between them:
  streamed: per-field sort, the sorted-segment kernel, then the touched-
    row apply kernel (ops/sorted_segment.py, ops/streamed_update.py);
  scatter: torch sort, `index_add_` segment sums and `index_put_` writes.
The sharded step's update (`bucketed_rowwise_update`) takes the gradient
return's per-peer buckets straight into the bucketed apply kernel, with
JAX's gate and fallback.

Small scalars the JAX package keeps on the device stay on the CPU here:
the sparse Adam step "t", the dense Adam "count" and the learning-rate
factor are 0-d CPU tensors, so a step needs no host synchronisation.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from cffm_tpu_torch.config import OptimizerConfig
from cffm_tpu_torch.ops.rounding import round_table_delta

_MASK64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# Trees of tensors (nested dicts and lists), in JAX's leaf order
# ---------------------------------------------------------------------------


def tree_leaves(tree):
    """Leaves in JAX's order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree of tree's structure holding leaves (in tree_leaves order)."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            done = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [rebuild(v) for v in t]
        return next(it)

    return rebuild(tree)


# ---------------------------------------------------------------------------
# Sparse state and routing
# ---------------------------------------------------------------------------


def unique_bound(vocab_sizes, batch_size: int) -> int:
    """Bound on distinct row ids in a (batch, fields) id block: per field
    at most min(vocab, batch) distinct rows; +1 sentinel slot."""
    return int(sum(min(int(v), batch_size) for v in vocab_sizes)) + 1


def rowwise_init(table: torch.Tensor, opt: OptimizerConfig) -> Dict:
    v, dev = table.shape[0], table.device
    if opt.sparse_optimizer == "adagrad":
        # row-wise accumulator, one scalar per row (DLRM-style)
        return {"accum": torch.full((v, 1), opt.adagrad_init, dtype=torch.float32,
                                    device=dev)}
    step = torch.zeros((), dtype=torch.int32)
    if opt.sparse_optimizer == "adam":
        return {"m": torch.zeros(table.shape, dtype=torch.float32, device=dev),
                "v": torch.zeros(table.shape, dtype=torch.float32, device=dev),
                "t": step}
    if opt.sparse_optimizer == "rowwise_adam":
        # full first moment, row-scalar second moment
        return {"m": torch.zeros(table.shape, dtype=torch.float32, device=dev),
                "v": torch.zeros((v, 1), dtype=torch.float32, device=dev),
                "t": step}
    if opt.sparse_optimizer == "sgd":
        return {}
    raise ValueError(opt.sparse_optimizer)


def _dedup_sum(row_ids: torch.Tensor, grads: torch.Tensor,
               max_unique: int | None = None):
    """Sum duplicate-row grads: (ids, f32 sums, valid), m slots each.

    Sort the ids, segment-sum within the batch; each distinct row's total
    lands at its segment's slot, zeros elsewhere. max_unique bounds the
    distinct-id count and sizes the slots."""
    n = row_ids.shape[0]
    m = n if max_unique is None else min(n, int(max_unique))
    sid, order = torch.sort(row_ids, stable=True)
    change = torch.ones(n, dtype=torch.int64, device=row_ids.device)
    change[1:] = (sid[1:] != sid[:-1]).long()
    seg = torch.cumsum(change, 0) - 1
    summed = torch.zeros((m, grads.shape[1]), dtype=torch.float32, device=grads.device)
    summed.index_add_(0, seg, grads.index_select(0, order).float())
    uids = torch.zeros((m,), dtype=row_ids.dtype, device=row_ids.device)
    uids.scatter_(0, seg, sid)   # every entry of a segment carries its id
    valid = torch.arange(m, device=row_ids.device) < seg[-1] + 1
    return uids, summed, valid


def _should_stream(table: torch.Tensor, opt: OptimizerConfig, n_ids: int,
                   max_unique: int | None) -> bool:
    """The JAX gate between the streamed kernels and the scatter path:
    streamed for adagrad/sgd/rowwise_adam on a 128-multiple-wide f32 or
    bf16 table of at least 2^24 elements when the touched rows reach 8%
    of the table ("auto"), always ("on") or never ("off")."""
    from cffm_tpu_torch.ops.streamed_update import pick_tile

    mode = opt.streamed_update
    if mode == "off":
        return False
    if opt.sparse_optimizer not in ("adagrad", "sgd", "rowwise_adam"):
        return False
    v, w = table.shape
    if w % 128 != 0 or table.dtype not in (torch.float32, torch.bfloat16):
        return False
    if pick_tile(v) == 0:
        return False
    if mode == "on":
        return True
    touched = min(n_ids, max_unique) if max_unique else n_ids
    return v * w >= (1 << 24) and touched >= 0.08 * v


def _per_field_sorted(row_ids: torch.Tensor, field_offsets, mask_sentinels: bool,
                      field_major: bool = False):
    """Sorted ids and the global order via F independent column sorts.

    row_ids flattens a (B, F) id block ((F, B) when field_major) whose
    field-f ids lie in the disjoint ascending range [offsets[f],
    offsets[f+1]): sorting each field and concatenating by field IS a
    global sort. Sentinels (id < 0) map to the field's first id; their
    grads are zero. Returns (sid int32, order int64)."""
    offs = torch.as_tensor(list(field_offsets), dtype=row_ids.dtype, device=row_ids.device)
    f = offs.shape[0]
    b = row_ids.shape[0] // f
    keys = row_ids.reshape(f, b) if field_major else row_ids.reshape(b, f).t()
    if mask_sentinels:
        keys = torch.where(keys >= 0, keys, offs[:, None])
    sk, sv = torch.sort(keys, dim=-1, stable=True)
    rows = torch.arange(f, device=row_ids.device)[:, None]
    order = sv + rows * b if field_major else sv * f + rows
    return sk.reshape(-1).to(torch.int32), order.reshape(-1)


def _write_touched_rows(table: torch.Tensor, rows: torch.Tensor, delta: torch.Tensor,
                        opt: OptimizerConfig, sr_key):
    """table[rows] += delta (rows unique, in place). A bf16 table takes the
    f32 sum rounded to nearest or stochastically (ops/rounding.py): an
    in-dtype add would drop any delta below the row's bf16 ulp."""
    if table.dtype != torch.bfloat16:
        table.index_add_(0, rows, delta.to(table.dtype))
        return table
    table[rows] = round_table_delta(table[rows], delta, table.dtype,
                                    opt.table_rounding, sr_key)
    return table


def _mix(*words: int) -> int:
    """splitmix64 over the words: a seed for torch.Generator."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


def fold_in(gen: torch.Generator, data: int) -> torch.Generator:
    """A new CPU generator derived from gen's seed and data (jax's fold_in)."""
    return torch.Generator().manual_seed(_mix(gen.initial_seed(), data))


def sr_keys(table_dtype: str, opt: OptimizerConfig, step, seed: int = 0):
    """(embed_gen, linear_gen), CPU generators for stochastic rounding into
    a bf16 table, deterministic in (seed, step); (None, None) when the
    table dtype or rounding needs none. Their bits are not JAX's."""
    if table_dtype != "bfloat16" or opt.table_rounding != "stochastic":
        return None, None
    base = _mix(seed ^ 0x5EED, int(step))
    return (torch.Generator().manual_seed(_mix(base, 0)),
            torch.Generator().manual_seed(_mix(base, 1)))


def _draw_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2**31 - 1, (), generator=gen))


# ---------------------------------------------------------------------------
# The sparse update
# ---------------------------------------------------------------------------


def rowwise_update(
    table: torch.Tensor,
    state: Dict,
    row_ids: torch.Tensor,
    grads: torch.Tensor,
    opt: OptimizerConfig,
    lr_scale=1.0,
    max_unique: int | None = None,
    field_offsets=None,
    mask_sentinels: bool = True,
    sentinel_grads_zero: bool = False,
    sr_key: torch.Generator | None = None,
    field_major: bool = False,
) -> Tuple[torch.Tensor, Dict]:
    """Apply a sparse per-row update in place: row_ids (N,), grads (N, W).

    Duplicates are pre-summed; sentinel ids < 0 are dropped. max_unique:
    bound on distinct ids (incl. one sentinel slot). field_offsets: the F
    offsets of the per-field id block that row_ids flattens ((B, F), or
    (F, B) when field_major), for the per-field sort of the streamed
    route. mask_sentinels=False: the caller guarantees ids >= 0.
    sentinel_grads_zero: sentinel rows already carry zero grads. sr_key:
    generator for stochastic rounding into a bf16 table.
    Returns (table, state), the same objects, updated."""
    w = table.shape[1]
    if grads.shape[-1] != w:
        raise ValueError(f"grads must be (N, {w}), got {tuple(grads.shape)}")
    num_rows = table.shape[0]
    row_ids = row_ids.reshape(-1)
    grads = grads.reshape(-1, w)
    if mask_sentinels:
        ok = row_ids >= 0
        # sentinels route to the out-of-range row num_rows, never row 0:
        # a zero-grad touch would still decay Adam's moments
        safe_ids = torch.where(ok, row_ids, torch.full_like(row_ids, num_rows))
        if not sentinel_grads_zero:
            grads = torch.where(ok[:, None], grads, torch.zeros((), dtype=grads.dtype,
                                                                device=grads.device))
    else:
        safe_ids = row_ids

    lr = opt.sparse_lr * torch.as_tensor(lr_scale, dtype=torch.float32)
    if _should_stream(table, opt, row_ids.shape[0], max_unique):
        from cffm_tpu_torch.ops.sorted_segment import sorted_segment_sum_compact
        from cffm_tpu_torch.ops.streamed_update import (padded_entries, pick_tile,
                                                        streamed_rowwise_adam_apply,
                                                        streamed_rowwise_apply)

        n = row_ids.shape[0]
        m_pad = padded_entries(min(n, max_unique or n), pick_tile(num_rows))
        if field_offsets is not None and n % len(tuple(field_offsets)) == 0:
            sid, order = _per_field_sorted(row_ids, field_offsets, mask_sentinels,
                                           field_major)
        else:
            sid, order = torch.sort(safe_ids, stable=True)
            sid = sid.to(torch.int32)
        sorted_grads = grads.to(torch.bfloat16).index_select(0, order)
        uids, g, count = sorted_segment_sum_compact(sid, sorted_grads, m_pad)
        del sorted_grads
        g = clip_rows(g, opt)
        slots = torch.arange(m_pad, device=uids.device)
        uids_s = torch.where(slots < count, uids, num_rows).to(torch.int32)
        seed = None
        if table.dtype == torch.bfloat16 and opt.table_rounding == "stochastic":
            if sr_key is None:
                raise ValueError("bf16 streamed update with stochastic rounding "
                                 "needs sr_key")
            seed = _draw_seed(sr_key)
        if opt.sparse_optimizer == "adagrad":
            streamed_rowwise_apply(table, state["accum"], uids_s, g, lr, opt.eps,
                                   sr_seed=seed)
            return table, state
        if opt.sparse_optimizer == "rowwise_adam":
            state["t"] = state["t"] + 1
            streamed_rowwise_adam_apply(table, state["m"], state["v"], uids_s, g, lr,
                                        opt.eps, opt.adam_b1, opt.adam_b2, state["t"],
                                        sr_seed=seed)
            return table, state
        streamed_rowwise_apply(table, None, uids_s, g, lr, opt.eps, sr_seed=seed)
        return table, state

    uids, g, valid = _dedup_sum(safe_ids, grads, max_unique)
    g = clip_rows(g, opt)
    # the scatters' mode="drop": invalid slots and the sentinel row go nowhere
    live = valid & (uids >= 0) & (uids < num_rows)
    rows = uids[live].long()
    g = g[live]

    if opt.sparse_optimizer == "adagrad":
        accum = state["accum"]
        accum.index_add_(0, rows, torch.mean(g * g, dim=-1, keepdim=True))
        delta = -lr * g / (torch.sqrt(accum[rows]) + opt.eps)
        _write_touched_rows(table, rows, delta, opt, sr_key)
        return table, state

    if opt.sparse_optimizer in ("adam", "rowwise_adam"):
        b1, b2 = opt.adam_b1, opt.adam_b2
        state["t"] = state["t"] + 1
        t = state["t"].float()
        m, v = state["m"], state["v"]
        m[rows] = m[rows] * b1 + (1 - b1) * g
        if opt.sparse_optimizer == "adam":
            v[rows] = v[rows] * b2 + (1 - b2) * g * g
        else:
            v[rows] = v[rows] * b2 + (1 - b2) * torch.mean(g * g, dim=-1, keepdim=True)
        mhat = m[rows] / (1 - torch.tensor(b1, dtype=torch.float32) ** t)
        vhat = v[rows] / (1 - torch.tensor(b2, dtype=torch.float32) ** t)
        delta = -lr * mhat / (torch.sqrt(vhat) + opt.eps)
        _write_touched_rows(table, rows, delta, opt, sr_key)
        return table, state

    if opt.sparse_optimizer == "sgd":
        _write_touched_rows(table, rows, -lr * g, opt, sr_key)
        return table, state

    raise ValueError(opt.sparse_optimizer)


def bucketed_rowwise_update(
    table: torch.Tensor,
    state: Dict,
    ids_bkt: torch.Tensor,
    grads_bkt: torch.Tensor,
    opt: OptimizerConfig,
    lr_scale=1.0,
    sr_key: torch.Generator | None = None,
) -> Tuple[torch.Tensor, Dict]:
    """Sparse per-row update in place, straight from the sharded gradient
    return's buckets (parallel/sharded_embedding.grad_return): ids_bkt
    (T, C) local rows, ascending and unique per bucket, the out-of-range
    sentinel (>= table rows) in empty slots; grads_bkt (T, C, W) the
    per-bucket dedup-summed grads, GARBAGE in sentinel slots.

    When the JAX gate passes (`bucketed_tile` and the 8% rule, or
    streamed_update "on") and kernel 7 takes the width
    (`bucketed_kernel_takes`), the buckets feed the bucketed apply kernel
    directly; it sums a row's partials across buckets before the
    optimizer math and applies opt.clip_norm to that total. Otherwise the
    buckets flatten into `rowwise_update`, whose global dedup handles the
    cross-bucket duplicates (sentinel ids sort last and land nowhere).
    Returns (table, state), the same objects, updated."""
    from cffm_tpu_torch.ops.streamed_update import (bucketed_kernel_takes,
                                                    bucketed_rowwise_adam_apply,
                                                    bucketed_rowwise_apply, bucketed_tile)

    v, w = table.shape
    nb, c = ids_bkt.shape[0], ids_bkt.shape[1]
    r = 0
    if (opt.streamed_update != "off"
            and opt.sparse_optimizer in ("adagrad", "sgd", "rowwise_adam")
            and table.dtype in (torch.float32, torch.bfloat16)
            and grads_bkt.shape[-1] == w and bucketed_kernel_takes(w, table.device)):
        r = bucketed_tile(v, w, nb, c)
    touched = min(nb * c, v)
    if r and (opt.streamed_update == "on" or (v * w >= (1 << 24) and touched >= 0.08 * v)):
        lr = opt.sparse_lr * torch.as_tensor(lr_scale, dtype=torch.float32)
        seed = None
        if table.dtype == torch.bfloat16 and opt.table_rounding == "stochastic":
            if sr_key is None:
                raise ValueError("bf16 streamed update with stochastic rounding needs sr_key")
            seed = _draw_seed(sr_key)
        if opt.sparse_optimizer == "adagrad":
            bucketed_rowwise_apply(table, state["accum"], ids_bkt, grads_bkt, lr, opt.eps,
                                   clip=opt.clip_norm, sr_seed=seed)
        elif opt.sparse_optimizer == "rowwise_adam":
            state["t"] = state["t"] + 1
            bucketed_rowwise_adam_apply(table, state["m"], state["v"], ids_bkt, grads_bkt, lr,
                                        opt.eps, opt.adam_b1, opt.adam_b2, state["t"],
                                        clip=opt.clip_norm, sr_seed=seed)
        else:
            bucketed_rowwise_apply(table, None, ids_bkt, grads_bkt, lr, opt.eps,
                                   clip=opt.clip_norm, sr_seed=seed)
        return table, state
    # ids are >= 0 by construction: no sentinel masking pass
    return rowwise_update(table, state, ids_bkt.reshape(-1), grads_bkt.reshape(-1, w), opt,
                          lr_scale=lr_scale, max_unique=v + 1, mask_sentinels=False,
                          sr_key=sr_key)


def dense_rowwise_apply(table: torch.Tensor, state: Dict, g: torch.Tensor,
                        opt: OptimizerConfig, lr_scale=1.0, sr_key=None):
    """Dense-form row-wise update: g is table-shaped (untouched rows are
    zero, an exact no-op for adagrad/sgd). Returns (new_table, new_state),
    new tensors. The math runs in f32 whatever g's dtype."""
    lr = opt.sparse_lr * torch.as_tensor(lr_scale, dtype=torch.float32)
    g = clip_rows(g.float(), opt)
    if opt.sparse_optimizer == "adagrad":
        new_accum = state["accum"] + torch.mean(g * g, dim=-1, keepdim=True)
        delta = -lr * g / (torch.sqrt(new_accum) + opt.eps)
        new_state = {"accum": new_accum}
    elif opt.sparse_optimizer == "sgd":
        delta = -lr * g
        new_state = state
    else:
        raise ValueError(
            f"dense_rowwise_apply supports adagrad/sgd, got {opt.sparse_optimizer}")
    if table.dtype == torch.bfloat16:
        return round_table_delta(table, delta, table.dtype, opt.table_rounding,
                                 sr_key), new_state
    return table + delta.to(table.dtype), new_state


def clip_rows(g: torch.Tensor, opt: OptimizerConfig) -> torch.Tensor:
    """Per-row L2 clip of row grads (N, W) to opt.clip_norm (0 = off),
    with f32 norm math whatever g's dtype."""
    if opt.clip_norm <= 0:
        return g
    n = torch.sqrt(torch.sum(g.float() ** 2, dim=-1, keepdim=True))
    scale = torch.clamp(opt.clip_norm / torch.clamp(n, min=1e-12), max=1.0)
    return g * scale.to(g.dtype)


# ---------------------------------------------------------------------------
# Learning-rate schedule and the dense optimizer
# ---------------------------------------------------------------------------


def schedule_factor(opt: OptimizerConfig, step, total_steps: int) -> torch.Tensor:
    """Multiplicative LR factor at step, a 0-d f32 CPU tensor: linear
    warmup over warmup_steps, then constant / cosine / linear decay to
    end_lr_factor across decay_steps (0 = total_steps). Applied to the
    dense updates and the sparse row updates alike."""
    s = torch.as_tensor(step, dtype=torch.float32).cpu()
    warm = float(opt.warmup_steps)
    f = (torch.clamp((s + 1.0) / warm, max=1.0) if warm > 0
         else torch.tensor(1.0, dtype=torch.float32))
    if opt.lr_schedule == "constant":
        return f
    total = float(opt.decay_steps or total_steps)
    end = float(opt.end_lr_factor)
    prog = torch.clamp((s - warm) / max(total - warm, 1.0), 0.0, 1.0)
    if opt.lr_schedule == "cosine":
        decay = end + (1.0 - end) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    elif opt.lr_schedule == "linear":
        decay = end + (1.0 - end) * (1.0 - prog)
    else:
        raise ValueError(f"unknown lr_schedule {opt.lr_schedule!r}")
    return f * decay


def scale_updates(updates, factor):
    """Scale a tree of updates by the schedule factor."""
    return tree_map(lambda u: u * factor.to(u.dtype), updates)


class DenseOptimizer:
    """optax's chain written out: clip_by_global_norm first (when
    clip_norm > 0), then add_decayed_weights (weight_decay > 0), then
    adam | adagrad | sgd with the learning-rate sign flip. State trees:
    adam {"count": 0-d int32 (CPU), "mu", "nu"}; adagrad {"sum"}; sgd {}.
    optax's adagrad puts eps=1e-7 inside the rsqrt and starts its sum at
    adagrad_init (not torch.optim.Adagrad); its adam puts eps outside the
    square root."""

    ADAGRAD_EPS = 1e-7

    def __init__(self, opt: OptimizerConfig):
        if opt.dense_optimizer not in ("adam", "adagrad", "sgd"):
            raise ValueError(opt.dense_optimizer)
        self.opt = opt

    def init(self, params) -> Dict:
        o = self.opt
        if o.dense_optimizer == "adam":
            return {"count": torch.zeros((), dtype=torch.int32),
                    "mu": tree_map(torch.zeros_like, params),
                    "nu": tree_map(torch.zeros_like, params)}
        if o.dense_optimizer == "adagrad":
            return {"sum": tree_map(lambda p: torch.full_like(p, o.adagrad_init), params)}
        return {}

    def update(self, grads, state: Dict, params):
        """(updates, new_state): the updates to add to params."""
        o = self.opt
        g = grads
        if o.clip_norm > 0:
            norm = torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(g)))
            keep = norm < o.clip_norm
            g = tree_map(lambda t: torch.where(keep, t, (t / norm.to(t.dtype)) * o.clip_norm), g)
        if o.weight_decay > 0:
            g = tree_map(lambda u, p: u + o.weight_decay * p, g, params)
        if o.dense_optimizer == "adam":
            b1, b2 = o.adam_b1, o.adam_b2
            mu = tree_map(lambda u, m: (1 - b1) * u + b1 * m, g, state["mu"])
            nu = tree_map(lambda u, v: (1 - b2) * (u ** 2) + b2 * v, g, state["nu"])
            count = state["count"] + 1
            c = count.float()
            bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** c
            bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** c
            upd = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + o.eps), mu, nu)
            new_state = {"count": count, "mu": mu, "nu": nu}
        elif o.dense_optimizer == "adagrad":
            ssq = tree_map(lambda u, s: u * u + s, g, state["sum"])
            upd = tree_map(lambda s, u: torch.where(
                s > 0, torch.rsqrt(s + self.ADAGRAD_EPS), torch.zeros_like(s)) * u, ssq, g)
            new_state = {"sum": ssq}
        else:
            upd, new_state = g, {}
        return tree_map(lambda u: u * (-o.dense_lr), upd), new_state


def make_dense_optimizer(opt: OptimizerConfig) -> DenseOptimizer:
    return DenseOptimizer(opt)

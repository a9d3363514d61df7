"""Decompose the rowwise sparse update's time on the card.

    python -m cffm_tpu_torch.scripts.profile_sparse <sub>[,<sub>...] [batch]

The port's counterpart of `scripts/profile_sparse.py`, on criteo_kaggle
(39 fields, a 2,600,832 x 640 table) at batch 32768 by default: one
uniform id per field and example, flattened batch-major with the field
offsets, and bf16 gradients of 0.01 times unit normals. Subs:

  sort, sortonly   a stable torch.argsort of the flat ids (jnp.argsort's)
  gather,          the gradients gathered by that order, summed in f32
    gatheronly
  sortgather       argsort, then ids and gradients gathered by it
  sortpf           the per-field sort of `optim.rowwise` (`_per_field_sorted`)
  sortgather_pf    it, then the gradients gathered by its order
  segsum           `index_add_` of the sorted f32 gradients by segment
  segkernel        kernel 3 (`ops.sorted_segment.sorted_segment_sum_compact`)
                   at the slots `optim.rowwise` gives the batch
  scatter          `index_add_` of the gradients into an f32 table at
                   distinct rows (0..n-1 clamped)
  scatter_dup      the same at the flat ids, duplicates and all
  apply            kernel 4 (`ops.streamed_update.streamed_rowwise_apply`,
                   adagrad) from kernel 3's sums, in place
  update           `optim.rowwise.rowwise_update` (the 8% gate takes kernels
                   3-4 here), in place

Each sub prints one line with its ms per call (CUDA events over 10 calls
after a warm one; `utils.timing.time_per_call`), then the card. Exits
nonzero without a CUDA card. The functions take `device` ("cpu" for the
tests, timed by the host clock there).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

SUBS = ("sort", "gather", "segsum", "scatter", "scatter_dup", "sortonly", "sortpf",
        "sortgather_pf", "gatheronly", "sortgather", "segkernel", "apply", "update")


def inputs(cfg, batch: int, device="cuda", seed: int = 0) -> dict:
    """The sub-stages' inputs: flat_ids (B*F,) int32 (batch-major, field
    offsets applied) from numpy's uniform draw, grads (B*F, W) bf16."""
    from cffm_tpu_torch.models.cffm import field_offsets

    mcfg = cfg.model
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, v, size=batch) for v in mcfg.vocab_sizes], axis=1)
    ids = (ids + field_offsets(mcfg)[None, :]).astype(np.int32).reshape(-1)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    grads = (torch.randn((ids.size, mcfg.table_width), generator=gen, device=device)
             * 0.01).to(torch.bfloat16)
    return {"flat_ids": torch.from_numpy(ids).to(device), "grads": grads}


def sorted_stream(flat_ids, grads):
    """(sid int32, seg int64, sorted grads) of one argsort."""
    order = torch.argsort(flat_ids, stable=True)
    sid = flat_ids[order]
    change = torch.ones_like(sid, dtype=torch.int64)
    change[1:] = (sid[1:] != sid[:-1]).long()
    return sid, torch.cumsum(change, 0) - 1, grads[order]


def segsum(sgrad, seg, n: int) -> torch.Tensor:
    """The sorted gradients summed by segment in f32 into n slots."""
    out = torch.zeros((n, sgrad.shape[1]), dtype=torch.float32, device=sgrad.device)
    return out.index_add_(0, seg, sgrad.float())


def slots(cfg, batch: int) -> int:
    """Kernel 3's output slots for one batch, as `optim.rowwise` sizes them."""
    from cffm_tpu_torch.ops.streamed_update import padded_entries, pick_tile
    from cffm_tpu_torch.optim.rowwise import unique_bound

    mcfg = cfg.model
    n = batch * mcfg.num_fields
    return padded_entries(min(n, unique_bound(mcfg.vocab_sizes, batch)),
                          pick_tile(mcfg.total_vocab))


def segkernel(sid, sgrad, m_pad: int):
    """Kernel 3 on the sorted stream: (uids, gsum bf16, count)."""
    from cffm_tpu_torch.ops.sorted_segment import sorted_segment_sum_compact

    return sorted_segment_sum_compact(sid.to(torch.int32), sgrad, m_pad)


def table_of(cfg, device, seed: int = 0) -> torch.Tensor:
    mcfg = cfg.model
    gen = torch.Generator(device=device).manual_seed(seed)
    return 0.01 * torch.randn((mcfg.total_vocab, mcfg.table_width), generator=gen,
                              device=device)


def update(table, state, flat_ids, grads, opt):
    """`optim.rowwise.rowwise_update` as the JAX script calls it (no
    distinct-id bound, no field offsets), in place."""
    from cffm_tpu_torch.optim.rowwise import rowwise_update

    return rowwise_update(table, state, flat_ids, grads, opt)


def make(sub: str, cfg, batch: int, x: dict, device="cuda"):
    """A zero-argument callable that runs one call of sub on x (`inputs`)."""
    from cffm_tpu_torch.optim.rowwise import _per_field_sorted, rowwise_init

    flat_ids, grads = x["flat_ids"], x["grads"]
    n = flat_ids.numel()
    if sub in ("sort", "sortonly"):
        return lambda: torch.argsort(flat_ids, stable=True).sum()
    if sub in ("gather", "gatheronly"):
        order = torch.argsort(flat_ids, stable=True)
        return lambda: grads[order].float().sum()
    if sub == "sortgather":
        def sortgather():
            order = torch.argsort(flat_ids, stable=True)
            return flat_ids[order].sum(), grads[order].float().sum()
        return sortgather
    if sub in ("sortpf", "sortgather_pf"):
        from cffm_tpu_torch.models.cffm import field_offsets

        offs = tuple(int(o) for o in field_offsets(cfg.model))
        if sub == "sortpf":
            return lambda: _per_field_sorted(flat_ids, offs, False)[1].sum()

        def sortgather_pf():
            sid, order = _per_field_sorted(flat_ids, offs, False)
            return sid.sum(), grads[order].float().sum()
        return sortgather_pf
    if sub in ("segsum", "segkernel", "apply"):
        sid, seg, sgrad = sorted_stream(flat_ids, grads)
        if sub == "segsum":
            return lambda: segsum(sgrad, seg, n).sum()
        m_pad = slots(cfg, batch)
        if sub == "segkernel":
            return lambda: segkernel(sid, sgrad, m_pad)
        from cffm_tpu_torch.ops.streamed_update import streamed_rowwise_apply

        v = cfg.model.total_vocab
        uids, gsum, count = segkernel(sid, sgrad, m_pad)
        uids_s = torch.where(torch.arange(m_pad, device=uids.device) < count, uids,
                             v).to(torch.int32)
        table = table_of(cfg, device)
        accum = torch.full((v, 1), 0.01, dtype=torch.float32, device=table.device)
        return lambda: streamed_rowwise_apply(table, accum, uids_s, gsum, 0.01, 1e-8)
    if sub in ("scatter", "scatter_dup"):
        table = table_of(cfg, device)
        if sub == "scatter":
            uids = torch.arange(n, device=flat_ids.device).clamp(max=cfg.model.total_vocab - 1)
        else:
            uids = flat_ids
        g = grads.float()
        return lambda: table.index_add_(0, uids, g)
    if sub == "update":
        table = table_of(cfg, device)
        state = rowwise_init(table, cfg.optim)
        return lambda: update(table, state, flat_ids, grads, cfg.optim)
    raise ValueError(f"unknown sub {sub!r}; have {SUBS}")


def run(sub: str, cfg, batch: int, device="cuda", x: dict | None = None, n: int = 10) -> float:
    """Seconds per call of sub (one warm call first)."""
    from cffm_tpu_torch.utils.timing import time_per_call

    x = inputs(cfg, batch, device) if x is None else x
    return time_per_call(make(sub, cfg, batch, x, device), n=n, device=device)


def main(argv=None) -> int:
    from cffm_tpu_torch.config import get_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("subs", help=f"comma-separated subs of {SUBS}")
    ap.add_argument("batch", nargs="?", type=int, default=32768)
    args = ap.parse_args(argv)
    subs = args.subs.split(",")
    if set(subs) - set(SUBS):
        ap.error(f"unknown subs {sorted(set(subs) - set(SUBS))}; have {SUBS}")
    if not torch.cuda.is_available():
        print("profile_sparse: no CUDA device", file=sys.stderr)
        return 1
    from cffm_tpu_torch.bench import card_line

    cfg = get_config("criteo_kaggle")
    x = inputs(cfg, args.batch, "cuda")
    for sub in subs:
        dt = run(sub, cfg, args.batch, "cuda", x)
        print(f"sub={sub} batch={args.batch} n={x['flat_ids'].numel()} dt={dt * 1e3:.4f}ms",
              flush=True)
        torch.cuda.empty_cache()
    print(f"card: {card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

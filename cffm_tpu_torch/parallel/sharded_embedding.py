"""Row-sharded embedding engine: dedup, all-to-all lookup, gradient return.

The port's counterpart of `cffm_tpu/parallel/sharded_embedding.py` (the
flat exchange). Each process of the group (`parallel/mesh.Mesh`) holds
one shard of the table and runs these functions on its own batch block;
the JAX package runs the same per-shard code inside `shard_map`.

Sharding scheme: MOD-sharding. Global id g lives on shard g % T at local
row g // T, so each field's hot head rows spread over all shards. The
global storage is a permuted view of the logical table (storage row =
owner * rows_per_shard + local row); `to_mod_sharded` and
`from_mod_sharded` convert between the two.

Routing: ONE stable sort by the storage-row key gives the compact stream
of distinct ids in (owner, local row) order. Owner o's slice of that
stream, [start[o], start[o] + count[o]), is its exchange bucket, so the
id and gradient send buffers are T fixed-size slices of it, cut with one
gather each. Empty bucket slots carry the out-of-range sentinel
rows_per_shard, so each bucket stays ascending, as the bucketed apply
kernel needs. A bucket holds at most C (the capacity) ids; ids past it
overflow, are counted, and look up zero rows.

The all-to-alls are `torch.distributed.all_to_all_single` on contiguous
(T, C, ...) buffers: shard s receives, in block p, what peer p sent to
it. The lookup is not differentiated: the train step takes grads with
respect to the returned rows and calls `grad_return` and
`optim.rowwise.bucketed_rowwise_update`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist

from cffm_tpu_torch.ops.sorted_segment import sorted_segment_sum_by_seg

EB = 128  # output block of the segment-sum kernel; sizes its slots


class Routing(NamedTuple):
    """Routing residuals of one lookup, reused by the gradient return and
    by same-batch secondary tables."""

    order: torch.Tensor       # (n,) int64 sort permutation of the flat ids
    seg: torch.Tensor         # (n,) int32 segment (distinct id) of each sorted position
    idx_of_pos: torch.Tensor  # (n,) int64 exchange slot of each ORIGINAL position,
                              #      or -1 (capacity overflow)
    start: torch.Tensor       # (T+1,) int64: distinct id k belongs to owner o
                              #      iff start[o] <= k < start[o+1]
    recv_ids: torch.Tensor    # (T, C) int32 local rows this shard serves, ascending
                              #      per bucket; empty slots hold the sentinel
    recv_valid: torch.Tensor  # (T, C) bool: served slots
    sentinel: int             # the id sentinel (== stride)
    overflow: torch.Tensor    # () int32: distinct ids dropped by capacity


def all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """Block p of the result is what peer p sent in its block for this rank."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=mesh.group)
    return out


def build_routing(ids_flat: torch.Tensor, capacity: int, mesh,
                  rows_per_shard: int | None = None,
                  keys: torch.Tensor | None = None) -> Routing:
    """Dedup, bucket by owner and exchange the ids. Per-shard view.

    ids_flat: (n,) int32 global ids of this shard's batch, n > 0.
    capacity: per-peer bucket size C. rows_per_shard: the shards' local
    row count Vs (without it a conservative 2^31/T key stride is used).
    keys: optional sort keys in place of the mod-sharding formula, equal
    to owner * stride + local with owner in [0, T] and local in [0,
    stride); rows_per_shard is then required (it is the stride). Owner T
    marks sentinel entries: they sort last, fall past the last owner
    boundary and are never bucketed; their exchange slots point past the
    (T, C) buffer, as JAX's do, and every gather fed by them clamps. The
    hierarchical exchange (parallel/hier_embedding.py) routes both of its
    stages through this."""
    n = ids_flat.shape[0]
    t = mesh.world
    dev = ids_flat.device
    if keys is not None and not rows_per_shard:
        raise ValueError("keys= requires rows_per_shard (the key stride)")
    stride = int(rows_per_shard) if rows_per_shard else (1 << 31) // t

    if keys is None:
        ids = ids_flat.long()
        keys = (ids % t) * stride + ids // t
    sk, order = torch.sort(keys.long(), stable=True)
    is_first = torch.ones((n,), dtype=torch.int32, device=dev)
    is_first[1:] = (sk[1:] != sk[:-1]).to(torch.int32)
    seg = torch.cumsum(is_first, 0, dtype=torch.int32) - 1
    owner_pos = sk // stride
    local_pos = (sk % stride).to(torch.int32)

    # owner boundaries in distinct-id space: the first sorted position with
    # owner >= o starts a run, so seg there counts the distinct ids before it
    bpos = torch.searchsorted(owner_pos, torch.arange(t + 1, device=dev))
    start = torch.cat([seg, seg[-1:] + 1]).long()[bpos]              # (T+1,)
    counts = start[1:] - start[:-1]
    overflow = torch.clamp(counts - capacity, min=0).sum().to(torch.int32)

    # sentinels (owner T) count from owner T-1's start, as in JAX
    rank_pos = seg - start[owner_pos.clamp(max=t - 1)]
    slot_of_sorted = torch.where(rank_pos < capacity, owner_pos * capacity + rank_pos,
                                 torch.full_like(rank_pos, -1))
    idx_of_pos = torch.empty_like(slot_of_sorted)
    idx_of_pos[order] = slot_of_sorted                               # invert the sort

    # distinct id k's local row at k (every entry of a segment carries the
    # same row), padded so start[o] + C never runs off the end
    lk = torch.full((n + capacity,), stride, dtype=torch.int32, device=dev)
    lk.scatter_(0, seg.long(), local_pos)
    jcap = torch.arange(capacity, device=dev)
    bucket = lk[start[:t, None] + jcap[None, :]]                     # (T, C)
    send_ids = torch.where(jcap[None, :] < counts[:, None], bucket,
                           torch.full_like(bucket, stride))
    recv_ids = all_to_all(send_ids, mesh)
    return Routing(order=order, seg=seg, idx_of_pos=idx_of_pos, start=start,
                   recv_ids=recv_ids, recv_valid=recv_ids < stride, sentinel=stride,
                   overflow=overflow)


def routed_lookup(table_local: torch.Tensor, routing: Routing, mesh, out_dtype=None,
                  assume_no_overflow: bool = False) -> torch.Tensor:
    """Serve, exchange and gather back: (n, W) rows for the original flat
    positions (zero rows for overflowed ids). assume_no_overflow: the
    capacity covers the distinct-id bound, so no position overflowed and
    the mask is skipped."""
    t, c = routing.recv_ids.shape
    w = table_local.shape[1]
    # sentinel slots clamp to the last row: nothing gathers them back
    served = table_local.index_select(
        0, routing.recv_ids.reshape(-1).clamp(max=table_local.shape[0] - 1))
    served = served.reshape(t, c, w).to(out_dtype or table_local.dtype)
    return exchange_and_gather(served, routing, mesh, assume_no_overflow=assume_no_overflow)


def exchange_and_gather(served: torch.Tensor, routing: Routing, mesh,
                        assume_no_overflow: bool = False) -> torch.Tensor:
    """The second half of routed_lookup: the reverse all-to-all of a
    (T, C, W) served-rows buffer and one gather to the original positions."""
    t, c, w = served.shape
    got = all_to_all(served, mesh).reshape(t * c, w)
    idx = routing.idx_of_pos
    rows = got.index_select(0, idx.clamp(0, t * c - 1))
    if assume_no_overflow:
        return rows
    return torch.where((idx >= 0)[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                              device=rows.device))


def grad_return(drows_flat: torch.Tensor, routing: Routing, mesh,
                max_unique: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dedup-sum the row grads per distinct id and send them to the owners.

    Returns (row_ids (T, C), grads (T, C, W)) in the OWNER's local row
    space: row_ids is `routing.recv_ids`; grads are the per-bucket sums.
    Sentinel slots carry GARBAGE grads (a neighbouring owner's rows):
    consumers drop them by id range. A row requested by several peers
    comes once per bucket with that bucket's partial sum.

    bf16 grads with a 128-multiple width take kernel 6
    (ops/sorted_segment.sorted_segment_sum_by_seg); other dtypes take an
    f32 `index_add_` (JAX's segment_sum there). max_unique bounds this
    shard's distinct-id count and shrinks the sum buffer."""
    n, w = drows_flat.shape
    t, c = routing.recv_ids.shape
    dsorted = drows_flat.index_select(0, routing.order)
    m = min(n, int(max_unique)) if max_unique else n
    if drows_flat.dtype == torch.bfloat16 and w % 128 == 0:
        m_pad = -(-m // EB) * EB + -(-c // EB) * EB  # + C so the slices never run off
        gsum = sorted_segment_sum_by_seg(routing.seg, dsorted, m_pad)
    else:
        keep = routing.seg < m + c
        gsum = torch.zeros((m + c, w), dtype=torch.float32, device=drows_flat.device)
        gsum.index_add_(0, routing.seg[keep].long(), dsorted[keep].float())
        gsum = gsum.to(drows_flat.dtype)
    jcap = torch.arange(c, device=gsum.device)
    send = gsum[routing.start[:t, None] + jcap[None, :]]            # (T, C, W)
    return routing.recv_ids, all_to_all(send, mesh)


# ---------------------------------------------------------------------------
# Capacity sizing
# ---------------------------------------------------------------------------


def pick_capacity(n_ids: int, num_shards: int, factor: float = 2.0,
                  rows_per_shard: int | None = None, max_unique: int | None = None,
                  cap_rows: int = 0) -> int:
    """Per-peer bucket capacity: the even split times a slack factor (or
    the absolute cap_rows), capped by the ids (n_ids), the peer's rows
    (rows_per_shard) and the distinct-id bound (max_unique), rounded up to
    128. With one shard the whole distinct bound is covered: there is no
    exchange to shrink, and an undersized buffer would drop ids."""
    base = -(-n_ids // num_shards)
    if num_shards == 1:
        cap = n_ids
    elif cap_rows > 0:
        cap = int(cap_rows)
    else:
        cap = int(base * factor)
    cap = min(cap, n_ids)
    if max_unique is not None:
        cap = min(cap, int(max_unique))
    if rows_per_shard is not None:
        cap = min(cap, rows_per_shard)
    return max(128, -(-cap // 128) * 128)


# ---------------------------------------------------------------------------
# Layout conversion (natural <-> mod-sharded storage)
# ---------------------------------------------------------------------------


def _storage_rows(v_pad: int, t: int, device) -> torch.Tensor:
    """Storage row of each natural row g < v_pad: (g % t) * Vs + g // t."""
    g = torch.arange(v_pad, device=device)
    return (g % t) * (v_pad // t) + g // t


def to_mod_sharded(table: torch.Tensor, t: int) -> torch.Tensor:
    """(V, W) natural -> (V_pad, W) permuted storage for t shards."""
    v, w = table.shape
    v_pad = -(-v // t) * t
    full = torch.cat([table, torch.zeros((v_pad - v, w), dtype=table.dtype,
                                         device=table.device)])
    out = torch.zeros_like(full)
    out[_storage_rows(v_pad, t, table.device)] = full
    return out


def from_mod_sharded(storage: torch.Tensor, t: int, v: int) -> torch.Tensor:
    """(V_pad, W) permuted storage -> (V, W) natural."""
    return storage[_storage_rows(storage.shape[0], t, storage.device)][:v]

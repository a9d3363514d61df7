"""Hierarchical (host-level dedup) embedding exchange.

The port's counterpart of `cffm_tpu/parallel/hier_embedding.py`. On a
group of H hosts of C cards each (`parallel/mesh.make_mesh_2d`) the flat
all-to-all sends every card's distinct ids straight to the owner card,
so a row wanted by all C cards of a host crosses the host boundary C
times. The hierarchical exchange sends each HOST-distinct row across
once:

  stage 1 (the "chip" sub-group, inside a host): each card sorts its ids
      by (owner chip index, owner host, local row) and all-to-alls the
      per-chip-index buckets within the host. Gateway card c of host h
      then holds every id the host wants from any host's card c.
  stage 2 (the "host" sub-group, between cards of one chip index): the
      gateway dedups that union over the host's cards and all-to-alls the
      host-distinct ids to the owner hosts. The owner card serves rows
      from its shard; they return host hop first, then chip hop.

Gradients take the two stages in reverse with a dedup-sum at each hop:
per-card partial sums inside the host (kernel 6), then the gateway's
host-level pre-sums of those partials (kernel 6 again), one bucket per
owner host.

Both stages are `sharded_embedding.build_routing` with its `keys=`:
stage 1's key is c_o * (H * Vs) + (h_o * Vs + local), so each bucket
arrives at the gateway ascending in stage 2's storage key, and stage 2
runs on the received values (the sentinel H * Vs sorts past the last
owner host and is never bucketed).

The table layout is the flat one: global id g lives on flat shard g % T,
T = H * C, which is host shard // C, chip shard % C, at local row g // T.
So flat and hierarchical steps share states and checkpoints; only the
exchange differs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from cffm_tpu_torch.parallel import sharded_embedding as se


class HierRouting(NamedTuple):
    """Routing residuals of the two-stage exchange (per-card view)."""

    r1: se.Routing  # stage 1, over the chip sub-group
    r2: se.Routing  # stage 2, over the host sub-group (on the gateway)


def build_routing_hier(ids_flat: torch.Tensor, cap1: int, cap2: int, mesh2d,
                       rows_per_shard: int) -> HierRouting:
    """Two-stage dedup, bucketing and id exchange.

    ids_flat: (n,) int32 global ids of this card's batch block. cap1: the
    per (card, gateway) bucket size; cap2: the per (gateway, owner host)
    bucket size. rows_per_shard: Vs = v_pad // (H * C)."""
    h, c = mesh2d.num_hosts, mesh2d.chips_per_host
    vs = int(rows_per_shard)
    tt = h * c
    ids = ids_flat.long()
    s_owner = ids % tt
    v = (s_owner // c) * vs + ids // tt                 # in [0, H * Vs)
    keys1 = (s_owner % c) * (h * vs) + v
    r1 = se.build_routing(v, cap1, mesh2d.chip, rows_per_shard=h * vs, keys=keys1)
    # the gateway's received values ARE stage 2's storage keys
    vals2 = r1.recv_ids.reshape(-1)
    r2 = se.build_routing(vals2, cap2, mesh2d.host, rows_per_shard=vs, keys=vals2)
    return HierRouting(r1=r1, r2=r2)


def hier_routed_lookup(table_local: torch.Tensor, hr: HierRouting, mesh2d, out_dtype=None,
                       assume_no_overflow: Tuple[bool, bool] = (False, False)
                       ) -> torch.Tensor:
    """Serve and exchange over both hops: (n, W) rows for this card's
    original positions (zero rows for overflowed ids unless the stage's
    assume_no_overflow flag is set)."""
    c, cap1 = hr.r1.recv_ids.shape
    w = table_local.shape[1]
    # host hop: the owner card serves its shard; the gateway gets a row
    # for every stage-2 input position (garbage at the empty stage-1 slots,
    # which no stage-1 position gathers)
    rows2 = se.routed_lookup(table_local, hr.r2, mesh2d.host, out_dtype=out_dtype,
                             assume_no_overflow=assume_no_overflow[1])
    # chip hop: those rows in stage 1's bucket layout are its served buffer
    return se.exchange_and_gather(rows2.reshape(c, cap1, w), hr.r1, mesh2d.chip,
                                  assume_no_overflow=assume_no_overflow[0])


def hier_grad_return(drows_flat: torch.Tensor, hr: HierRouting, mesh2d,
                     max_unique1: int | None = None, max_unique2: int | None = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dedup-sum per card and send to the gateways, then pre-sum per host
    and send to the owner hosts: each host-distinct row's gradient
    crosses hosts once.

    Returns (row_ids (H, cap2), grads (H, cap2, W)) in the owner's local
    row space, `grad_return`'s contract: ascending and unique per bucket,
    the sentinel in empty slots, GARBAGE grads there (finite: stage 1's
    empty slots carry finite sums, which land in the sentinel segment)."""
    _, g1 = se.grad_return(drows_flat, hr.r1, mesh2d.chip, max_unique=max_unique1)
    c, cap1, w = g1.shape
    return se.grad_return(g1.reshape(c * cap1, w), hr.r2, mesh2d.host,
                          max_unique=max_unique2)


def pick_capacities_hier(n_local: int, num_hosts: int, chips_per_host: int, factor: float,
                         rows_per_shard: int, batch_unique: int, host_unique: int,
                         cap_rows: int = 0, cap_rows_host: int = 0) -> Tuple[int, int]:
    """(cap1, cap2): n_local ids per card; batch_unique the distinct-id
    bound of one card's block, host_unique that of the host's; cap_rows
    and cap_rows_host the measured absolute overrides of each stage
    (`sharded_embedding.pick_capacity`)."""
    cap1 = se.pick_capacity(n_local, chips_per_host, factor,
                            max_unique=min(batch_unique, n_local), cap_rows=cap_rows)
    cap2 = se.pick_capacity(chips_per_host * cap1, num_hosts, factor,
                            rows_per_shard=rows_per_shard, max_unique=host_unique,
                            cap_rows=cap_rows_host)
    return cap1, cap2


def hier_overflow(hr: HierRouting) -> torch.Tensor:
    """Distinct ids dropped by either stage on this card (sum over the group)."""
    return hr.r1.overflow + hr.r2.overflow

"""Intra-host table sharding: tables sharded over a host's cards and
replicated across hosts (`table_axis="intra_host"`).

The port's counterpart of `cffm_tpu/parallel/dcn_mesh.py`. On the
(host, chip) grid of `parallel/mesh.make_mesh_2d` the table rows are
mod-sharded over the C cards of a host only (global id g on chip g % C
at local row g // C) and every host holds a replica. The lookup's
all-to-alls stay inside the host (the chip sub-group). The replicas see
every host's gradients through one dense all-reduce of a shard-sized f32
gradient over the host sub-group per step, and every card applies the
same dense-form row update (`optim.rowwise.dense_rowwise_apply`, an exact
no-op on untouched rows), so the replicas stay equal. Only adagrad and
sgd have that dense form.

The step is the flat step (`sharded_train.router_step`) with the
`IntraHostRouter`: the exchange over the chip sub-group, the apply
replaced, no hybrid small-field route (as in JAX's 2D step), and the
stochastic-rounding key folded with the chip index only, so that the
hosts' replicas draw the same dither.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cffm_tpu_torch.config import TrainConfig
from cffm_tpu_torch.optim.rowwise import dense_rowwise_apply, unique_bound
from cffm_tpu_torch.parallel import sharded_embedding as se
from cffm_tpu_torch.parallel.mesh import Mesh2D
from cffm_tpu_torch.parallel.sharded_train import (FlatRouter, create_sharded_state,
                                                   router_eval_step, router_step)
from cffm_tpu_torch.train import TrainState, has_dense_form


def create_sharded_state_2d(cfg: TrainConfig, generator: torch.Generator,
                            mesh2d: Mesh2D) -> TrainState:
    """This rank's state: the table shard of its chip index (vocab padded
    to a multiple of C), its rows drawn from a generator derived from the
    chip index, so that every host's replica is equal; the dense params
    and their optimizer state replicated (`create_sharded_state` on the
    chip sub-mesh)."""
    return create_sharded_state(cfg, generator, mesh2d.chip)


SPARE_ROWS = 1 << 12  # rows past the shard that take the sentinel slots' garbage


def _dense_table_grad(row_ids: torch.Tensor, row_grads: torch.Tensor, vs: int
                      ) -> torch.Tensor:
    """The (Vs + SPARE_ROWS, W) f32 dense gradient of the grad return's
    buckets (T, C) / (T, C, W); rows [0, Vs) are the shard's. Each
    bucket's ids are unique and ascending, so one index_add_ per bucket,
    in peer order, writes each row at most once a bucket and sums a row's
    buckets in a fixed order (the same bits on every run). Sentinel slots
    (ids >= vs, garbage grads) land in the spare rows past the shard,
    spread by slot: sent to one row, the 1.6M empty slots of a one-card
    bucket serialised on its atomics (16.3 ms of a 77 ms step)."""
    t, c = row_ids.shape
    w = row_grads.shape[-1]
    out = torch.zeros((vs + SPARE_ROWS, w), dtype=torch.float32, device=row_grads.device)
    spare = vs + torch.arange(c, device=row_ids.device) % SPARE_ROWS
    for ids, g in zip(row_ids.long(), row_grads):
        out.index_add_(0, torch.where(ids < vs, ids, spare), g.float())
    return out


class IntraHostRouter(FlatRouter):
    """The flat exchange over the host's cards (the chip sub-group), and
    the dense apply: the per-bucket grads as a dense shard gradient,
    all-reduced over the host sub-group, then `dense_rowwise_apply` over
    the whole shard."""

    hybrid = False

    def __init__(self, mesh2d: Mesh2D, capacity: int, rows_per_shard: int, vocab_sizes):
        super().__init__(mesh2d.flat, capacity, rows_per_shard, vocab_sizes,
                         exchange=mesh2d.chip)
        self.host = mesh2d.host

    def apply(self, table, state, row_ids, grads, opt, lr_scale, sr_key) -> None:
        vs = table.shape[0]
        g = _dense_table_grad(row_ids, grads, vs)[:vs]
        dist.all_reduce(g, group=self.host.group)
        new_table, new_state = dense_rowwise_apply(table, state, g, opt,
                                                   lr_scale=lr_scale, sr_key=sr_key)
        del g
        table.copy_(new_table)
        for k, v in new_state.items():
            if v is not state[k]:
                state[k].copy_(v)


def _make_2d_router(cfg: TrainConfig, mesh2d: Mesh2D) -> IntraHostRouter:
    h, c = mesh2d.num_hosts, mesh2d.chips_per_host
    b_loc = cfg.data.batch_size // (h * c)
    v_pad = -(-cfg.model.total_vocab // c) * c
    capacity = se.pick_capacity(b_loc * cfg.model.num_fields, c,
                                cfg.sharding.id_capacity_factor, rows_per_shard=v_pad // c,
                                max_unique=unique_bound(cfg.model.vocab_sizes, b_loc))
    return IntraHostRouter(mesh2d, capacity, v_pad // c, cfg.model.vocab_sizes)


def make_sharded_train_step_2d(cfg: TrainConfig, mesh2d: Mesh2D, interaction_fn=None):
    """The intra-host engine's train step (`sharded_train.router_step`
    with the `IntraHostRouter`). Raises for rowwise_adam and adam, which
    have no dense form."""
    if not has_dense_form(cfg.optim):
        raise ValueError(
            f"intra-host table sharding uses the dense-form row update (adagrad, sgd), not "
            f"{cfg.optim.sparse_optimizer!r}; sparse adam is only available on the global "
            "or hier table axis")
    return router_step(cfg, _make_2d_router(cfg, mesh2d), interaction_fn)


def make_sharded_eval_step_2d(cfg: TrainConfig, mesh2d: Mesh2D, interaction_fn=None):
    """The intra-host engine's eval step (`sharded_train.router_eval_step`)."""
    return router_eval_step(cfg, _make_2d_router(cfg, mesh2d), interaction_fn)

"""Row-sharded train and eval steps: sharded tables, data-parallel dense.

The port's counterpart of `cffm_tpu/parallel/sharded_train.py` (the flat
exchange). Each process of the group runs the step body on its own
batch block; JAX runs the same body under `shard_map` over the "data"
axis. Per step: the routed dedup lookup (two all-to-alls), the forward
and backward on the local block with grads taken with respect to the
looked-up rows, ONE all-reduce of the loss, the overflow count, the dense
grads and (hybrid route) the small-prefix gradient, the dense optimizer,
the reverse all-to-all of the row grads, and the per-row update on the
shard's own rows (`optim.rowwise.bucketed_rowwise_update`).

Dense params and their optimizer state are replicated: every rank
applies the same all-reduced gradient, so they stay identical without a
broadcast. Tables and per-row optimizer state are the rank's mod-sharded
rows (`parallel/sharded_embedding.py`). As in the single-device step,
the step updates the state's tensors IN PLACE and returns a TrainState
that shares them.

The hybrid small-field route (adagrad and sgd, as in JAX): the small
prefix of the table is all-gathered from the shards each step, looked
up, and its summed gradient applied to each shard's own prefix rows.
With every field small nothing is routed at all (the JAX package cannot
build that case; the port takes the single-device all-small branch).

With `cfg.debug_barriers` the step prints a line before and after each
collective region (`utils/debugging.collective_probe`, JAX's eight tags).

The exchange is the router's: `FlatRouter` (one all-to-all over the
group) or `HierRouter` (the two-stage host-level dedup of
`parallel/hier_embedding.py` over a (host, chip) grid, the same table
layout and state). The intra-host engine's router (`parallel/dcn_mesh.py`)
also replaces the per-row apply. `wrap_wire_step` gives any of their
steps the packed wire batch (`data/wire.py`).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from cffm_tpu_torch import metrics
from cffm_tpu_torch.config import TrainConfig
from cffm_tpu_torch.models import cffm as model_lib
from cffm_tpu_torch.optim.rowwise import (bucketed_rowwise_update, dense_rowwise_apply,
                                          fold_in, make_dense_optimizer, rowwise_init,
                                          scale_updates, schedule_factor, sr_keys,
                                          tree_leaves, tree_unflatten, unique_bound)
from cffm_tpu_torch.parallel import hier_embedding as he
from cffm_tpu_torch.parallel import sharded_embedding as se
from cffm_tpu_torch.parallel.mesh import Mesh, Mesh2D
from cffm_tpu_torch.train import (TrainState, _prefix_grad, merge_dense_params,
                                  split_dense_params)
from cffm_tpu_torch.utils.debugging import collective_probe


# A shard whose f32 draw passes INIT_DRAW_BYTES is drawn INIT_ROWS rows a
# randn call: one draw holds two f32 copies beside the table, more than an
# 80 GB card has past 24 GiB (multihost's 26M x 640 rows on 1 or 2 shards).
# Smaller shards keep the one draw, and with it their random stream.
INIT_DRAW_BYTES = 24 << 30
INIT_ROWS = 1 << 18


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class FlatRouter:
    """Exchange strategy: one all-to-all over the flat group.

    The capacity is fixed at construction (it sizes the exchange
    buffers); the distinct-id bound and the overflow-mask elision follow
    the batch each build() sees, so a batch larger than configured is
    masked and counted instead of gathering garbage.

    mesh is the whole group (the loss and dense-grad all-reduce, the
    hybrid prefix gather); exchange the group the table is sharded over
    (the whole group unless given; `dcn_mesh` passes the host's cards).
    hybrid: whether the small-field prefix route may be taken."""

    hybrid = True

    def __init__(self, mesh: Mesh, capacity: int, rows_per_shard: int, vocab_sizes,
                 exchange: Mesh | None = None):
        self.mesh = mesh
        self.exchange = exchange or mesh
        self.num_shards = self.exchange.world
        self.capacity = capacity
        self.rows_per_shard = rows_per_shard
        self.vocab_sizes = vocab_sizes
        self.batch_unique = None     # set by build()
        self.no_ovf = False

    def build(self, flat_ids: torch.Tensor, vocab_sizes=None) -> se.Routing:
        # vocab_sizes: the fields the ids cover (the hybrid routes the big ones)
        vocabs = self.vocab_sizes if vocab_sizes is None else vocab_sizes
        n = flat_ids.shape[0]
        self.batch_unique = unique_bound(vocabs, n // len(vocabs))
        # the capacity covers the bound: no overflow, no masks
        self.no_ovf = self.capacity >= min(n, self.batch_unique)
        return se.build_routing(flat_ids, self.capacity, self.exchange,
                                rows_per_shard=self.rows_per_shard)

    def lookup(self, table_local, routing, out_dtype):
        return se.routed_lookup(table_local, routing, self.exchange, out_dtype=out_dtype,
                                assume_no_overflow=self.no_ovf)

    def grad(self, drows_flat, routing):
        return se.grad_return(drows_flat, routing, self.exchange, max_unique=self.batch_unique)

    def overflow(self, routing) -> torch.Tensor:
        return routing.overflow

    def shard_index(self) -> int:
        """This rank's table shard (the stochastic-rounding fold, the prefix rows)."""
        return self.exchange.rank

    def apply(self, table, state, row_ids, grads, opt, lr_scale, sr_key) -> None:
        """The per-row update of this shard from grad()'s buckets, in place;
        cross-peer duplicates are summed inside the apply (kernel 7)."""
        bucketed_rowwise_update(table, state, row_ids, grads, opt, lr_scale=lr_scale,
                                sr_key=sr_key)


class HierRouter(FlatRouter):
    """Exchange strategy: the two-stage host-level dedup exchange over the
    (host, chip) grid (`parallel/hier_embedding.py`). The table layout,
    state and apply are the flat router's: shard h * C + c is rank h * C +
    c. `mesh` is the whole group; mesh2d.chip and mesh2d.host carry the
    two stages. Capacities are fixed; the bounds and the mask elision
    follow each batch, as in FlatRouter."""

    def __init__(self, mesh2d: Mesh2D, cap1: int, cap2: int, rows_per_shard: int,
                 vocab_sizes):
        super().__init__(mesh2d.flat, cap1, rows_per_shard, vocab_sizes)
        self.mesh2d = mesh2d
        self.cap1, self.cap2 = cap1, cap2
        self.host_unique = None
        self.no_ovf = (False, False)
        self.stage_overflow = None  # build()'s (stage 1, stage 2) drops on this rank

    def build(self, flat_ids: torch.Tensor, vocab_sizes=None) -> he.HierRouting:
        vocabs = self.vocab_sizes if vocab_sizes is None else vocab_sizes
        n = flat_ids.shape[0]
        b_loc, c = n // len(vocabs), self.mesh2d.chips_per_host
        self.batch_unique = unique_bound(vocabs, b_loc)
        self.host_unique = unique_bound(vocabs, b_loc * c)
        self.no_ovf = (self.cap1 >= min(n, self.batch_unique),
                       self.cap2 >= min(c * self.cap1, self.host_unique))
        hr = he.build_routing_hier(flat_ids, self.cap1, self.cap2, self.mesh2d,
                                   self.rows_per_shard)
        self.stage_overflow = torch.stack([hr.r1.overflow, hr.r2.overflow])
        return hr

    def lookup(self, table_local, routing, out_dtype):
        return he.hier_routed_lookup(table_local, routing, self.mesh2d, out_dtype=out_dtype,
                                     assume_no_overflow=self.no_ovf)

    def grad(self, drows_flat, routing):
        return he.hier_grad_return(drows_flat, routing, self.mesh2d,
                                   max_unique1=self.batch_unique, max_unique2=self.host_unique)

    def overflow(self, routing) -> torch.Tensor:
        return he.hier_overflow(routing)


def _make_flat_router(cfg: TrainConfig, mesh: Mesh) -> FlatRouter:
    t = mesh.world
    b_loc = cfg.data.batch_size // t
    v_pad = _round_up(cfg.model.total_vocab, t)
    capacity = se.pick_capacity(b_loc * cfg.model.num_fields, t,
                                cfg.sharding.id_capacity_factor, rows_per_shard=v_pad // t,
                                max_unique=unique_bound(cfg.model.vocab_sizes, b_loc),
                                cap_rows=cfg.sharding.cap_rows)
    return FlatRouter(mesh, capacity, v_pad // t, cfg.model.vocab_sizes)


def _make_hier_router(cfg: TrainConfig, mesh2d: Mesh2D) -> HierRouter:
    h, c = mesh2d.num_hosts, mesh2d.chips_per_host
    t = h * c
    b_loc = cfg.data.batch_size // t
    v_pad = _round_up(cfg.model.total_vocab, t)
    vocabs = cfg.model.vocab_sizes
    cap1, cap2 = he.pick_capacities_hier(
        b_loc * cfg.model.num_fields, h, c, cfg.sharding.id_capacity_factor, v_pad // t,
        unique_bound(vocabs, b_loc), unique_bound(vocabs, b_loc * c),
        cap_rows=cfg.sharding.cap_rows, cap_rows_host=cfg.sharding.cap_rows_host)
    return HierRouter(mesh2d, cap1, cap2, v_pad // t, vocabs)


def create_sharded_state(cfg: TrainConfig, generator: torch.Generator, mesh: Mesh
                         ) -> TrainState:
    """This rank's state: its (Vs, W) table shard and per-row optimizer
    state (vocab padded to a multiple of the group size, mod-sharded), and
    the dense params and their optimizer state, drawn from generator (seed
    it the same on every rank so that they agree). The shard's rows come
    from a generator of its own, derived from generator's seed and the
    rank; init is i.i.d., so the layout does not change the distribution.
    The hierarchical engine takes this state on its grid's flat mesh (shard
    h * C + c is rank h * C + c), so flat and hier states interchange; the
    intra-host engine takes it on the chip sub-mesh (`dcn_mesh`)."""
    mcfg = cfg.model
    t = mesh.world
    vs = _round_up(mcfg.total_vocab, t) // t
    params = model_lib.init_params(mcfg, generator, skip_tables=True)
    dev = generator.device
    rows = torch.Generator(device=dev).manual_seed(
        fold_in(generator, 1 + mesh.rank).initial_seed())
    tdt = model_lib.torch_dtype(mcfg.table_dtype)

    def shard(width):
        if vs * width * 4 <= INIT_DRAW_BYTES:
            return (0.01 * torch.randn((vs, width), generator=rows, device=dev)).to(tdt)
        out = torch.empty((vs, width), dtype=tdt, device=dev)
        for r in range(0, vs, INIT_ROWS):
            n = min(INIT_ROWS, vs - r)
            out[r:r + n] = 0.01 * torch.randn((n, width), generator=rows, device=dev)
        return out

    params["embed"]["table"] = shard(mcfg.table_width)
    sparse = {"embed": rowwise_init(params["embed"]["table"], cfg.optim)}
    if mcfg.use_first_order and not mcfg.fused_linear:
        params["linear"]["table"] = shard(1)
        sparse["linear"] = rowwise_init(params["linear"]["table"], cfg.optim)
    dense_opt_state = make_dense_optimizer(cfg.optim).init(split_dense_params(params))
    return TrainState(0, params, dense_opt_state, sparse)


def _gather_prefix(table_local: torch.Tensor, mesh: Mesh, ls: int, srows: int):
    """The natural-order small-field block (srows, W) from every shard's
    first ls rows: shard s's local row l holds global id l*T + s."""
    parts = [torch.empty_like(table_local[:ls]) for _ in range(mesh.world)]
    dist.all_gather(parts, table_local[:ls].contiguous(), group=mesh.group)
    g = torch.arange(srows, device=table_local.device)
    return torch.cat(parts)[(g % mesh.world) * ls + g // mesh.world]


def _all_reduce_flat(tensors, mesh: Mesh):
    """SUM-all-reduce a list of tensors as one f32 buffer; new tensors back."""
    flat = torch.cat([x.reshape(-1).float() for x in tensors])
    dist.all_reduce(flat, group=mesh.group)
    out, i = [], 0
    for x in tensors:
        out.append(flat[i:i + x.numel()].reshape(x.shape).to(x.dtype))
        i += x.numel()
    return out


def routed_ids(ids, params, cfg: TrainConfig, router: FlatRouter, interaction_fn):
    """(fm, fs, flat ids, their fields' vocab sizes or None) of the train
    step's exchange for this rank's block ids (B/T, F): fm, the field-major
    full-rows route (ids transposed before the routing, so the rows come
    back (F, B, W) as the fm kernel entries read them); fs, the hybrid
    small-field prefix, taken off the exchange (its dense-form update exists
    for adagrad/sgd only)."""
    mcfg = cfg.model
    fm = model_lib.wants_field_major(params, mcfg, interaction_fn)
    fs = (mcfg.small_field_prefix
          if router.hybrid and fm and cfg.optim.sparse_optimizer in ("adagrad", "sgd") else 0)
    if fs:
        return fm, fs, ids.t()[fs:].reshape(-1), mcfg.vocab_sizes[fs:]
    return fm, fs, (ids.t() if fm else ids).reshape(-1), None


def _local_step(state: TrainState, ids, dense, labels, *, cfg: TrainConfig,
                router: FlatRouter, interaction_fn):
    """The per-rank step body on this rank's batch block ids (B/T, F); the
    router decides the exchange and the per-row apply."""
    params = state.params
    mcfg, opt = cfg.model, cfg.optim
    mesh = router.mesh
    b_loc, f = ids.shape
    w = mcfg.table_width
    cdt = model_lib.torch_dtype(mcfg.compute_dtype)
    t_all, shard = router.num_shards, router.shard_index()
    table_local = params["embed"]["table"]
    fm, fs, flat_ids, route_vocabs = routed_ids(ids, params, cfg, router, interaction_fn)
    routed = fs < f
    separate_linear = not fm and mcfg.use_first_order and not mcfg.fused_linear
    dense_p = split_dense_params(params)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(dense_p)]
    full = merge_dense_params(params, tree_unflatten(dense_p, leaves))

    def dbg(tag):
        collective_probe(tag, mesh.rank, cfg.debug_barriers)

    with torch.no_grad():
        ids_fm = ids.t()
        if fs:
            srows = mcfg.small_rows
            ls = -(-srows // t_all)  # the padded local slice of the prefix
            table_small = _gather_prefix(table_local, mesh, ls, srows)
            row_leaves = [model_lib.onehot_lookup_fm(table_small, ids_fm[:fs], mcfg,
                                                     out_dtype=cdt)]
        else:
            row_leaves = []
        routing = None
        if routed:
            dbg("routing-a2a:enter")
            routing = router.build(flat_ids, route_vocabs)
            dbg("lookup-a2a:enter")
            row_leaves.append(router.lookup(table_local, routing, cdt))
            dbg("lookup-a2a:exit")
            if separate_linear:
                row_leaves.append(router.lookup(params["linear"]["table"], routing,
                                                torch.float32))

    with torch.enable_grad():
        for x in row_leaves:
            x.requires_grad_()
        if fs:
            emb_big = row_leaves[1].reshape(f - fs, b_loc, w) if routed else None
            logits = model_lib.forward_from_rows_fm2(full, row_leaves[0], emb_big, dense, mcfg,
                                                     interaction_fn=interaction_fn)
        elif fm:
            logits = model_lib.forward_from_rows_fm(full, row_leaves[0].reshape(f, b_loc, w),
                                                    dense, mcfg, interaction_fn=interaction_fn)
        else:
            lin_rows = row_leaves[1].reshape(b_loc, f, 1) if separate_linear else None
            logits = model_lib.forward_from_rows(full, row_leaves[0].reshape(b_loc, f, w),
                                                 lin_rows, dense, mcfg,
                                                 interaction_fn=interaction_fn)
        # the global mean logloss: local sum over the global batch
        loss = metrics.sigmoid_bce_with_logits(logits, labels).sum() / (b_loc * mesh.world)
        grads = torch.autograd.grad(loss, leaves + row_leaves)
    dgrads, row_grads = list(grads[: len(leaves)]), list(grads[len(leaves):])

    with torch.no_grad():
        overflow = (router.overflow(routing) if routed
                    else torch.zeros((), dtype=torch.int32, device=ids.device))
        summed = [loss.detach(), overflow.float()] + dgrads
        if fs:
            # every rank sees the global small-block gradient
            summed.append(_prefix_grad(row_grads[0], ids_fm[:fs], mcfg))
        # one all-reduce carries the loss and the dense grads
        dbg("loss-psum:enter")
        dbg("grads-psum:enter")
        summed = _all_reduce_flat(summed, mesh)
        dbg("grads-psum:exit")
        loss, overflow = summed[0], summed[1].round().to(torch.int32)
        dgrads = summed[2:2 + len(dgrads)]

        lrf = schedule_factor(opt, state.step, cfg.data.num_train_steps)
        updates, new_dense_opt = make_dense_optimizer(opt).update(
            tree_unflatten(dense_p, dgrads), state.dense_opt_state, dense_p)
        for p, u in zip(tree_leaves(dense_p), tree_leaves(scale_updates(updates, lrf))):
            p.add_(u)

        sparse = state.sparse_opt_state
        sk_emb, sk_lin = sr_keys(mcfg.table_dtype, opt, state.step, cfg.data.seed)
        if sk_emb is not None:
            # decorrelate the shards' stochastic-rounding dither
            sk_emb, sk_lin = fold_in(sk_emb, shard), fold_in(sk_lin, shard)
        if routed:
            # the reverse all-to-all, then the per-row update on this shard's rows
            dbg("grad-return-a2a:enter")
            row_ids, bucket_grads = router.grad(row_grads[1 if fs else 0].reshape(-1, w),
                                                routing)
            dbg("grad-return-a2a:exit")
            router.apply(table_local, sparse["embed"], row_ids, bucket_grads, opt, lrf, sk_emb)
        if fs:
            # this shard's own prefix rows: local row l holds global id l*T +
            # rank; rows past srows get a zero gradient, an exact no-op
            dtab_small = summed[-1]
            lidx = torch.arange(ls, device=ids.device) * t_all + shard
            g_small = torch.where((lidx < srows)[:, None],
                                  dtab_small[lidx.clamp(max=srows - 1)],
                                  torch.zeros((), device=ids.device))
            state_rows = {k: v for k, v in sparse["embed"].items()
                          if v.dim() >= 1 and v.shape[0] == table_local.shape[0]}
            new_small, new_small_state = dense_rowwise_apply(
                table_local[:ls], {k: v[:ls] for k, v in state_rows.items()}, g_small, opt,
                lr_scale=lrf, sr_key=None if sk_emb is None else fold_in(sk_emb, 1))
            table_local[:ls] = new_small
            for k, v in new_small_state.items():
                if k in state_rows:
                    state_rows[k][:ls] = v
        if separate_linear:
            lrow_ids, lrow_grads = router.grad(row_grads[1].reshape(-1, 1).float(), routing)
            router.apply(params["linear"]["table"], sparse["linear"], lrow_ids, lrow_grads, opt,
                         lrf, sk_lin)

    new_state = TrainState(state.step + 1, params, new_dense_opt, sparse)
    return new_state, {"loss": loss, "overflow": overflow}


def router_step(cfg: TrainConfig, router: FlatRouter, interaction_fn=None):
    """step(state, ids, dense, labels) -> (new_state, {"loss", "overflow"})
    on this rank's batch block ids (B/T, F) int32 global, dense
    (B/T, num_dense) | None, labels (B/T,), exchanging through router.
    The loss is the global mean and the overflow the group's total; both
    are the same on every rank. step.router is router, whose reports
    (`HierRouter.stage_overflow`) a caller may read after a step."""
    def step(state: TrainState, ids, dense, labels):
        return _local_step(state, ids, dense, labels, cfg=cfg, router=router,
                           interaction_fn=interaction_fn)

    step.router = router
    return step


def make_sharded_train_step(cfg: TrainConfig, mesh: Mesh, interaction_fn=None):
    """The flat engine's step (`router_step`) over the group of mesh."""
    return router_step(cfg, _make_flat_router(cfg, mesh), interaction_fn)


def make_sharded_train_step_hier(cfg: TrainConfig, mesh2d: Mesh2D, interaction_fn=None):
    """The hierarchical engine's step over the (host, chip) grid: the flat
    step's state and math, each host-distinct row crossing hosts once a
    way (`HierRouter`)."""
    return router_step(cfg, _make_hier_router(cfg, mesh2d), interaction_fn)


def wrap_wire_step(step, wire_spec, mcfg):
    """The (state, wire) form of a raw sharded step(state, ids, dense,
    labels): unpack this rank's packed wire block (data/wire.py) and apply
    the field offsets on its device, then run the step. The unpack is
    elementwise along the batch, so the rank's block stays its own."""
    from cffm_tpu_torch.data import wire as wire_lib
    from cffm_tpu_torch.train import wire_offsets

    def wire_step(state: TrainState, wire: Dict):
        ids_local, dense, labels = wire_lib.unpack(wire, wire_spec)
        return step(state, ids_local + wire_offsets(mcfg, ids_local.device), dense, labels)

    return wire_step


def router_eval_step(cfg: TrainConfig, router: FlatRouter, interaction_fn=None):
    """step(state, auc_state, ids, dense, labels, mask=None) -> (auc_state,
    overflow) on this rank's batch block: the group's AUC histograms are
    summed into auc_state on every rank, and overflow is the group's count
    of distinct ids that the capacity dropped (they score as zero rows).
    The JAX eval steps drop that count; the port returns it."""
    mcfg = cfg.model

    @torch.inference_mode()
    def step(state: TrainState, auc_state: Dict, ids, dense, labels, mask=None):
        params = state.params
        b_loc, f = ids.shape
        routing = router.build(ids.reshape(-1))
        emb_rows = router.lookup(params["embed"]["table"], routing,
                                 model_lib.torch_dtype(mcfg.compute_dtype))
        lin_rows = None
        if mcfg.use_first_order and not mcfg.fused_linear:
            lin_rows = router.lookup(params["linear"]["table"], routing,
                                     torch.float32).reshape(b_loc, f, 1)
        logits = model_lib.forward_from_rows(
            params, emb_rows.reshape(b_loc, f, mcfg.table_width), lin_rows, dense, mcfg,
            interaction_fn=interaction_fn)
        logits = logits + metrics.calibration_offset(cfg.data)
        zeros = {k: torch.zeros_like(v) for k, v in auc_state.items()}
        upd = metrics.auc_state_update(zeros, logits, labels, mask=mask)
        keys = sorted(upd)
        *summed, overflow = _all_reduce_flat([upd[k] for k in keys]
                                             + [router.overflow(routing).float()], router.mesh)
        new = {k: auc_state[k] + u for k, u in zip(keys, summed)}
        return new, overflow.round().to(torch.int32)

    return step


def make_sharded_eval_step(cfg: TrainConfig, mesh: Mesh, interaction_fn=None):
    """The flat engine's eval step (`router_eval_step`)."""
    return router_eval_step(cfg, _make_flat_router(cfg, mesh), interaction_fn)


def make_sharded_eval_step_hier(cfg: TrainConfig, mesh2d: Mesh2D, interaction_fn=None):
    """The hierarchical engine's eval step (`router_eval_step`)."""
    return router_eval_step(cfg, _make_hier_router(cfg, mesh2d), interaction_fn)

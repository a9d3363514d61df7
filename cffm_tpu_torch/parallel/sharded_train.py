"""Row-sharded train and eval steps: sharded tables, data-parallel dense.

The port's counterpart of `cffm_tpu/parallel/sharded_train.py` (the flat
exchange). Each process of the group runs the step body on its own
batch block; JAX runs the same body under `shard_map` over the "data"
axis. Per step: the routed dedup lookup (two all-to-alls), the forward
and backward on the local block with grads taken with respect to the
looked-up rows, ONE all-reduce of the loss, the overflow count, the dense
grads and (hybrid route) the small-prefix gradient, the dense optimizer,
the reverse all-to-all of the row grads, and the per-row update on the
shard's own rows (`optim.rowwise.bucketed_rowwise_update`). The step
body is those phases in turn (`step_lookup`, `step_loss`,
`step_all_reduce`, `step_sparse_update`), on the route of `step_route`;
`scripts/profile_sharded_step` times them as cumulative fragments.

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
from cffm_tpu_torch.optim.rowwise import (bucketed_rowwise_update, fold_in,
                                          make_dense_optimizer, rowwise_init, sr_keys,
                                          tree_unflatten, unique_bound)
from cffm_tpu_torch.parallel import hier_embedding as he
from cffm_tpu_torch.parallel import sharded_embedding as se
from cffm_tpu_torch.parallel.mesh import Mesh, Mesh2D
from cffm_tpu_torch.train import (TrainState, dense_leaves, dense_update, has_dense_form,
                                  prefix_grad, prefix_update, split_dense_params)
from cffm_tpu_torch.utils.debugging import collective_probe


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
        # as a one-card table is drawn: multihost's 26M x 640 rows on 1 or 2
        # shards in chunks (`models/cffm.draw_table`)
        return model_lib.draw_table(vs, width, tdt, rows)

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


def step_route(params, cfg: TrainConfig, router: FlatRouter, interaction_fn
               ) -> model_lib.Route:
    """The train step's route (`models.cffm.route`): the hybrid small-field
    prefix only where the router takes it and the optimizer has its
    dense-form update."""
    return model_lib.route(params, cfg.model, interaction_fn,
                           router.hybrid and has_dense_form(cfg.optim))


def exchange_ids(ids, route: model_lib.Route, cfg: TrainConfig):
    """(flat ids, their fields' vocab sizes or None) that the step routes
    for this rank's block ids (B/T, F) on route: transposed on the
    field-major route, so that the rows come back (F, B, W); the prefix's
    fields are not routed."""
    if route.prefix:
        return ids.t()[route.prefix:].reshape(-1), cfg.model.vocab_sizes[route.prefix:]
    return (ids.t() if route.field_major else ids).reshape(-1), None


def _rows_in_layout(route: model_lib.Route, row_leaves, b_loc: int, mcfg):
    """The step's row leaves (the prefix lookup's, then the routed lookups'
    flat rows) as `models.cffm.forward_from_rows` takes them on route."""
    f, w = mcfg.num_fields, mcfg.table_width
    if route.prefix:
        return row_leaves[:1] + [x.reshape(f - route.prefix, b_loc, w) for x in row_leaves[1:]]
    if route.field_major:
        return [row_leaves[0].reshape(f, b_loc, w)]
    return [row_leaves[0].reshape(b_loc, f, w)] + [x.reshape(b_loc, f, 1)
                                                   for x in row_leaves[1:]]


def _probe(tag: str, router: FlatRouter, cfg: TrainConfig) -> None:
    collective_probe(tag, router.mesh.rank, cfg.debug_barriers)


def _prefix_slice(mcfg, router: FlatRouter) -> int:
    """The padded local slice of the small-field prefix: its rows on each shard."""
    return -(-mcfg.small_rows // router.num_shards)


def step_lookup(params, ids, route: model_lib.Route, router: FlatRouter, cfg: TrainConfig):
    """The step's lookup for this rank's block ids (B/T, F), without a
    gradient: (row leaves, routing or None). The leaves are the prefix's
    rows (the prefix all-gathered from the shards, then looked up), then
    the routed rows of the other fields, then, on the batch-major route,
    the rows of a separate first-order table."""
    mcfg = cfg.model
    cdt = model_lib.torch_dtype(mcfg.compute_dtype)
    table_local = params["embed"]["table"]
    fs = route.prefix
    row_leaves = []
    if fs:
        table_small = _gather_prefix(table_local, router.mesh, _prefix_slice(mcfg, router),
                                     mcfg.small_rows)
        row_leaves.append(model_lib.onehot_lookup_fm(table_small, ids.t()[:fs], mcfg,
                                                     out_dtype=cdt))
    if fs == mcfg.num_fields:
        return row_leaves, None
    _probe("routing-a2a:enter", router, cfg)
    routing = router.build(*exchange_ids(ids, route, cfg))
    _probe("lookup-a2a:enter", router, cfg)
    row_leaves.append(router.lookup(table_local, routing, cdt))
    _probe("lookup-a2a:exit", router, cfg)
    if not route.field_major and mcfg.use_first_order and not mcfg.fused_linear:
        row_leaves.append(router.lookup(params["linear"]["table"], routing, torch.float32))
    return row_leaves, routing


def step_loss(full, route: model_lib.Route, row_leaves, dense, labels, router: FlatRouter,
              cfg: TrainConfig, interaction_fn):
    """The global mean logloss (this block's sum over the global batch) of
    the forward from the row leaves, which take gradients from here on."""
    b_loc = labels.shape[0]
    for x in row_leaves:
        x.requires_grad_()
    logits = model_lib.forward_from_rows(full, route,
                                         _rows_in_layout(route, row_leaves, b_loc, cfg.model),
                                         dense, cfg.model, interaction_fn=interaction_fn)
    return metrics.sigmoid_bce_with_logits(logits, labels).sum() / (b_loc * router.mesh.world)


def step_all_reduce(loss, dgrads, row_grads, routing, ids, route: model_lib.Route,
                    router: FlatRouter, cfg: TrainConfig):
    """ONE all-reduce over the group of the loss, the overflow count, the
    dense grads and, on the hybrid route, the prefix's gradient, which
    every rank then sees whole. Returns (loss, overflow int32, dense
    grads, prefix gradient or None)."""
    fs = route.prefix
    overflow = (router.overflow(routing) if routing is not None
                else torch.zeros((), dtype=torch.int32, device=ids.device))
    summed = [loss.detach(), overflow.float()] + list(dgrads)
    if fs:
        summed.append(prefix_grad(row_grads[0], ids.t()[:fs], cfg.model))
    _probe("loss-psum:enter", router, cfg)
    _probe("grads-psum:enter", router, cfg)
    summed = _all_reduce_flat(summed, router.mesh)
    _probe("grads-psum:exit", router, cfg)
    return (summed[0], summed[1].round().to(torch.int32), summed[2:2 + len(dgrads)],
            summed[-1] if fs else None)


def step_sparse_update(state: TrainState, row_grads, routing, g_prefix, lrf,
                       route: model_lib.Route, router: FlatRouter, cfg: TrainConfig) -> None:
    """The per-row updates of this shard's rows, in place: the reverse
    all-to-all of the routed rows' grads and the router's apply; the
    prefix's dense-form update of this shard's slice of it; the separate
    first-order table's."""
    mcfg, opt = cfg.model, cfg.optim
    params, sparse = state.params, state.sparse_opt_state
    table_local = params["embed"]["table"]
    t_all, shard = router.num_shards, router.shard_index()
    sk_emb, sk_lin = sr_keys(mcfg.table_dtype, opt, state.step, cfg.data.seed)
    if sk_emb is not None:
        # decorrelate the shards' stochastic-rounding dither
        sk_emb, sk_lin = fold_in(sk_emb, shard), fold_in(sk_lin, shard)
    fs = route.prefix
    if routing is not None:
        _probe("grad-return-a2a:enter", router, cfg)
        row_ids, bucket_grads = router.grad(
            row_grads[1 if fs else 0].reshape(-1, mcfg.table_width), routing)
        _probe("grad-return-a2a:exit", router, cfg)
        router.apply(table_local, sparse["embed"], row_ids, bucket_grads, opt, lrf, sk_emb)
    if fs:
        ls = _prefix_slice(mcfg, router)
        prefix_update(table_local, sparse["embed"], ls,
                      _local_prefix_grad(g_prefix, ls, t_all, shard, mcfg.small_rows), opt, lrf,
                      sk_emb)
    if mcfg.use_first_order and not mcfg.fused_linear:
        lrow_ids, lrow_grads = router.grad(row_grads[1].reshape(-1, 1).float(), routing)
        router.apply(params["linear"]["table"], sparse["linear"], lrow_ids, lrow_grads, opt,
                     lrf, sk_lin)


def _local_prefix_grad(g_prefix, ls: int, t_all: int, shard: int, srows: int):
    """This shard's slice (ls, W) of the prefix gradient (srows, W): local
    row l holds global id l*T + shard; rows past srows get a zero
    gradient, an exact no-op."""
    lidx = torch.arange(ls, device=g_prefix.device) * t_all + shard
    return torch.where((lidx < srows)[:, None], g_prefix[lidx.clamp(max=srows - 1)],
                       torch.zeros((), device=g_prefix.device))


def _local_step(state: TrainState, ids, dense, labels, *, cfg: TrainConfig,
                router: FlatRouter, interaction_fn):
    """The per-rank step body on this rank's batch block ids (B/T, F); the
    router decides the exchange and the per-row apply."""
    route = step_route(state.params, cfg, router, interaction_fn)
    dense_p, leaves, full = dense_leaves(state.params)
    with torch.no_grad():
        row_leaves, routing = step_lookup(state.params, ids, route, router, cfg)
    with torch.enable_grad():
        loss = step_loss(full, route, row_leaves, dense, labels, router, cfg, interaction_fn)
        grads = torch.autograd.grad(loss, leaves + row_leaves)
    row_grads = grads[len(leaves):]
    with torch.no_grad():
        loss, overflow, dgrads, g_prefix = step_all_reduce(
            loss, grads[:len(leaves)], row_grads, routing, ids, route, router, cfg)
        new_dense_opt, lrf = dense_update(state, dense_p, tree_unflatten(dense_p, dgrads), cfg)
        step_sparse_update(state, row_grads, routing, g_prefix, lrf, route, router, cfg)
    new_state = TrainState(state.step + 1, state.params, new_dense_opt, state.sparse_opt_state)
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
        # batch-major, whatever route the train step takes
        route = model_lib.route(params, mcfg, interaction_fn).batch_major()
        routing = router.build(ids.reshape(-1))
        row_leaves = [router.lookup(params["embed"]["table"], routing,
                                    model_lib.torch_dtype(mcfg.compute_dtype))]
        if mcfg.use_first_order and not mcfg.fused_linear:
            row_leaves.append(router.lookup(params["linear"]["table"], routing,
                                            torch.float32))
        logits = model_lib.forward_from_rows(
            params, route, _rows_in_layout(route, row_leaves, ids.shape[0], mcfg), dense, mcfg,
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

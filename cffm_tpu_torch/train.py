"""Training and eval loops: train state, train step, evaluation, run.

The port's counterpart of `cffm_tpu/train.py` (single-device path). The
embedding table is never differentiated as a whole: the step takes
gradients with respect to the LOOKED-UP ROWS, a leaf tensor per lookup,
and applies the per-row sparse optimizer to the touched rows
(`optim/rowwise.py`), so no table-sized gradient exists. The small-field
table prefix of the hybrid route takes its gradient through the prefix
lookup, summed per row in f32 and rounded to the compute dtype as the
JAX one-hot matmul leaves it. Dense params (conv, tower, linear bias)
take the optax chain of `make_dense_optimizer`.

`train_step` updates the state's tensors IN PLACE (the JAX step donates
its state) and returns a new TrainState that shares them.
`train_step_wire` takes a packed wire batch (`data/wire.py`), unpacks it
and applies the field offsets on the device, then runs `train_step`. The
row-sharded step lives in `parallel/sharded_train.py`; `run` takes it for
a sharded config launched on more than one process.

Usage: python -m cffm_tpu_torch.train --config=<name> [--device=cuda]
       [section.field=value ...] [--checkpoint_dir=<dir> --checkpoint_every=N]
       [--profile_dir=<dir>]
       python -m cffm_tpu_torch.train --config=criteo_kaggle data.path=<tsv>
       data.eval_batches=0   (one full pass over the held-out split)
       torchrun --nproc_per_node=N -m cffm_tpu_torch.train --config=avazu --distributed
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import sys
import time
from typing import Dict, Iterable, NamedTuple, Optional

import numpy as np
import torch

from cffm_tpu_torch import metrics, resolve_device
from cffm_tpu_torch.config import TrainConfig
from cffm_tpu_torch.models import cffm as model_lib
from cffm_tpu_torch.optim import rowwise
from cffm_tpu_torch.optim.rowwise import (dense_rowwise_apply, fold_in,
                                          make_dense_optimizer, rowwise_init,
                                          rowwise_update, schedule_factor, sr_keys,
                                          tree_leaves, tree_unflatten, unique_bound)
from cffm_tpu_torch.utils import profiling


class TrainState(NamedTuple):
    step: int
    params: Dict            # full model params (tables included)
    dense_opt_state: Dict   # the dense chain's state over split_dense_params
    sparse_opt_state: Dict  # {"embed": ..., ["linear": ...]}


def split_dense_params(params: Dict) -> Dict:
    """The sub-tree the dense chain optimizes (everything but the tables)."""
    dense = {"conv": params["conv"], "tower": params["tower"]}
    if "linear" in params:
        dense["linear_bias"] = params["linear"]["bias"]
    return dense


def merge_dense_params(params: Dict, dense: Dict) -> Dict:
    out = dict(params)
    out["conv"] = dense["conv"]
    out["tower"] = dense["tower"]
    if "linear_bias" in dense:
        out["linear"] = dict(params["linear"], bias=dense["linear_bias"])
    return out


def dense_leaves(params: Dict):
    """(dense_p, leaves, full): the dense sub-tree, its tensors as fresh
    leaves that take gradients, and params with those leaves in place."""
    dense_p = split_dense_params(params)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(dense_p)]
    return dense_p, leaves, merge_dense_params(params, tree_unflatten(dense_p, leaves))


def create_state(cfg: TrainConfig, generator: torch.Generator) -> TrainState:
    """Fresh params (drawn from generator, on its device) and optimizer state."""
    params = model_lib.init_params(cfg.model, generator)
    dense_opt_state = make_dense_optimizer(cfg.optim).init(split_dense_params(params))
    sparse = {"embed": rowwise_init(params["embed"]["table"], cfg.optim)}
    if cfg.model.use_first_order and not cfg.model.fused_linear:
        sparse["linear"] = rowwise_init(params["linear"]["table"], cfg.optim)
    return TrainState(0, params, dense_opt_state, sparse)


def has_dense_form(opt) -> bool:
    """Whether the sparse optimizer has the dense-form row update that the
    small-field prefix takes (adagrad, sgd)."""
    return opt.sparse_optimizer in ("adagrad", "sgd")


def prefix_grad(g_small: torch.Tensor, ids_fm_small: torch.Tensor, cfg) -> torch.Tensor:
    """Gradient of the small-field prefix (small_rows, W) f32 from the
    prefix lookup's output gradient (Fs, B, W), as JAX takes it: per field
    the transposed one-hot product onehot^T @ g in the compute dtype (f32
    sums, rounded to the compute dtype); ids outside their field's block
    add nothing. Every field's one-hot is one comparison and their
    products one batched product (Fs, V, B) @ (Fs, B, W), V the widest
    small field's vocabulary; a narrower field's rows past its own are cut
    off after it."""
    onehot = (prefix_rows(cfg, ids_fm_small.device, ids_fm_small.dtype)[:, :, None]
              == ids_fm_small[:, None, :]).to(g_small.dtype)
    out = torch.bmm(onehot, g_small).reshape(-1, g_small.shape[-1])
    keep = prefix_kept(cfg, out.device)
    return (out if keep is None else out.index_select(0, keep)).float()


@functools.lru_cache(maxsize=16)
def prefix_rows(cfg, device, dtype) -> torch.Tensor:
    """(Fs, V): the global row of each small field's local id r < V, V the
    widest small field's vocabulary (a narrower field's entries past its
    own rows are cut off after its product), made once per (config,
    device, dtype). Read-only."""
    fs = cfg.small_field_prefix
    sizes = [int(v) for v in cfg.vocab_sizes[:fs]]
    offs = np.cumsum([0] + sizes[:-1])
    return torch.from_numpy(offs[:, None] + np.arange(max(sizes))[None, :]).to(device, dtype)


@functools.lru_cache(maxsize=16)
def prefix_kept(cfg, device):
    """The rows of the batched product (Fs * V, W) that are prefix rows, in
    order (field f's first vocab_f of its V), or None when every small
    field has V rows. Read-only."""
    sizes = [int(v) for v in cfg.vocab_sizes[:cfg.small_field_prefix]]
    v = max(sizes)
    if all(n == v for n in sizes):
        return None
    return torch.from_numpy(np.concatenate([f * v + np.arange(n)
                                            for f, n in enumerate(sizes)])).to(device)


def dense_update(state: TrainState, dense_p: Dict, dgrads: Dict, cfg: TrainConfig):
    """The dense chain's update of dense_p (`split_dense_params`) from
    dgrads, scaled by the LR schedule at state.step, added in place.
    Returns (the new dense optimizer state, the schedule factor), which the
    sparse update scales by too."""
    lrf = schedule_factor(cfg.optim, state.step, cfg.data.num_train_steps)
    updates, new_dense_opt = make_dense_optimizer(cfg.optim).update(
        dgrads, state.dense_opt_state, dense_p)
    torch._foreach_add_(tree_leaves(dense_p),
                        torch._foreach_mul(tree_leaves(updates), float(lrf)))
    return new_dense_opt, lrf


def prefix_update(table: torch.Tensor, state: Dict, rows: int, g: torch.Tensor, opt,
                  lr_scale, sr_key) -> None:
    """The dense-form update of the table's first rows rows and their
    per-row state (the small-field prefix, or a shard's slice of it), in
    place, from their gradient g (rows, W) f32. No big-field id touches
    those rows. sr_key is the table's stochastic-rounding key, folded with
    1 here so that the prefix draws its own dither. Where kernel 4's apply
    takes the table (`rowwise.apply_kernel_takes`) the rows go through
    `streamed_update.scatter_rowwise_apply` as the rows [0, rows) with f32
    sums g: one launch on a card, and on the CPU the eager update, whose
    bits are `dense_rowwise_apply`'s (a row of zero gradient keeps its
    value and state). Under a profiler a bf16 table's rounded write (the
    update, its dither and rounding, the write back) is the span
    cffm.table_round."""
    key = None if sr_key is None else fold_in(sr_key, 1)
    if rowwise.apply_kernel_takes(table, opt):
        from cffm_tpu_torch.ops.streamed_update import scatter_rowwise_apply

        lr = opt.sparse_lr * torch.as_tensor(lr_scale, dtype=torch.float32)
        scatter_rowwise_apply(table, state, _first_rows(rows, table.device),
                              rowwise.clip_rows(g.float(), opt), opt, lr, key)
        return
    state_rows = {k: v for k, v in state.items()
                  if v.dim() >= 1 and v.shape[0] == table.shape[0]}
    rounded = table.dtype == torch.bfloat16
    with profiling.span("cffm.table_round") if rounded else contextlib.nullcontext():
        new_rows, new_state = dense_rowwise_apply(
            table[:rows], {k: v[:rows] for k, v in state_rows.items()}, g, opt,
            lr_scale=lr_scale, sr_key=key)
        table[:rows] = new_rows
    for k, v in new_state.items():
        if k in state_rows:
            state_rows[k][:rows] = v


@functools.lru_cache(maxsize=16)
def _first_rows(rows: int, device) -> torch.Tensor:
    """arange(rows) as int32 on device, made once. Read-only."""
    return torch.arange(rows, dtype=torch.int32, device=device)


def _plan_ahead(table: torch.Tensor, ids: torch.Tensor, route, cfg: TrainConfig):
    """The table update's `rowwise.scatter_plan`, made before the forward
    where that update takes the scatter route: its sort depends on the ids
    alone, and the live rows' count it sends to the host is there by the
    time the update needs it, so the step does not wait for the card. The
    ids are those the sparse update in `train_step` takes: the big fields'
    (field-major) after a prefix, else all. None on the streamed route or
    without big fields."""
    mcfg = cfg.model
    fs, batch = route.prefix, ids.shape[0]
    bound = unique_bound(mcfg.vocab_sizes[fs:], batch)
    n = batch * (mcfg.num_fields - fs)
    if not n or rowwise._should_stream(table, cfg.optim, n, bound):
        return None
    flat = ids.t()[fs:] if fs else (ids.t() if route.field_major else ids)
    return rowwise.scatter_plan(flat.reshape(-1), table.shape[0], bound)


def train_step(state: TrainState, ids: torch.Tensor, dense: Optional[torch.Tensor],
               labels: torch.Tensor, cfg: TrainConfig, interaction_fn=None):
    """One step on a batch: ids (B, F) int32 global, dense (B, num_dense)
    | None, labels (B,). Returns (new_state, {"loss", "logit_mean"}).

    The rows take `models.cffm.route`. Under a torch profiler it records
    the span cffm.step and, inside it, cffm.lookup (on the field-major
    route one launch of `ops/embed_lookup`'s kernel on the card, which
    writes the rows in the compute dtype), cffm.forward (interaction, conv
    tail, tower, loss; the conv tail in cffm.conv_tail, eager since the
    step takes its gradient), cffm.backward, cffm.dense_update and
    cffm.sparse_update (`utils/profiling.py`)."""
    with profiling.span("cffm.step"):
        params = state.params
        mcfg = cfg.model
        route = model_lib.route(params, mcfg, interaction_fn, has_dense_form(cfg.optim))
        fs = route.prefix
        dense_p, leaves, full = dense_leaves(params)
        table = params["embed"]["table"]
        plan = _plan_ahead(table, ids, route, cfg)
        with torch.enable_grad():
            with profiling.span("cffm.lookup"):
                with torch.no_grad():
                    rows = list(model_lib.lookup(params, route, ids, mcfg))
                if not route.field_major:
                    # rows cast to the compute dtype here, so their grads come back narrow
                    rows[0] = rows[0].to(model_lib.torch_dtype(mcfg.compute_dtype))
                for r in rows:
                    r.requires_grad_()
            with profiling.span("cffm.forward"):
                logits = model_lib.forward_from_rows(full, route, rows, dense, mcfg,
                                                     interaction_fn=interaction_fn)
                loss = metrics.logloss(logits, labels)
            with profiling.span("cffm.backward"):
                grads = torch.autograd.grad(loss, leaves + rows)
        dgrads = tree_unflatten(dense_p, grads[: len(leaves)])
        row_grads = list(grads[len(leaves):])

        with torch.no_grad():
            with profiling.span("cffm.dense_update"):
                new_dense_opt, lrf = dense_update(state, dense_p, dgrads, cfg)

            # sparse per-row updates on the touched rows
            with profiling.span("cffm.sparse_update"):
                opt = cfg.optim
                sparse = state.sparse_opt_state
                offs = tuple(int(o) for o in model_lib.field_offsets(mcfg))
                batch = ids.shape[0]
                sk_emb, sk_lin = sr_keys(mcfg.table_dtype, opt, state.step, cfg.data.seed)
                ids_fm = ids.t()
                if fs:
                    dtab_small = prefix_grad(row_grads[0], ids_fm[:fs], mcfg)
                    if fs < mcfg.num_fields:
                        # big fields only through the sort/dedup/update pipeline
                        rowwise_update(table, sparse["embed"], ids_fm[fs:].reshape(-1),
                                       row_grads[1].reshape(-1, mcfg.table_width), opt,
                                       max_unique=unique_bound(mcfg.vocab_sizes[fs:], batch),
                                       field_offsets=offs[fs:], mask_sentinels=False,
                                       lr_scale=lrf, sr_key=sk_emb, field_major=True,
                                       plan=plan)
                    prefix_update(table, sparse["embed"], mcfg.small_rows, dtab_small, opt,
                                  lrf, sk_emb)
                else:
                    flat_ids = (ids_fm if route.field_major else ids).reshape(-1)
                    max_u = unique_bound(mcfg.vocab_sizes, batch)
                    rowwise_update(table, sparse["embed"], flat_ids,
                                   row_grads[0].reshape(-1, mcfg.table_width), opt,
                                   max_unique=max_u, field_offsets=offs, mask_sentinels=False,
                                   lr_scale=lrf, sr_key=sk_emb, field_major=route.field_major,
                                   plan=plan)
                    if len(rows) > 1:
                        # the first-order weights' table of their own
                        rowwise_update(params["linear"]["table"], sparse["linear"], flat_ids,
                                       row_grads[1].reshape(-1, 1), opt, max_unique=max_u,
                                       field_offsets=offs, mask_sentinels=False,
                                       lr_scale=lrf, sr_key=sk_lin)

        new_state = TrainState(state.step + 1, params, new_dense_opt, sparse)
        return new_state, {"loss": loss.detach(), "logit_mean": logits.detach().mean()}


@functools.lru_cache(maxsize=16)
def wire_offsets(mcfg, device) -> torch.Tensor:
    """The field offsets as a (1, F) int32 tensor on device, made once per
    (config, device) so that a step copies nothing from the host for them.
    Read-only: callers add it, never write into it."""
    return torch.from_numpy(model_lib.field_offsets(mcfg).astype(np.int32)[None, :]).to(device)


def train_step_wire(state: TrainState, wire: Dict, spec, cfg: TrainConfig,
                    interaction_fn=None):
    """train_step on a packed wire batch (data/wire.py): unpack the narrow
    columns and apply the field offsets on the wire's device, then run the
    normal step. Returns (new_state, {"loss", "logit_mean"})."""
    from cffm_tpu_torch.data import wire as wire_lib

    ids_local, dense, labels = wire_lib.unpack(wire, spec)
    offs = wire_offsets(cfg.model, ids_local.device)
    return train_step(state, ids_local + offs, dense, labels, cfg, interaction_fn)


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def params_device(params: Dict) -> torch.device:
    return params["tower"][0]["w"].device


def batch_to_device(batch, device: torch.device):
    """(ids, dense | None, labels) tensors on device from a host batch."""
    def put(a):
        return None if a is None else torch.from_numpy(np.asarray(a)).to(device)

    return put(batch["ids"]), put(batch["dense"]), put(batch["labels"])


@torch.inference_mode()
def eval_step(state: TrainState, auc_state, ids: torch.Tensor,
              dense: Optional[torch.Tensor], labels: torch.Tensor,
              cfg: TrainConfig, interaction_fn=None,
              mask: Optional[torch.Tensor] = None):
    logits = model_lib.forward(state.params, ids, dense, cfg.model,
                               interaction_fn=interaction_fn)
    logits = logits + metrics.calibration_offset(cfg.data)
    return metrics.auc_state_update(auc_state, logits, labels, mask=mask)


def evaluate(state: TrainState, batches: Iterable, cfg: TrainConfig,
             interaction_fn=None) -> Dict:
    """Binned AUC, logloss, calibration and count over host batches, on
    the device the params live on."""
    device = params_device(state.params)
    auc_state = metrics.auc_state_init(device=device)
    for batch in batches:
        ids, dense, labels = batch_to_device(batch, device)
        auc_state = eval_step(state, auc_state, ids, dense, labels, cfg,
                              interaction_fn)
    out = metrics.auc_state_finalize(auc_state)
    return {k: float(v) for k, v in out.items()}


def default_interaction_fn(cfg: TrainConfig):
    """The fused cross+conv1 path when enabled; None -> reference conv."""
    if cfg.model.use_pallas and cfg.model.conv_channels:
        from cffm_tpu_torch.ops.interaction_conv import make_interaction_fn

        return make_interaction_fn(use_kernel=True)
    return None


# ---------------------------------------------------------------------------
# Run
# ---------------------------------------------------------------------------


def run(cfg: TrainConfig, device=None, log_fn=print, interaction_fn=None,
        preemption_guard=None) -> Dict:
    """Train cfg.data.num_train_steps steps, then evaluate. Runs on the
    CUDA device unless device says otherwise.

    Batches reach the device through data.loader.device_prefetch (pinned
    buffers and a side stream on the card). With cfg.data.wire_format ==
    "packed" they travel in the packed wire format and the step unpacks
    them on the device. The eval takes a window of cfg.data.eval_batches
    batches of the val stream (32 when 0 on the synthetic stream); with
    eval_batches == 0 on a file dataset it makes ONE FULL PASS over the
    held-out split, the last batch padded with id 0 and mask 0.

    With cfg.sharding.table_sharded in a group of more than one process
    (torchrun's environment, or a default group already initialised) this
    takes the row-sharded path (parallel/sharded_train.py): each rank draws
    its own B/T block of every batch, and only rank 0 logs; a full-pass
    eval keeps the ranks in lockstep (a rank whose split has ended feeds
    all-masked batches until every rank's has). Otherwise it takes the
    single-device path, as the JAX run does on one device.

    With cfg.checkpoint_dir set it resumes from the latest checkpoint there
    (resharding the tables if the shard count changed, and skipping the
    batches already trained on), saves every cfg.checkpoint_every steps and
    at the end. preemption_guard (a utils.preemption.PreemptionGuard; by
    default one on SIGTERM) is checked every log_every (or 50) steps: on a
    stop the run saves, logs {"preempted_at_step"} and goes on to the eval.
    cfg.tensorboard_dir mirrors the logged scalars into event files.

    cfg.sharding.table_axis picks the sharded engine: "global" the flat
    exchange, "hier" the two-stage host-level dedup exchange (the same
    state and checkpoints) and "intra_host" the tables sharded over a
    host's cards and replicated across hosts (checkpointed as C shards);
    the latter two see the group as a (host, chip) grid, C from torchrun's
    LOCAL_WORLD_SIZE (`parallel/mesh.make_mesh_2d`)."""
    from cffm_tpu_torch.checkpoint import CheckpointManager
    from cffm_tpu_torch.data.loader import device_prefetch, make_dataset
    from cffm_tpu_torch.data.readers import resolve_paths
    from cffm_tpu_torch.parallel.mesh import (close_mesh, make_mesh, make_mesh_2d,
                                              requested_world_size)
    from cffm_tpu_torch.utils.preemption import PreemptionGuard
    from cffm_tpu_torch.utils.tb import ScalarWriter

    device = resolve_device(device)
    sharded = cfg.sharding.table_sharded and requested_world_size() > 1
    axis = cfg.sharding.table_axis
    if sharded and axis not in ("global", "hier", "intra_host"):
        raise ValueError(f"unknown table_axis {axis!r}")
    if interaction_fn is None:
        interaction_fn = default_interaction_fn(cfg)
    wire_spec = None
    if cfg.data.wire_format == "packed":
        from cffm_tpu_torch.data import wire as wire_lib

        wire_spec = wire_lib.spec_for_model(cfg.model)
    mesh = None
    num_shards = 1
    if sharded:
        from cffm_tpu_torch.parallel import dcn_mesh
        from cffm_tpu_torch.parallel import sharded_train as st

        group = dict(backend="gloo" if device.type == "cpu" else "nccl",
                     device=device if device.type == "cpu" else None)
        if axis == "global":
            mesh = make_mesh(**group)
        else:
            mesh2d = make_mesh_2d(**group)
            mesh = mesh2d.flat
        device = mesh.device
        if mesh.rank != 0:
            log_fn = lambda *_: None  # noqa: E731  (one rank logs)
        gen = torch.Generator(device=device).manual_seed(cfg.data.seed)
        if axis == "global":
            state = st.create_sharded_state(cfg, gen, mesh)
            step_fn = st.make_sharded_train_step(cfg, mesh, interaction_fn)
            sharded_eval = st.make_sharded_eval_step(cfg, mesh, interaction_fn)
        elif axis == "hier":
            state = st.create_sharded_state(cfg, gen, mesh)
            step_fn = st.make_sharded_train_step_hier(cfg, mesh2d, interaction_fn)
            sharded_eval = st.make_sharded_eval_step_hier(cfg, mesh2d, interaction_fn)
        else:
            state = dcn_mesh.create_sharded_state_2d(cfg, gen, mesh2d)
            step_fn = dcn_mesh.make_sharded_train_step_2d(cfg, mesh2d, interaction_fn)
            sharded_eval = dcn_mesh.make_sharded_eval_step_2d(cfg, mesh2d, interaction_fn)
        # the intra-host tables are C shards, replicated over the hosts
        num_shards = mesh2d.chips_per_host if axis == "intra_host" else mesh.world
        wire_step_fn = (st.wrap_wire_step(step_fn, wire_spec, cfg.model)
                        if wire_spec is not None else None)

        def eval_fn(auc_state, ids, dense, labels, mask=None):
            return sharded_eval(state, auc_state, ids, dense, labels, mask)[0]
    else:
        state = create_state(cfg, torch.Generator(device=device).manual_seed(cfg.data.seed))

        def step_fn(state, ids, dense, labels):
            return train_step(state, ids, dense, labels, cfg, interaction_fn)

        def wire_step_fn(state, wire):
            return train_step_wire(state, wire, wire_spec, cfg, interaction_fn)

        def eval_fn(auc_state, ids, dense, labels, mask=None):
            return eval_step(state, auc_state, ids, dense, labels, cfg, interaction_fn,
                             mask=mask)

    rank, world = (mesh.rank, mesh.world) if mesh else (0, 1)
    guard = PreemptionGuard() if preemption_guard is None else preemption_guard
    tb = ScalarWriter(cfg.tensorboard_dir, rank)
    ckpt_mgr = None
    try:
        # resume: the tables are resharded if the shard count changed, and
        # the stream below skips the batches already trained on
        start_step = 0
        if cfg.checkpoint_dir:
            ckpt_mgr = CheckpointManager(cfg.checkpoint_dir)
            if ckpt_mgr.latest_step() is not None:
                state, meta = ckpt_mgr.restore_auto(state, cfg, num_shards)
                start_step = state.step
                log_fn(json.dumps({"resumed_from_step": start_step,
                                   "checkpoint_meta": meta}))
        ds = make_dataset(cfg, rank, world, skip_batches=start_step)
        # a window of the repeat-mode val stream; a full pass (eval_batches
        # == 0 on a file dataset) makes a fresh one-pass stream per eval. A
        # path that matches no file takes the synthetic stream, which has
        # no end: it gets the window (the JAX run would never finish there)
        windowed = cfg.data.eval_batches > 0 or not (
            cfg.data.path and resolve_paths(cfg.data.path))
        val_ds = make_dataset(cfg, rank, world, split="val") if windowed else None

        def run_eval():
            auc_state = metrics.auc_state_init(device=device)
            if windowed:
                # the synthetic stream is infinite: a fixed window of batches
                for _ in range(cfg.data.eval_batches or 32):
                    auc_state = eval_fn(auc_state, *batch_to_device(next(val_ds), device))
            else:
                auc_state = _full_pass_eval(cfg, eval_fn, auc_state, rank, world, device,
                                            None if mesh is None else mesh.group)
            return {k: float(v) for k, v in metrics.auc_state_finalize(auc_state).items()}

        # a stop request costs at most stop_every steps of progress
        stop_every = cfg.log_every or 50
        preempted_at = None
        dev_ds = device_prefetch(ds, device)
        t0 = time.time()
        examples = 0
        last_loss = float("nan")
        m = None
        for step in range(start_step, cfg.data.num_train_steps):
            item = next(dev_ds)
            if wire_spec is not None:
                state, m = wire_step_fn(state, item)
                examples += int(item["labels"].shape[0]) * world
            else:
                ids, dense, labels = item
                state, m = step_fn(state, ids, dense, labels)
                examples += int(labels.shape[0]) * world
            if cfg.log_every and (step + 1) % cfg.log_every == 0:
                last_loss = float(m["loss"])
                elapsed = time.time() - t0
                rec = {"step": step + 1, "loss": last_loss,
                       "examples_per_s": examples / max(elapsed, 1e-9)}
                if "overflow" in m:
                    rec["id_overflow"] = int(m["overflow"])
                log_fn(json.dumps(rec))
                tb.scalars(step + 1, {"train/loss": rec["loss"],
                                      "train/examples_per_s": rec["examples_per_s"]})
            if cfg.data.eval_every and (step + 1) % cfg.data.eval_every == 0:
                ev = run_eval()
                log_fn(json.dumps({"step": step + 1, "eval": ev}))
                tb.scalars(step + 1, {f"eval/{k}": v for k, v in ev.items()})
            if ckpt_mgr and cfg.checkpoint_every and (step + 1) % cfg.checkpoint_every == 0:
                ckpt_mgr.save(step + 1, state, cfg, num_shards=num_shards)
            if (step + 1) % stop_every == 0 and guard.sync():
                # every rank agrees (sync is a collective): stop at this
                # step, save, and go on to the eval
                preempted_at = step + 1
                if ckpt_mgr:
                    ckpt_mgr.save(step + 1, state, cfg, num_shards=num_shards, wait=True)
                log_fn(json.dumps({"preempted_at_step": preempted_at,
                                   "checkpoint_saved": bool(ckpt_mgr)}))
                break
        dev_ds.close()

        result = run_eval()
        if math.isnan(last_loss) and m is not None:
            last_loss = float(m["loss"])
        result["final_train_loss"] = last_loss
        if preempted_at is not None:
            result["preempted_at_step"] = preempted_at
        log_fn(json.dumps({"eval": result}))
        tb.scalars(cfg.data.num_train_steps, {f"eval/{k}": v for k, v in result.items()})
        if ckpt_mgr:
            if preempted_at is None:
                # a preempted run saved at its stop step; a save at
                # num_train_steps would make the resume think the run was done
                ckpt_mgr.save(cfg.data.num_train_steps, state, cfg, num_shards=num_shards,
                              wait=True)
            ckpt_mgr.close()
        return result
    finally:
        guard.close()
        tb.close()
        if mesh is not None:
            close_mesh(mesh)


def _full_pass_eval(cfg: TrainConfig, eval_fn, auc_state, rank: int, world: int,
                    device: torch.device, group=None):
    """One pass over this rank's held-out split into auc_state. Every batch
    goes in at the full per-rank size: the last one padded with id 0
    (always a valid table row) and mask 0, so the padding adds nothing.
    With more than one rank, the ranks all-reduce an "alive" flag before
    each batch and a rank whose split has ended feeds all-masked batches
    until every rank's has, so the collectives of the eval step stay in
    lockstep."""
    import torch.distributed as dist

    from cffm_tpu_torch.data.loader import make_dataset

    per_rank = cfg.data.batch_size // world
    f, nd = cfg.model.num_fields, cfg.model.num_dense
    it = make_dataset(cfg, rank, world, split="val", repeat=False)
    while True:
        b = next(it, None)
        alive = b is not None
        if world > 1:
            flag = torch.tensor([int(alive)], dtype=torch.int32, device=device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
            alive_any = bool(flag.item())
        else:
            alive_any = alive
        if not alive_any:
            return auc_state
        mask = np.ones((per_rank,), np.float32)
        if b is None:
            b = {"ids": np.zeros((per_rank, f), np.int32),
                 "dense": np.zeros((per_rank, nd), np.float32) if nd else None,
                 "labels": np.zeros((per_rank,), np.float32)}
            mask[:] = 0.0
        else:
            n = len(b["labels"])
            pad = per_rank - n
            if pad > 0:
                b = {"ids": np.pad(b["ids"], ((0, pad), (0, 0))),
                     "dense": None if b["dense"] is None
                     else np.pad(b["dense"], ((0, pad), (0, 0))),
                     "labels": np.pad(b["labels"], (0, pad))}
                mask[n:] = 0.0
        ids, dense, labels = batch_to_device(b, device)
        auc_state = eval_fn(auc_state, ids, dense, labels,
                            torch.from_numpy(mask).to(device))


if __name__ == "__main__":
    from cffm_tpu_torch.cli import main as _main

    sys.exit(_main())

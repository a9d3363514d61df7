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
its state) and returns a new TrainState that shares them. The packed
wire-format step (`train_step_wire`) comes with the port's data slice.

Usage: python -m cffm_tpu_torch.train --config=<name> [--device=cuda]
       [section.field=value ...]
"""

from __future__ import annotations

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
from cffm_tpu_torch.optim.rowwise import (dense_rowwise_apply, fold_in,
                                          make_dense_optimizer, rowwise_init,
                                          rowwise_update, scale_updates,
                                          schedule_factor, sr_keys, tree_leaves,
                                          tree_unflatten, unique_bound)


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


def create_state(cfg: TrainConfig, generator: torch.Generator) -> TrainState:
    """Fresh params (drawn from generator, on its device) and optimizer state."""
    params = model_lib.init_params(cfg.model, generator)
    dense_opt_state = make_dense_optimizer(cfg.optim).init(split_dense_params(params))
    sparse = {"embed": rowwise_init(params["embed"]["table"], cfg.optim)}
    if cfg.model.use_first_order and not cfg.model.fused_linear:
        sparse["linear"] = rowwise_init(params["linear"]["table"], cfg.optim)
    return TrainState(0, params, dense_opt_state, sparse)


def _prefix_grad(g_small: torch.Tensor, ids_fm_small: torch.Tensor, cfg) -> torch.Tensor:
    """Gradient of the small-field prefix (small_rows, W) f32 from the
    prefix lookup's output gradient (Fs, B, W), as JAX takes it: per field
    the transposed one-hot product onehot^T @ g in the compute dtype (f32
    sums, rounded to the compute dtype); ids outside their field's block
    add nothing."""
    dt = g_small.dtype
    blocks = []
    off = 0
    for f in range(cfg.small_field_prefix):
        v = int(cfg.vocab_sizes[f])
        rows = off + torch.arange(v, device=ids_fm_small.device, dtype=ids_fm_small.dtype)
        onehot = (rows[:, None] == ids_fm_small[f][None, :]).to(dt)       # (v, B)
        blocks.append(onehot @ g_small[f])
        off += v
    return torch.cat(blocks).float()


def train_step(state: TrainState, ids: torch.Tensor, dense: Optional[torch.Tensor],
               labels: torch.Tensor, cfg: TrainConfig, interaction_fn=None):
    """One step on a batch: ids (B, F) int32 global, dense (B, num_dense)
    | None, labels (B,). Returns (new_state, {"loss", "logit_mean"})."""
    params = state.params
    mcfg = cfg.model
    cdt = model_lib.torch_dtype(mcfg.compute_dtype)
    # field-major full-rows route: ids transposed before the gather
    fm = model_lib.wants_field_major(params, mcfg, interaction_fn)
    # hybrid small-field prefix: its dense-form update exists for adagrad/sgd only
    fs = (mcfg.small_field_prefix
          if fm and cfg.optim.sparse_optimizer in ("adagrad", "sgd") else 0)
    dense_p = split_dense_params(params)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(dense_p)]
    full = merge_dense_params(params, tree_unflatten(dense_p, leaves))
    table = params["embed"]["table"]
    separate_linear = False
    with torch.enable_grad():
        if fm:
            ids_fm = ids.t()
            if fs:
                with torch.no_grad():
                    emb_small = model_lib.onehot_lookup_fm(
                        table[: mcfg.small_rows], ids_fm[:fs], mcfg, out_dtype=cdt)
                rows = [emb_small.requires_grad_()]
                emb_big = None
                if fs < mcfg.num_fields:
                    emb_big = model_lib.embedding_lookup_fm(params, ids_fm[fs:], mcfg).to(cdt)
                    rows.append(emb_big.requires_grad_())
                logits = model_lib.forward_from_rows_fm2(
                    full, emb_small, emb_big, dense, mcfg, interaction_fn=interaction_fn)
            else:
                emb3 = model_lib.embedding_lookup_fm(params, ids_fm, mcfg).to(cdt)
                rows = [emb3.requires_grad_()]
                logits = model_lib.forward_from_rows_fm(
                    full, emb3, dense, mcfg, interaction_fn=interaction_fn)
        else:
            emb_rows, lin_rows = model_lib.embedding_lookup(params, ids, mcfg)
            # rows cast to the compute dtype here, so their grads come back narrow
            emb_rows = emb_rows.to(cdt)
            rows = [emb_rows.requires_grad_()]
            separate_linear = mcfg.use_first_order and not mcfg.fused_linear
            if separate_linear:
                rows.append(lin_rows.requires_grad_())
            logits = model_lib.forward_from_rows(
                full, emb_rows, lin_rows, dense, mcfg, interaction_fn=interaction_fn)
        loss = metrics.logloss(logits, labels)
        grads = torch.autograd.grad(loss, leaves + rows)
    dgrads = tree_unflatten(dense_p, grads[: len(leaves)])
    row_grads = list(grads[len(leaves):])

    with torch.no_grad():
        # dense update, scaled by the LR schedule
        lrf = schedule_factor(cfg.optim, state.step, cfg.data.num_train_steps)
        updates, new_dense_opt = make_dense_optimizer(cfg.optim).update(
            dgrads, state.dense_opt_state, dense_p)
        for p, u in zip(tree_leaves(dense_p), tree_leaves(scale_updates(updates, lrf))):
            p.add_(u)

        # sparse per-row updates on the touched rows
        opt = cfg.optim
        sparse = state.sparse_opt_state
        offs = tuple(int(o) for o in model_lib.field_offsets(mcfg))
        batch = ids.shape[0]
        sk_emb, sk_lin = sr_keys(mcfg.table_dtype, opt, state.step, cfg.data.seed)
        if fs:
            dtab_small = _prefix_grad(row_grads[0], ids_fm[:fs], mcfg)
            if fs < mcfg.num_fields:
                # big fields only through the sort/dedup/update pipeline
                rowwise_update(table, sparse["embed"], ids_fm[fs:].reshape(-1),
                               row_grads[1].reshape(-1, mcfg.table_width), opt,
                               max_unique=unique_bound(mcfg.vocab_sizes[fs:], batch),
                               field_offsets=offs[fs:], mask_sentinels=False,
                               lr_scale=lrf, sr_key=sk_emb, field_major=True)
            # small block: dense per-row update of the table prefix, whose
            # rows [0, small_rows) no big-field id touches
            srows = mcfg.small_rows
            state_rows = {k: v for k, v in sparse["embed"].items()
                          if v.dim() >= 1 and v.shape[0] == table.shape[0]}
            new_small, new_small_state = dense_rowwise_apply(
                table[:srows], {k: v[:srows] for k, v in state_rows.items()},
                dtab_small, opt, lr_scale=lrf,
                sr_key=None if sk_emb is None else fold_in(sk_emb, 1))
            table[:srows] = new_small
            for k, v in new_small_state.items():
                if k in state_rows:
                    state_rows[k][:srows] = v
        else:
            flat_ids = ids_fm.reshape(-1) if fm else ids.reshape(-1)
            max_u = unique_bound(mcfg.vocab_sizes, batch)
            rowwise_update(table, sparse["embed"], flat_ids,
                           row_grads[0].reshape(-1, mcfg.table_width), opt,
                           max_unique=max_u, field_offsets=offs, mask_sentinels=False,
                           lr_scale=lrf, sr_key=sk_emb, field_major=fm)
            if separate_linear:
                rowwise_update(params["linear"]["table"], sparse["linear"], flat_ids,
                               row_grads[1].reshape(-1, 1), opt, max_unique=max_u,
                               field_offsets=offs, mask_sentinels=False,
                               lr_scale=lrf, sr_key=sk_lin)

    new_state = TrainState(state.step + 1, params, new_dense_opt, sparse)
    return new_state, {"loss": loss.detach(), "logit_mean": logits.detach().mean()}


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


def run(cfg: TrainConfig, device=None, log_fn=print, interaction_fn=None) -> Dict:
    """Train cfg.data.num_train_steps steps, then evaluate on a window of
    the val stream. Runs on the CUDA device unless device says otherwise.

    The single-device path of the JAX run loop; checkpoints, TensorBoard
    and the row-sharded engine arrive with later slices and raise here."""
    from cffm_tpu_torch.data.loader import make_dataset

    device = resolve_device(device)
    if cfg.checkpoint_dir or cfg.tensorboard_dir:
        raise NotImplementedError(
            "checkpoint_dir and tensorboard_dir arrive with the port's checkpoint "
            "slice (ROADMAP queue 1, checkpoint/score/export/utils)")
    if (cfg.sharding.table_sharded and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            "the row-sharded engine (table_sharded on more than one device) "
            "arrives with the port's sharded slice")
    if interaction_fn is None:
        interaction_fn = default_interaction_fn(cfg)
    state = create_state(cfg, torch.Generator(device=device).manual_seed(cfg.data.seed))
    ds = make_dataset(cfg)
    val_ds = make_dataset(cfg, split="val")

    def run_eval():
        # the synthetic stream is infinite: a fixed window of val batches
        auc_state = metrics.auc_state_init(device=device)
        for _ in range(cfg.data.eval_batches or 32):
            ids, dense, labels = batch_to_device(next(val_ds), device)
            auc_state = eval_step(state, auc_state, ids, dense, labels, cfg,
                                  interaction_fn)
        return {k: float(v) for k, v in metrics.auc_state_finalize(auc_state).items()}

    t0 = time.time()
    examples = 0
    last_loss = float("nan")
    m = None
    for step in range(cfg.data.num_train_steps):
        ids, dense, labels = batch_to_device(next(ds), device)
        state, m = train_step(state, ids, dense, labels, cfg, interaction_fn)
        examples += int(labels.shape[0])
        if cfg.log_every and (step + 1) % cfg.log_every == 0:
            last_loss = float(m["loss"])
            elapsed = time.time() - t0
            log_fn(json.dumps({"step": step + 1, "loss": last_loss,
                               "examples_per_s": examples / max(elapsed, 1e-9)}))
        if cfg.data.eval_every and (step + 1) % cfg.data.eval_every == 0:
            log_fn(json.dumps({"step": step + 1, "eval": run_eval()}))

    result = run_eval()
    if math.isnan(last_loss) and m is not None:
        last_loss = float(m["loss"])
    result["final_train_loss"] = last_loss
    log_fn(json.dumps({"eval": result}))
    return result


if __name__ == "__main__":
    from cffm_tpu_torch.cli import main as _main

    sys.exit(_main())

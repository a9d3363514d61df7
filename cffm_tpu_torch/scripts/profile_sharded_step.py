"""Decompose the flat sharded train step's time on the card.

    python -m cffm_tpu_torch.scripts.profile_sharded_step [batch] [stage ...]

The port's counterpart of `scripts/profile_sharded_step.py`: criteo_kaggle
with a bf16 table (stochastic rounding) and `sharding.table_sharded`, at
batch 8192 by default, on a process group of one (NCCL on the card, gloo
on the CPU), the batch made as the JAX script makes it. Each stage is a
cumulative fragment of `parallel/sharded_train._local_step`, built here
from the pieces it calls (the step itself has no stage switch):

  lookup   the hybrid prefix gather and one-hot lookup, `router.build` and
           `router.lookup` (the routed lookup of the big fields)
  fwd      + `forward_from_rows_fm2` (kernel 1) and the loss
  bwd      + `torch.autograd.grad` (kernel 2)
  dense    + the all-reduce of loss and grads and the dense optimizer
  gradret  + `router.grad` (the gradient return, kernel 6)
  update   + `router.apply` (the bucketed update, kernel 7) and the prefix
           apply: the whole step, equal to `make_sharded_train_step` bit
           for bit (a CPU test holds it)
  real     the shipped step (`make_sharded_train_step`)
  trace    the shipped step under torch.profiler, its kernels by device
           time (`scripts.trace_step.report`)

Each stage prints its ms per call (CUDA events over 5 calls after a warm
one) and, for a fragment, what it adds to the one before; the fragments
update the state in place as the step does. At B = 8192 the step is
bound by the host, so the CUDA events' span includes the device's idle
time. Exits nonzero without a CUDA card. The functions take `device`.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

FRAGMENTS = ("lookup", "fwd", "bwd", "dense", "gradret", "update")
STAGES = FRAGMENTS + ("real", "trace")


def profile_config(batch: int, name: str = "criteo_kaggle"):
    """The JAX script's config: bf16 table, table_sharded, the batch."""
    from cffm_tpu_torch.config import get_config

    cfg = get_config(name)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=batch),
        model=dataclasses.replace(cfg.model, table_dtype="bfloat16"),
        sharding=dataclasses.replace(cfg.sharding, table_sharded=True))


def batch_of(cfg, device, seed: int = 0):
    """(ids (B, F) int32 global, dense (B, num_dense) f32 | None, labels (B,))
    from numpy's uniform draw, as the JAX script makes them."""
    from cffm_tpu_torch.models.cffm import field_offsets

    mcfg = cfg.model
    b = cfg.data.batch_size
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, v, size=b) for v in mcfg.vocab_sizes], axis=1)
    ids = (ids + field_offsets(mcfg)[None, :]).astype(np.int32)
    dense = (rng.normal(size=(b, mcfg.num_dense)).astype(np.float32)
             if mcfg.num_dense else None)
    labels = (rng.random(b) < 0.3).astype(np.float32)
    put = (lambda a: None if a is None else torch.from_numpy(a).to(device))
    return put(ids), put(dense), put(labels)


def fragment(stage: str, state, ids, dense, labels, cfg, router, interaction_fn):
    """`_local_step` of the flat router cut after `stage`: None before
    "update", and (new_state, {"loss", "overflow"}) at "update"."""
    from cffm_tpu_torch import metrics
    from cffm_tpu_torch.models import cffm as model_lib
    from cffm_tpu_torch.optim.rowwise import (dense_rowwise_apply, fold_in,
                                              make_dense_optimizer, scale_updates,
                                              schedule_factor, sr_keys, tree_leaves,
                                              tree_unflatten)
    from cffm_tpu_torch.parallel.sharded_train import (_all_reduce_flat, _gather_prefix,
                                                       routed_ids)
    from cffm_tpu_torch.train import (TrainState, _prefix_grad, merge_dense_params,
                                      split_dense_params)

    if stage not in FRAGMENTS:
        raise ValueError(f"unknown fragment {stage!r}; have {FRAGMENTS}")
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

    with torch.no_grad():
        ids_fm = ids.t()
        if fs:
            srows = mcfg.small_rows
            ls = -(-srows // t_all)
            table_small = _gather_prefix(table_local, mesh, ls, srows)
            row_leaves = [model_lib.onehot_lookup_fm(table_small, ids_fm[:fs], mcfg,
                                                     out_dtype=cdt)]
        else:
            row_leaves = []
        routing = None
        if routed:
            routing = router.build(flat_ids, route_vocabs)
            row_leaves.append(router.lookup(table_local, routing, cdt))
            if separate_linear:
                row_leaves.append(router.lookup(params["linear"]["table"], routing,
                                                torch.float32))
    if stage == "lookup":
        return None

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
        loss = metrics.sigmoid_bce_with_logits(logits, labels).sum() / (b_loc * mesh.world)
        if stage == "fwd":
            return None
        grads = torch.autograd.grad(loss, leaves + row_leaves)
    if stage == "bwd":
        return None
    dgrads, row_grads = list(grads[: len(leaves)]), list(grads[len(leaves):])

    with torch.no_grad():
        overflow = (router.overflow(routing) if routed
                    else torch.zeros((), dtype=torch.int32, device=ids.device))
        summed = [loss.detach(), overflow.float()] + dgrads
        if fs:
            summed.append(_prefix_grad(row_grads[0], ids_fm[:fs], mcfg))
        summed = _all_reduce_flat(summed, mesh)
        loss, overflow = summed[0], summed[1].round().to(torch.int32)
        dgrads = summed[2:2 + len(dgrads)]
        lrf = schedule_factor(opt, state.step, cfg.data.num_train_steps)
        updates, new_dense_opt = make_dense_optimizer(opt).update(
            tree_unflatten(dense_p, dgrads), state.dense_opt_state, dense_p)
        for p, u in zip(tree_leaves(dense_p), tree_leaves(scale_updates(updates, lrf))):
            p.add_(u)
        if stage == "dense":
            return None

        sparse = state.sparse_opt_state
        sk_emb, sk_lin = sr_keys(mcfg.table_dtype, opt, state.step, cfg.data.seed)
        if sk_emb is not None:
            sk_emb, sk_lin = fold_in(sk_emb, shard), fold_in(sk_lin, shard)
        if routed:
            row_ids, bucket_grads = router.grad(row_grads[1 if fs else 0].reshape(-1, w),
                                                routing)
            if stage == "gradret":
                return None
            router.apply(table_local, sparse["embed"], row_ids, bucket_grads, opt, lrf, sk_emb)
        elif stage == "gradret":
            return None
        if fs:
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

    return TrainState(state.step + 1, params, new_dense_opt, sparse), {"loss": loss,
                                                                        "overflow": overflow}


def run(stages, cfg, mesh, device="cuda", n: int = 5, log=print) -> dict:
    """{stage: ms per call} of each stage on the group of mesh; "trace"
    reports the shipped step's kernels and maps to its device ms."""
    from cffm_tpu_torch import train
    from cffm_tpu_torch.parallel.sharded_train import (_make_flat_router,
                                                       create_sharded_state,
                                                       make_sharded_train_step)
    from cffm_tpu_torch.utils.timing import time_per_call

    device = torch.device(device)
    fn = train.default_interaction_fn(cfg)
    ids, dense, labels = batch_of(cfg, device)
    state = create_sharded_state(cfg, torch.Generator(device=device).manual_seed(0), mesh)
    out = {}
    for stage in stages:
        if stage in ("real", "trace"):
            step = make_sharded_train_step(cfg, mesh, fn)
            box = [state]

            def call():
                box[0], m = step(box[0], ids, dense, labels)
                return m
        else:
            router = _make_flat_router(cfg, mesh)

            def call(stage=stage, router=router):
                return fragment(stage, state, ids, dense, labels, cfg, router, fn)
        if stage == "trace":
            import tempfile

            from cffm_tpu_torch.scripts.trace_step import report
            from cffm_tpu_torch.utils.profiling import trace

            call()
            with tempfile.TemporaryDirectory(prefix="cffm_shtrace_") as log_dir:
                with trace(log_dir) as prof:
                    float(call()["loss"])
            out[stage] = report(prof, 1, min_ms=0.1)
            continue
        out[stage] = time_per_call(call, n=n, device=device) * 1e3
        prev = FRAGMENTS[FRAGMENTS.index(stage) - 1] if stage in FRAGMENTS[1:] else None
        added = f" (+{out[stage] - out[prev]:.3f} over {prev})" if prev in out else ""
        log(f"{stage}: {out[stage]:.3f} ms{added}", flush=True)
    return out


def main(argv=None) -> int:
    from cffm_tpu_torch.parallel.mesh import close_mesh, free_port, make_mesh
    from cffm_tpu_torch.parallel.sharded_train import _make_flat_router

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=8192)
    ap.add_argument("stages", nargs="*", help=f"any of {STAGES} (default: the fragments)")
    args = ap.parse_args(argv)
    if set(args.stages) - set(STAGES):
        ap.error(f"unknown stages {sorted(set(args.stages) - set(STAGES))}; have {STAGES}")
    if not torch.cuda.is_available():
        print("profile_sharded_step: no CUDA device", file=sys.stderr)
        return 1
    from cffm_tpu_torch.bench import card_line

    cfg = profile_config(args.batch)
    mesh = make_mesh(init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
                     backend="nccl", device="cuda:0")
    try:
        print(f"batch={args.batch} n_ids={args.batch * cfg.model.num_fields} "
              f"capacity={_make_flat_router(cfg, mesh).capacity}", flush=True)
        run(args.stages or list(FRAGMENTS), cfg, mesh)
    finally:
        close_mesh(mesh)
    print(f"card: {card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

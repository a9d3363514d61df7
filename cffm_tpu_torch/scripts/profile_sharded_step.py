"""Decompose the flat sharded train step's time on the card.

    python -m cffm_tpu_torch.scripts.profile_sharded_step [batch] [stage ...]

The port's counterpart of `scripts/profile_sharded_step.py`: criteo_kaggle
with a bf16 table (stochastic rounding) and `sharding.table_sharded`, at
batch 8192 by default, on a process group of one (NCCL on the card, gloo
on the CPU), the batch made as the JAX script makes it. Each stage is a
cumulative fragment of `parallel/sharded_train._local_step`, built here
from the phases it calls (the step itself has no stage switch):

  lookup   the hybrid prefix gather and one-hot lookup, `router.build` and
           `router.lookup` (the routed lookup of the big fields)
  fwd      + `models.cffm.forward_from_rows` (kernel 1) and the loss
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
    from cffm_tpu_torch.optim.rowwise import tree_unflatten
    from cffm_tpu_torch.parallel import sharded_train as st
    from cffm_tpu_torch.train import TrainState, dense_leaves, dense_update

    if stage not in FRAGMENTS:
        raise ValueError(f"unknown fragment {stage!r}; have {FRAGMENTS}")
    route = st.step_route(state.params, cfg, router, interaction_fn)
    dense_p, leaves, full = dense_leaves(state.params)
    with torch.no_grad():
        row_leaves, routing = st.step_lookup(state.params, ids, route, router, cfg)
    if stage == "lookup":
        return None
    with torch.enable_grad():
        loss = st.step_loss(full, route, row_leaves, dense, labels, router, cfg, interaction_fn)
        if stage == "fwd":
            return None
        grads = torch.autograd.grad(loss, leaves + row_leaves)
    if stage == "bwd":
        return None
    row_grads = grads[len(leaves):]
    with torch.no_grad():
        loss, overflow, dgrads, g_prefix = st.step_all_reduce(
            loss, grads[:len(leaves)], row_grads, routing, ids, route, router, cfg)
        new_dense_opt, lrf = dense_update(state, dense_p, tree_unflatten(dense_p, dgrads), cfg)
        if stage == "dense":
            return None
        if stage == "gradret":
            if routing is not None:
                router.grad(row_grads[1 if route.prefix else 0].reshape(
                    -1, cfg.model.table_width), routing)
            return None
        st.step_sparse_update(state, row_grads, routing, g_prefix, lrf, route, router, cfg)
    return (TrainState(state.step + 1, state.params, new_dense_opt, state.sparse_opt_state),
            {"loss": loss, "overflow": overflow})


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

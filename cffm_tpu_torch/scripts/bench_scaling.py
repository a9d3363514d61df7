"""Train-step throughput of the single-card, flat and hierarchical steps.

    python -m cffm_tpu_torch.scripts.bench_scaling [--batch=32768] [--hier=HxC] [--n=10]
    torchrun --nproc_per_node=N -m cffm_tpu_torch.scripts.bench_scaling --hier=HxC

The port's counterpart of `bench_scaling.py` (repo root). On the group
this process belongs to (torchrun's, one already initialised, or else a
group of one on a local port; NCCL on the card, gloo with --device=cpu),
criteo_kaggle from ONE natural-order state drawn from a seed and one batch (uniform
ids, normal dense features, labels at 0.3, from default_rng(0) as the
JAX script draws them):

  - the single-card `train.train_step` on the whole global batch;
  - the flat row-sharded step (`make_sharded_train_step`), each rank on
    its B/T block of the batch and its mod-shard of the state;
  - with --hier=HxC, the hierarchical step (`make_sharded_train_step_hier`)
    on that (host, chip) grid of the group.

Each is timed by host clock over n steps after a warm one, ending in a
synchronize, and printed by rank 0 as one JSON line: examples/s of the
global batch, the device count, the exchange, the first step's loss (the
same state and batch, so the three agree), the scaling efficiency
(ex/s over the single card's times the devices) and the card. A time is
taken only on the card unless --device=cpu asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch


def make_batch(cfg, batch: int, seed: int = 0):
    """(ids (B, F) int32 global, dense (B, num_dense) f32 | None, labels
    (B,) f32) numpy, drawn as the JAX script draws them."""
    from cffm_tpu_torch.models.cffm import field_offsets

    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, v, size=batch) for v in cfg.model.vocab_sizes],
                   axis=1).astype(np.int32)
    ids = ids + field_offsets(cfg.model)[None, :].astype(np.int32)
    nd = cfg.model.num_dense
    dense = rng.normal(size=(batch, nd)).astype(np.float32) if nd else None
    labels = (rng.random(batch) < 0.3).astype(np.float32)
    return ids, dense, labels


def _shard(state, t: int, rank: int):
    """Rank's mod-shard of a natural-order TrainState (copies)."""
    from cffm_tpu_torch.optim.rowwise import tree_map
    from cffm_tpu_torch.parallel.sharded_embedding import to_mod_sharded
    from cffm_tpu_torch.train import TrainState

    rows = state.params["embed"]["table"].shape[0]

    def cut(x):
        if isinstance(x, torch.Tensor) and x.dim() == 2 and x.shape[0] == rows:
            s = to_mod_sharded(x, t)
            vs = s.shape[0] // t
            return s[rank * vs:(rank + 1) * vs].clone()
        return x.clone() if isinstance(x, torch.Tensor) else x

    return TrainState(state.step, *(tree_map(cut, getattr(state, k)) for k in
                                    ("params", "dense_opt_state", "sparse_opt_state")))


def _timed(step, state, args, device, n: int):
    """(seconds per step over n after a warm step, the warm step's loss)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    state, m = step(state, *args)
    loss = float(m["loss"])
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        state, m = step(state, *args)
    float(m["loss"])
    sync()
    return (time.perf_counter() - t0) / n, loss


def run(cfg, batch: int, mesh, hier=None, n: int = 10, state=None):
    """The records, one per step kind, of cfg at global batch on the group
    of mesh (`parallel/mesh.Mesh`); hier an (H, C) grid of it or None.
    state: the natural-order TrainState to start from (by default
    create_state from cfg.data.seed)."""
    from cffm_tpu_torch import train
    from cffm_tpu_torch.parallel.mesh import make_mesh_2d
    from cffm_tpu_torch.parallel.sharded_train import (make_sharded_train_step,
                                                       make_sharded_train_step_hier)

    dev, t, rank = mesh.device, mesh.world, mesh.rank
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=batch),
        sharding=dataclasses.replace(cfg.sharding, table_sharded=True))
    fn = train.default_interaction_fn(cfg)
    if state is None:
        state = train.create_state(cfg, torch.Generator(device=dev).manual_seed(cfg.data.seed))
    whole = [None if a is None else torch.from_numpy(a).to(dev)
             for a in make_batch(cfg, batch)]
    b = batch // t
    block = [None if a is None else a[rank * b:(rank + 1) * b] for a in whole]

    def single(s, ids, dense, labels):
        return train.train_step(s, ids, dense, labels, cfg, fn)

    runs = [("single", 1, single, whole, None)]
    runs.append(("flat", t, make_sharded_train_step(cfg, mesh, fn), block, None))
    if hier:
        mesh2d = make_mesh_2d(*hier, device=dev)
        runs.append(("hier", t, make_sharded_train_step_hier(cfg, mesh2d, fn), block,
                     f"{hier[0]}x{hier[1]}"))
    records, single_rate = [], None
    for name, devices, step, args, grid in runs:
        start = _shard(state, 1, 0) if name == "single" else _shard(state, t, rank)
        sec, loss = _timed(step, start, args, dev, n)
        del start
        rate = batch / sec
        single_rate = single_rate or rate
        rec = {"metric": "examples_per_s", "devices": devices, "exchange": name,
               "value": round(rate, 1), "first_loss": loss,
               "scaling_efficiency": round(rate / (single_rate * devices), 3)}
        if grid:
            rec["mesh"] = grid
        records.append(rec)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    from cffm_tpu_torch.config import get_config
    from cffm_tpu_torch.parallel.mesh import close_mesh, free_port, make_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--hier", default=None, metavar="HxC",
                    help="also time the hierarchical step on an HxC grid of the group")
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"metric": "examples_per_s", "value": 0.0,
                          "error": "no CUDA device (pass --device=cpu for a CPU run)"}))
        return 1
    import torch.distributed as dist

    backend = "nccl" if args.device == "cuda" else "gloo"
    device = None if args.device == "cuda" else "cpu"
    if dist.is_initialized() or "MASTER_ADDR" in os.environ:
        mesh = make_mesh(backend=backend, device=device)
    else:  # a group of one
        mesh = make_mesh(init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
                         backend=backend, device=device or "cuda:0")
    try:
        hier = tuple(int(x) for x in args.hier.lower().split("x")) if args.hier else None
        records = run(get_config("criteo_kaggle"), args.batch, mesh, hier, args.n)
        if mesh.rank == 0:
            card = None
            if args.device == "cuda":
                from cffm_tpu_torch.bench import card_line

                card = card_line()
            for rec in records:
                print(json.dumps(dict(rec, batch=args.batch, card=card)), flush=True)
    finally:
        close_mesh(mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())

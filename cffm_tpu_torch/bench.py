"""Benchmark: CFFM train-step and forward throughput on the CUDA card.

    python -m cffm_tpu_torch.bench [--feed=staged|score|sharded|reader|prehashed]
        [--config=criteo_kaggle] [--table_dtype=bfloat16|float32]
        [--sparse_optimizer=...] [--batch=65536] [--timeout=900]

The port's counterpart of `bench.py`. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "examples/s", "batch": ..., "feed": ...,
   "table_dtype": ..., ["sparse_optimizer": ..., "caveat": ...,]
   "card": "<nvidia-smi name, power limit>", "device": "<torch device name>"}
and exits 0; on an error the line carries "error" (and value 0) and the
exit code is 1. Feeds:

  staged   the train step (`train.train_step`) on a synthetic batch staged
           on the card (the recipe of `bench.py`: `default_rng(0)`, uniform
           ids per field); one warm step, then 10 steps timed by host clock
           ending in a synchronize
  score    the forward (`models.cffm.forward` under no_grad) on the same
           batch, timed with CUDA events (`utils.timing.device_time`)
  sharded  the row-sharded step (`parallel.sharded_train`) on the default
           process group if one is initialised, else on an NCCL group of one
           (each rank times its own B/T block: examples/s per card)
  reader   batches streamed from a file: a Criteo TSV of (10 + 3) * B rows
           written from a seed (`scripts/bench_input._write_criteo`) into a
           temporary directory, read by `data.loader.make_dataset(prefetch=4)`
           (the native multi-threaded reader), packed into the wire format,
           staged by `data.loader.device_prefetch` and trained by
           `train.train_step_wire` (the recipe of `bench.py`'s reader feed);
           one warm step, then 10 timed by host clock ending in a synchronize
  prehashed
           the same, with the TSV converted to a .cfb file first
           (`data.prehash.convert`) and read shuffled

The batch ladder retries at smaller batches only on
`torch.cuda.OutOfMemoryError`, after dropping the failed rung's tensors. A
watchdog prints the JSON line with an error and exits 1 after --timeout
seconds. What `bench.py` carries and this one does not: `vs_baseline` (its
125,000 ex/s per chip is a TPU v5e-8 target) and `BENCH_LAST_GOOD.json`
(a record of TPU runs): this bench neither reads nor writes that file.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

FEEDS = ("staged", "reader", "prehashed", "score", "sharded")
STEPS = 10


def bench_config(config: str = "criteo_kaggle", batch: int = 65536,
                 table_dtype: str = "bfloat16", sparse_optimizer: str | None = None):
    """The named config at this batch and table dtype (and optimizer)."""
    from cffm_tpu_torch.config import get_config

    cfg = get_config(config)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=batch),
        model=dataclasses.replace(cfg.model, table_dtype=table_dtype))
    if sparse_optimizer:
        cfg = dataclasses.replace(
            cfg, optim=dataclasses.replace(cfg.optim, sparse_optimizer=sparse_optimizer))
    return cfg


def staged_batch(cfg) -> dict:
    """The synthetic batch of `bench.py` (numpy): uniform ids per field from
    default_rng(0) plus the field offsets, then normal dense features, then
    labels with P(1) = 0.3."""
    from cffm_tpu_torch.models.cffm import field_offsets

    batch = cfg.data.batch_size
    mcfg = cfg.model
    rng = np.random.default_rng(0)
    ids_local = np.stack([rng.integers(0, v, size=batch) for v in mcfg.vocab_sizes],
                         axis=1).astype(np.int32)
    ids = ids_local + field_offsets(mcfg)[None, :].astype(np.int32)
    dense = (rng.normal(size=(batch, mcfg.num_dense)).astype(np.float32)
             if mcfg.num_dense else None)
    labels = (rng.random(batch) < 0.3).astype(np.float32)
    return {"ids": ids, "dense": dense, "labels": labels}


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_staged(cfg, device: torch.device, n: int) -> float:
    from cffm_tpu_torch import train

    ids, dense, labels = train.batch_to_device(staged_batch(cfg), device)
    state = train.create_state(cfg, torch.Generator(device=device).manual_seed(0))
    fn = train.default_interaction_fn(cfg)
    state, _ = train.train_step(state, ids, dense, labels, cfg, fn)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        state, m = train.train_step(state, ids, dense, labels, cfg, fn)
    float(m["loss"])
    _sync(device)
    return ids.shape[0] * n / (time.perf_counter() - t0)


def _run_score(cfg, device: torch.device, n: int) -> float:
    from cffm_tpu_torch import train
    from cffm_tpu_torch.models.cffm import forward, init_params
    from cffm_tpu_torch.utils.timing import time_per_call

    ids, dense, _ = train.batch_to_device(staged_batch(cfg), device)
    params = init_params(cfg.model, torch.Generator(device=device).manual_seed(0))
    fn = train.default_interaction_fn(cfg)

    @torch.no_grad()
    def score():
        return forward(params, ids, dense, cfg.model, interaction_fn=fn)

    return ids.shape[0] / time_per_call(score, n=n, device=device)


def _run_sharded(cfg, device: torch.device, n: int) -> float:
    import torch.distributed as dist

    from cffm_tpu_torch import train
    from cffm_tpu_torch.parallel.mesh import close_mesh, free_port, make_mesh
    from cffm_tpu_torch.parallel.sharded_train import (create_sharded_state,
                                                       make_sharded_train_step)

    cfg = dataclasses.replace(
        cfg, sharding=dataclasses.replace(cfg.sharding, table_sharded=True))
    if dist.is_initialized():
        mesh = make_mesh(device=device)
    else:
        mesh = make_mesh(init_method=f"tcp://localhost:{free_port()}", rank=0,
                         world_size=1, device=device)
    try:
        batch = staged_batch(cfg)
        b = cfg.data.batch_size
        if b % mesh.world:
            raise ValueError(f"batch {b} is not a multiple of the group size {mesh.world}")
        lo, hi = mesh.rank * b // mesh.world, (mesh.rank + 1) * b // mesh.world
        block = {k: None if v is None else v[lo:hi] for k, v in batch.items()}
        ids, dense, labels = train.batch_to_device(block, mesh.device)
        state = create_sharded_state(cfg, torch.Generator(device=mesh.device).manual_seed(0),
                                     mesh)
        step = make_sharded_train_step(cfg, mesh, train.default_interaction_fn(cfg))
        state, _ = step(state, ids, dense, labels)
        _sync(mesh.device)
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, ids, dense, labels)
        float(m["loss"])
        _sync(mesh.device)
        return ids.shape[0] * n / (time.perf_counter() - t0)
    finally:
        close_mesh(mesh)


def _run_reader_fed(cfg, device: torch.device, n: int, prehashed: bool) -> float:
    import tempfile

    from cffm_tpu_torch import train
    from cffm_tpu_torch.data import wire as wire_lib
    from cffm_tpu_torch.data.loader import device_prefetch, make_dataset
    from cffm_tpu_torch.data.prehash import convert
    from cffm_tpu_torch.scripts.bench_input import _write_criteo

    batch = cfg.data.batch_size
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "criteo.tsv")
        _write_criteo(path, (n + 3) * batch)
        if prehashed:
            cfb = os.path.join(d, "criteo.cfb")
            convert(path, cfb, cfg.model, "criteo", chunk=batch)
            path = cfb
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, path=path, dataset="criteo", shuffle=prehashed,
            wire_format="packed"))
        spec = wire_lib.spec_for_model(cfg.model)
        dev_ds = device_prefetch(make_dataset(cfg, prefetch=4), device)
        fn = train.default_interaction_fn(cfg)
        state = train.create_state(cfg, torch.Generator(device=device).manual_seed(0))
        try:
            # the warm step also fills the prefetch pipes
            state, _ = train.train_step_wire(state, next(dev_ds), spec, cfg, fn)
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(n):
                state, m = train.train_step_wire(state, next(dev_ds), spec, cfg, fn)
            float(m["loss"])
            _sync(device)
            return batch * n / (time.perf_counter() - t0)
        finally:
            dev_ds.close()


def run_feed(cfg, feed: str = "staged", device=None, n: int = STEPS) -> float:
    """Examples/s of one feed at cfg's batch, on the CUDA card unless device
    says otherwise. Raises on any error (the ladder in main handles OOM)."""
    from cffm_tpu_torch import resolve_device

    if feed not in FEEDS:
        raise ValueError(f"unknown feed {feed!r}; have {FEEDS}")
    device = resolve_device(device)
    if feed == "score":
        return _run_score(cfg, device, n)
    if feed == "sharded":
        return _run_sharded(cfg, device, n)
    if feed in ("reader", "prehashed"):
        return _run_reader_fed(cfg, device, n, prehashed=feed == "prehashed")
    return _run_staged(cfg, device, n)


def metric_name(config: str, feed: str) -> str:
    return (f"{config}_score_examples_per_s_per_chip" if feed == "score"
            else f"{config}_train_step_examples_per_s_per_chip")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ladder(batch: int):
    """The batches to try, largest first: batch, then the known rungs below it."""
    rungs = sorted({batch, 65536, 49152, 32768, 16384, 8192, 4096}, reverse=True)
    return [b for b in rungs if b <= batch] or [batch]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="CFFM throughput on the CUDA card")
    ap.add_argument("--feed", choices=FEEDS, default="staged")
    ap.add_argument("--table_dtype", choices=("float32", "bfloat16"), default="bfloat16",
                    help="embedding-table storage dtype (bf16 tables round the "
                         "sparse updates stochastically)")
    ap.add_argument("--config", default="criteo_kaggle", help="named config to bench")
    ap.add_argument("--sparse_optimizer", default=None,
                    choices=(None, "adagrad", "adam", "rowwise_adam", "sgd"),
                    help="override the config's sparse optimizer")
    ap.add_argument("--batch", type=int, default=65536,
                    help="starting batch size (smaller rungs follow on OOM)")
    ap.add_argument("--timeout", type=int, default=900,
                    help="whole-run watchdog in seconds (0: none)")
    args = ap.parse_args(argv)

    out = {"metric": metric_name(args.config, args.feed), "value": 0.0,
           "unit": "examples/s", "batch": args.batch, "feed": args.feed,
           "table_dtype": args.table_dtype}
    if args.sparse_optimizer:
        out["sparse_optimizer"] = args.sparse_optimizer

    def watchdog():
        print(json.dumps(dict(out, error=f"timeout after {args.timeout}s")), flush=True)
        os._exit(1)

    timer = None
    if args.timeout > 0:
        timer = threading.Timer(args.timeout, watchdog)
        timer.daemon = True
        timer.start()
    try:
        return _bench(args, out)
    finally:
        if timer is not None:
            timer.cancel()


def _bench(args, out: dict) -> int:
    oom = None
    try:
        for batch in ladder(args.batch):
            out["batch"] = batch
            try:
                cfg = bench_config(args.config, batch, args.table_dtype, args.sparse_optimizer)
                value = run_feed(cfg, args.feed)
                oom = None
                break
            except torch.cuda.OutOfMemoryError as e:
                oom = f"OutOfMemoryError at batch={batch}"
                sys.stderr.write(f"bench: {oom}: {e}\n")
            # the failed rung's tensors are unreachable once the handler is left
            gc.collect()
            torch.cuda.empty_cache()
        if oom:
            raise RuntimeError(f"every batch rung ran out of memory (last: {oom})")
        out["value"] = value
        if args.feed == "sharded":
            import torch.distributed as dist

            world = dist.get_world_size() if dist.is_initialized() else 1
            if world == 1:
                out["caveat"] = ("T=1: the all-to-alls are copies on one card; routing, "
                                 "dedup and the row update are real")
        out["card"] = card_line()
        out["device"] = torch.cuda.get_device_name(0)
    except Exception as e:  # noqa: BLE001 - the bench reports every failure on its line
        traceback.print_exc(file=sys.stderr)
        out["value"] = 0.0
        out["error"] = f"{type(e).__name__}: {e}"
        print(json.dumps(out), flush=True)
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

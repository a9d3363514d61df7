"""Trace the flat sharded train step on the card and print its kernels by
device time.

    python -m cffm_tpu_torch.scripts.trace_sharded [config] [batch] [steps]
        [--log_dir=build/traces/trace_sharded]

The port's counterpart of `scripts/trace_sharded.py`: the config (default
criteo_kaggle, its table dtype as configured) with
`sharding.table_sharded`, at batch 65536 by default, through
`make_sharded_train_step` on a process group of one (NCCL on the card,
gloo on the CPU), on the batch of `profile_sharded_step`. One warm step,
then `utils.profiling.trace` (torch.profiler) over `steps` steps (default
3); the kernels over 0.4 ms a step print through `trace_step.report`,
and the Chrome trace lands in --log_dir. Exits nonzero without a CUDA
card. `capture` takes `device`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import sys

import torch

DEFAULT_LOG_DIR = str(pathlib.Path(__file__).resolve().parents[2] / "build" / "traces"
                      / "trace_sharded")


def sharded_config(name: str, batch: int):
    from cffm_tpu_torch.config import get_config

    cfg = get_config(name)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=batch),
        sharding=dataclasses.replace(cfg.sharding, table_sharded=True))


def capture(cfg, steps: int, log_dir: str, mesh, device="cuda"):
    """The profiler of `steps` sharded steps on mesh's group after one warm step."""
    from cffm_tpu_torch import train
    from cffm_tpu_torch.parallel.sharded_train import (create_sharded_state,
                                                       make_sharded_train_step)
    from cffm_tpu_torch.scripts.profile_sharded_step import batch_of
    from cffm_tpu_torch.utils.profiling import trace

    device = torch.device(device)
    ids, dense, labels = batch_of(cfg, device)
    state = create_sharded_state(cfg, torch.Generator(device=device).manual_seed(0), mesh)
    step = make_sharded_train_step(cfg, mesh, train.default_interaction_fn(cfg))
    state, m = step(state, ids, dense, labels)
    float(m["loss"])  # the warm step has finished
    with trace(log_dir) as prof:
        for _ in range(steps):
            state, m = step(state, ids, dense, labels)
        float(m["loss"])
    return prof


def main(argv=None) -> int:
    from cffm_tpu_torch.parallel.mesh import close_mesh, free_port, make_mesh
    from cffm_tpu_torch.scripts.trace_step import report

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default="criteo_kaggle")
    ap.add_argument("batch", nargs="?", type=int, default=65536)
    ap.add_argument("steps", nargs="?", type=int, default=3)
    ap.add_argument("--log_dir", default=DEFAULT_LOG_DIR)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_sharded: no CUDA device", file=sys.stderr)
        return 1
    cfg = sharded_config(args.config, args.batch)
    mesh = make_mesh(init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
                     backend="nccl", device="cuda:0")
    try:
        prof = capture(cfg, args.steps, args.log_dir, mesh)
    finally:
        close_mesh(mesh)
    report(prof, args.steps)
    print(f"trace: {os.path.join(args.log_dir, 'trace.json')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

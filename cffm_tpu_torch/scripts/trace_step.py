"""Trace the train step on the card and print its kernels by device time.

    python -m cffm_tpu_torch.scripts.trace_step [config] [batch] [steps]
        [--log_dir=build/traces/trace_step]

The port's counterpart of `scripts/trace_step.py`: one warm step, then
`utils.profiling.trace` (torch.profiler, CPU and CUDA activities) over
`steps` train steps on the synthetic batch of `bench.py`. Prints one line
per kernel over 0.4 ms of device time per step (ms and name) and their
sum; the Chrome trace (Perfetto-viewable) lands in --log_dir. If the
profiler recorded no device time it says so: time with CUDA events then.
"""

from __future__ import annotations

import argparse
import os
import pathlib

import torch

DEFAULT_LOG_DIR = str(pathlib.Path(__file__).resolve().parents[2] / "build" / "traces"
                      / "trace_step")


def capture(cfg, steps: int, log_dir: str, device="cuda"):
    """The profiler of `steps` train steps after one warm step."""
    from cffm_tpu_torch import train
    from cffm_tpu_torch.bench import staged_batch
    from cffm_tpu_torch.utils.profiling import trace

    device = torch.device(device)
    ids, dense, labels = train.batch_to_device(staged_batch(cfg), device)
    state = train.create_state(cfg, torch.Generator(device=device).manual_seed(0))
    fn = train.default_interaction_fn(cfg)
    state, m = train.train_step(state, ids, dense, labels, cfg, fn)
    float(m["loss"])  # the warm step has finished
    with trace(log_dir) as prof:
        for _ in range(steps):
            state, m = train.train_step(state, ids, dense, labels, cfg, fn)
        float(m["loss"])
    return prof


def device_kernels(prof, steps: int) -> list:
    """[(ms per step, name)] of the device kernels, largest first."""
    rows = [(e.self_device_time_total / 1e3 / steps, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(rows, reverse=True)


def report(prof, steps: int, min_ms: float = 0.4) -> float:
    """Print the kernels over min_ms per step; returns the device ms per step."""
    rows = device_kernels(prof, steps)
    busy = sum(ms for ms, _ in rows)
    if busy <= 0:
        print("trace: the profiler recorded no device time; time the step with CUDA "
              "events instead", flush=True)
        return 0.0
    listed = 0.0
    for ms, name in rows:
        if ms < min_ms:
            break
        listed += ms
        print(f"{ms:8.3f}ms {name[:100]}", flush=True)
    print(f"-- sum of listed: {listed:.3f} ms of {busy:.3f} ms device time per step "
          f"({steps} steps traced)", flush=True)
    return busy


def main(argv=None) -> int:
    from cffm_tpu_torch.bench import bench_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default="criteo_kaggle")
    ap.add_argument("batch", nargs="?", type=int, default=32768)
    ap.add_argument("steps", nargs="?", type=int, default=3)
    ap.add_argument("--log_dir", default=DEFAULT_LOG_DIR)
    args = ap.parse_args(argv)
    cfg = bench_config(args.config, args.batch, "float32")
    prof = capture(cfg, args.steps, args.log_dir)
    report(prof, args.steps)
    print(f"trace: {os.path.join(args.log_dir, 'trace.json')}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

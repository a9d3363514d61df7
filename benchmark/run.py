"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic, limits
and metrics are found by name from BENCHMARK.json (benchmark/spec.py).
With --trace 0 the line carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read from a traced stretch run after
the window. Every run checks what the timed path produced against the
plain reference and prints each number compared beside its limit, last
on standard error and last in the line. Exit codes: 0 a result printed,
2 no card (or too few) or no port to run, 3 JAX found in the process.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

_IMPORTED_AT = time.time()
ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that must not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "cffm_tpu")


def process_start() -> float:
    """This process's start on the wall clock, from /proc (the import time
    of this module where /proc cannot be read)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED_AT


def forbidden_loaded() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _fail(msg: str, code: int) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import checks, spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    chips = int(cell["workload"]["chips"])
    # the program's kernel caches live in the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return _fail(f"{args.workload} needs {chips} CUDA card(s); "
                     f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", 2)
    try:
        import cffm_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the port is not in this checkout: {e}", 2)

    job = spec.Job(workload=args.workload, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), config=cell["config"], traffic=cell["traffic"],
                   limits=cell["limits"], device=torch.device("cuda", 0))
    res = spec.driver(cell["traffic"]).run(job)
    setup_s = res["setup_end"] - process_start() - res["check_s"]

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if spec.applies(m, args.workload):
                v = spec.metric_module(m["name"]).read(res["run"])
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(res["metrics"], setup_s=setup_s)
        for m in bench["end_to_end"]:
            if spec.applies(m, args.workload) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}

    correct, compared = checks.judge(res["numbers"], cell["limits"])
    correct = correct and res["failed"] == 0
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    tr = res["run"].trace
    if tr is not None:
        device["busy_s"], device["window_s"] = tr.busy_s, tr.window_s
        line["breakdown"] = tr.breakdown()
        line["launches"] = {k: v for k, v in res["run"].launches.items() if v}
    line["checks"] = compared

    found = forbidden_loaded()
    if found:
        return _fail(f"the process loaded {found}", 3)
    laps = {"start": res["setup_end"] - process_start() - sum(res["setup_laps"].values())}
    for name, sec in dict(laps, **res["setup_laps"]).items():
        print(f"setup {name}: {sec:.3f} s", file=sys.stderr)
    for name, c in compared.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

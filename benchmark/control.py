"""Readings that set a cell's limits: the program's sound runs, the
control and the planted faults, over many seeds in one process.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --kind control
    python3 benchmark/control.py --workload <name> --seeds 1,...,12 --kind program
    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --kind half_batch

"program" runs the cell's driver (a window of --seconds, the reference
check) and reports the numbers compared; a fault name (benchmark/faults.py)
does the same with that fault planted under the timed path; "control"
puts the reference, computed in fp8 where the configuration states bf16,
in the program's place against the f32 reference, with no window. One
JSON line per seed on standard output; the benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(job, kind: str) -> dict:
    from benchmark import checks, faults, spec

    drv = spec.driver(job.traffic)
    if kind == "control":
        return drv.control_numbers(job)
    if kind != "program":
        job.wrap_step = faults.FAULTS[kind]
    res = drv.run(job)
    out = dict(res["numbers"])
    if "readings" in res:
        r = res["readings"]
        out.update(checks.train_readings(r["program"], r["reference"]), readings=r)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--kind", default="control")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)

    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(spec.benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        job = spec.Job(workload=args.workload, seed=seed, seconds=args.seconds, trace=False,
                       config=cell["config"], traffic=cell["traffic"], limits=cell["limits"],
                       device=torch.device("cuda", 0), readings=True)
        nums = readings(job, args.kind)
        print(json.dumps({"workload": args.workload, "kind": args.kind, "seed": seed,
                          "numbers": nums, "limits": cell["limits"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run the queued card experiments, each in a fresh process.

    python -m cffm_tpu_torch.scripts.run_pending_experiments [--quick]
        [--only=name,...] [--out=build/experiments.jsonl]

The port's counterpart of `scripts/run_pending_experiments.py`, over the
port's own commands. Each experiment runs in a fresh subprocess (a clean
card, and a hung run cannot take the sweep with it) under a hard timeout,
from the root of the checkout; its record (name, command, exit code,
seconds, the ends of its output and errors) is appended to --out as it
ends, so every finished result is on disk. The sweep stops after two
failures in a row that printed nothing. Results go under `build/`, never
under `docs/` (its `experiments_r2.jsonl` is the TPU's record).

The list maps the JAX runner's experiments onto the port: the staged
bench at batches 32768, 40960, 49152 and 65536 (f32 table, as the JAX
bench defaults), the reader and prehashed feeds, the bf16 table at 32768
and 65536, the two flagship learn checks through
`python -m cffm_tpu_torch.train`, and `bench_kernel`, `probe_gather` and
`trace_step`. The TPU's `--bts` sweep of `bench_kernel` has no
counterpart (the CUDA kernels take no batch tile) and is dropped.
Exits 0 when every experiment run succeeded, nonzero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "experiments.jsonl"
QUICK = ("bench_staged_32768", "flagship_learn_check")
LEARN = ("--config=criteo_kaggle", "data.num_train_steps=300", "data.batch_size=8192",
         "log_every=50", "data.eval_batches=8")


def experiments(py: str = sys.executable) -> list:
    """[(name, argv, timeout seconds)], in the JAX runner's order."""
    bench = [py, "-m", "cffm_tpu_torch.bench", "--timeout=600"]
    train = [py, "-u", "-m", "cffm_tpu_torch.train"]
    script = [py, "-m"]
    return [
        ("bench_staged_32768", bench + ["--batch=32768", "--table_dtype=float32"], 700),
        ("flagship_learn_check", train + list(LEARN), 900),
        ("bench_staged_49152", bench + ["--batch=49152", "--table_dtype=float32"], 700),
        ("bench_staged_65536", bench + ["--batch=65536", "--table_dtype=float32"], 700),
        ("bench_staged_40960", bench + ["--batch=40960", "--table_dtype=float32"], 700),
        ("bench_reader", bench + ["--feed=reader", "--table_dtype=float32"], 700),
        ("bench_prehashed", bench + ["--feed=prehashed", "--table_dtype=float32"], 700),
        ("bench_staged_bf16", bench + ["--batch=32768", "--table_dtype=bfloat16"], 700),
        ("bench_staged_bf16_65536", bench + ["--batch=65536", "--table_dtype=bfloat16"], 700),
        ("flagship_bf16_learn_check", train + list(LEARN) + ["model.table_dtype=bfloat16"],
         900),
        ("bench_kernel", script + ["cffm_tpu_torch.scripts.bench_kernel"], 700),
        ("probe_gather", script + ["cffm_tpu_torch.scripts.probe_gather"], 700),
        ("trace_step", script + ["cffm_tpu_torch.scripts.trace_step"], 900),
    ]


def run(name: str, cmd: list, timeout: int, out: pathlib.Path, log=print) -> dict:
    """Run one experiment to its end or its timeout; append its record to out."""
    t0 = time.time()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        rc, stdout, stderr = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc = -1
        stdout = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        stderr = f"TIMEOUT after {timeout}s"
    rec = {"name": name, "cmd": " ".join(cmd), "rc": rc, "secs": round(time.time() - t0, 1),
           "tail": stdout[-2000:], "err_tail": (stderr or "")[-500:],
           "ts": time.strftime("%Y-%m-%d %H:%M:%S")}
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    log(f"== {name}: rc={rc} {rec['secs']}s", flush=True)
    log(stdout[-800:], flush=True)
    return rec


def sweep(exps: list, out: pathlib.Path, log=print) -> list:
    """Run exps in order; stop after two silent failures in a row."""
    results = []
    for name, cmd, timeout in exps:
        results.append(run(name, cmd, timeout, out, log))
        if len(results) >= 2 and all(r["rc"] != 0 and not r["tail"].strip()
                                     for r in results[-2:]):
            log("== two silent failures in a row: stopping the sweep", flush=True)
            break
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="only the headline bench and the flagship learn check")
    ap.add_argument("--only", default=None, help="comma-separated experiment names")
    ap.add_argument("--out", default=str(OUT), help="JSONL the records are appended to")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out).resolve()
    if out.is_relative_to(ROOT / "docs"):
        ap.error(f"--out {out} lies under docs/, which holds the TPU's records")
    import torch

    if not torch.cuda.is_available():
        print("run_pending_experiments: no CUDA device; every experiment runs on the card",
              file=sys.stderr)
        return 1
    exps = experiments()
    if args.quick:
        exps = [e for e in exps if e[0] in QUICK]
    if args.only:
        names = set(args.only.split(","))
        if names - {e[0] for e in exps}:
            ap.error(f"unknown experiments {sorted(names - {e[0] for e in exps})}")
        exps = [e for e in exps if e[0] in names]
    results = sweep(exps, out)
    ok = sum(1 for r in results if r["rc"] == 0)
    print(f"== done: {ok}/{len(results)} of {len(exps)} succeeded; results in {out}",
          flush=True)
    return 0 if ok == len(exps) else 1


if __name__ == "__main__":
    sys.exit(main())

"""Host input pipeline: parse + hash + batch rows/s, no device.

    python -m cffm_tpu_torch.scripts.bench_input [--rows=2000000]
        [--threads=1,2,4,8] [--batch=32768]

The port's counterpart of `bench_input.py`. Writes a Criteo-shaped TSV
of --rows rows into a temporary directory (`_write_criteo`), reads it
through the native multi-threaded reader at each thread count, then
converts it to a pre-hashed .cfb file and reads that; prints one JSON
line per point and a summary line:

  {"metric": "input_rows_per_s", "threads": N, "value": rows/s, "mb_per_s": ...}
  {"metric": "input_rows_per_s_prehashed", "value": ..., "convert_rows_per_s": ...}
  {"metric": "input_rows_per_s_best", "value": ..., "unit": "rows/s", "threads": N}

Exit code 1 with an "error" line when the native parser is unavailable.
The rates are the host's own; no device is involved.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def _write_criteo(path: str, rows: int) -> None:
    """A Criteo-shaped TSV of at least `rows` rows, from default_rng(0):
    a block of min(rows, 100000) rows (label, 13 ints with empty fields
    for missing, 26 eight-digit hex categoricals) written again and again.
    The same bytes as `bench_input._write_criteo`."""
    rng = np.random.default_rng(0)
    block_rows = min(rows, 100_000)
    labels = rng.integers(0, 2, size=block_rows)
    ints = rng.integers(-1, 40000, size=(block_rows, 13))
    cats = rng.integers(0, 2**32, size=(block_rows, 26))
    lines = []
    for r in range(block_rows):
        lines.append("\t".join(
            [str(labels[r])]
            + [str(x) if x >= 0 else "" for x in ints[r]]
            + [format(x, "08x") for x in cats[r]]))
    block = ("\n".join(lines) + "\n").encode()
    with open(path, "wb") as f:
        written = 0
        while written < rows:
            f.write(block)
            written += block_rows


def _write_avazu(path: str, rows: int, seed: int = 0) -> None:
    """An Avazu-shaped CSV of `rows` rows with its header, from
    default_rng(seed): a hex id, the click, the hour YYMMDDHH in October
    2014, and 21 six-digit hex categoricals."""
    rng = np.random.default_rng(seed)
    ident = rng.integers(0, 2**40, size=rows)
    click = rng.integers(0, 2, size=rows)
    day = rng.integers(21, 31, size=rows)
    hour = rng.integers(0, 24, size=rows)
    cats = rng.integers(0, 2**24, size=(rows, 21))
    lines = ["id,click,hour," + ",".join(f"C{i}" for i in range(21))]
    for r in range(rows):
        lines.append(",".join(
            [format(ident[r], "x"), str(click[r]), f"1410{day[r]:02d}{hour[r]:02d}"]
            + [format(x, "06x") for x in cats[r]]))
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="host reader rows/s at several thread counts")
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--threads", default="1,2,4,8")
    ap.add_argument("--batch", type=int, default=32768)
    args = ap.parse_args(argv)

    from cffm_tpu_torch.config import get_config
    from cffm_tpu_torch.data import native
    from cffm_tpu_torch.data.prehash import convert
    from cffm_tpu_torch.data.prehashed import prehashed_batches
    from cffm_tpu_torch.data.readers import criteo_batches_native_mt

    if not native.available():
        print(json.dumps({"metric": "input_rows_per_s", "value": 0,
                          "error": "native parser unavailable (no g++)"}))
        return 1

    cfg = get_config("criteo_kaggle").model
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "criteo.tsv")
        t0 = time.perf_counter()
        _write_criteo(path, args.rows)
        size = os.path.getsize(path)
        sys.stderr.write(f"wrote {size / 1e6:.0f} MB in {time.perf_counter() - t0:.1f}s\n")

        best = (0.0, 0)
        for nt in [int(x) for x in args.threads.split(",")]:
            it = criteo_batches_native_mt(path, cfg, args.batch, repeat=True,
                                          num_threads=nt)
            next(it)  # warm: threads up, first chunks parsed
            n_rows = 0
            t0 = time.perf_counter()
            while n_rows < args.rows:
                n_rows += len(next(it)[0])
            rate = n_rows / (time.perf_counter() - t0)
            it.close()
            print(json.dumps({"metric": "input_rows_per_s", "threads": nt, "value": rate,
                              "mb_per_s": size / 1e6 * rate / args.rows}), flush=True)
            if rate > best[0]:
                best = (rate, nt)

        # pre-hashed: the parse is paid once at conversion, and reads are
        # row-slice copies out of a memory map
        cfb = os.path.join(d, "criteo.cfb")
        t0 = time.perf_counter()
        n_conv = convert(path, cfb, cfg, "criteo", chunk=args.batch)
        conv_rate = n_conv / (time.perf_counter() - t0)
        it = prehashed_batches(cfb, cfg, args.batch, shuffle=True)
        next(it)
        n_rows, t0 = 0, time.perf_counter()
        while n_rows < args.rows:
            n_rows += len(next(it)[0])
        rate = n_rows / (time.perf_counter() - t0)
        print(json.dumps({"metric": "input_rows_per_s_prehashed", "value": rate,
                          "convert_rows_per_s": conv_rate}), flush=True)
        if rate > best[0]:
            best = (rate, 0)

    print(json.dumps({"metric": "input_rows_per_s_best", "value": best[0],
                      "unit": "rows/s", "threads": best[1]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

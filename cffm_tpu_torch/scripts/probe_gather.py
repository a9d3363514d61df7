"""Is a row gather on the card bound by bandwidth or by the row count?

    python -m cffm_tpu_torch.scripts.probe_gather [--rows=2600832]
        [--take=1277952] [--widths=128,320,640] [--dtypes=float32,bfloat16]

The port's counterpart of `scripts/probe_gather.py`: the gather of
criteo_kaggle's bench batch (1,277,952 = 39 x 32768 sorted row ids out of
a 2,600,832-row table) through the port's own row gather
(`ops.embed_lookup.take_rows`, as the batch-major route gathers) at several row
widths and dtypes. One JSON line per (dtype, width): ms per call (CUDA
events over 10 calls after a warm one), the bytes moved (each taken row
read once and written once), GB/s, the bound (those bytes over the card's
3.35 TB/s) and the share of the bound reached. Then one line per dtype
with the time's growth from the narrowest to the widest row against the
width's: a gather whose time grows at least half as fast as its width is
bound by bandwidth, one whose time stays flat by the row count. Then the
card. Exits nonzero without a CUDA card; `gather_line` takes `device`.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def bytes_moved(take: int, width: int, dtype: torch.dtype) -> int:
    """Each taken row read once and written once."""
    return take * width * torch.tensor([], dtype=dtype).element_size() * 2


def bound_ms(nbytes: int) -> float:
    return nbytes / PEAK_BYTES_PER_S * 1e3


def operands(rows: int, take: int, width: int, dtype: torch.dtype, device="cuda"):
    """(table (rows, width) of unit normals in dtype, ids (take,) int32 sorted)."""
    gen = torch.Generator(device=device).manual_seed(0)
    table = torch.randn((rows, width), generator=gen, device=device).to(dtype)
    gen.manual_seed(1)
    ids = torch.randint(0, rows, (take,), generator=gen, device=device,
                        dtype=torch.int32).sort().values
    return table, ids


def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The port's row gather (`ops.embed_lookup.take_rows`)."""
    from cffm_tpu_torch.ops.embed_lookup import take_rows

    return take_rows(table, ids)


def gather_line(rows: int, take: int, width: int, dtype: torch.dtype, device="cuda",
                n: int = 10) -> dict:
    """One probe: the gather's ms, bytes, GB/s, bound and share."""
    from cffm_tpu_torch.utils.timing import time_per_call

    table, ids = operands(rows, take, width, dtype, device)
    sec = time_per_call(gather, table, ids, n=n, device=device)
    nbytes = bytes_moved(take, width, dtype)
    bound = bound_ms(nbytes)
    return {"metric": "gather_ms", "width": width, "dtype": str(dtype).removeprefix("torch."),
            "value": sec * 1e3, "bytes": nbytes, "gb_per_s": nbytes / sec / 1e9,
            "bound_ms": bound, "bound_share": bound / (sec * 1e3)}


def scaling_line(lines: list) -> dict:
    """Growth of the time from the narrowest to the widest row over the
    width's growth: near 1 bound by bandwidth, near 0 by the row count."""
    lo, hi = min(lines, key=lambda r: r["width"]), max(lines, key=lambda r: r["width"])
    growth = (hi["value"] / lo["value"]) / (hi["width"] / lo["width"])
    return {"metric": "gather_scaling", "dtype": lo["dtype"],
            "widths": [lo["width"], hi["width"]], "time_growth_over_width_growth": growth,
            "bound_by": "bandwidth" if growth >= 0.5 else "row count"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2_600_832)
    ap.add_argument("--take", type=int, default=1_277_952)  # 39 * 32768
    ap.add_argument("--widths", default="128,320,640")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_gather: no CUDA device", file=sys.stderr)
        return 1
    from cffm_tpu_torch.bench import card_line

    for name in args.dtypes.split(","):
        dtype = getattr(torch, name)
        lines = []
        for w in (int(x) for x in args.widths.split(",")):
            lines.append(gather_line(args.rows, args.take, w, dtype))
            print(json.dumps(lines[-1]), flush=True)
            torch.cuda.empty_cache()
        print(json.dumps(scaling_line(lines)), flush=True)
    print(f"card: {card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

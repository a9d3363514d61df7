"""Time the touched-row apply (kernels 4-5, kernel 7 at nb = 1 beside them) on the card.

    python -m cffm_tpu_torch.scripts.bench_apply [--shape=zipf|bench|both] [--reps=20]

Two shapes, each the big-field rows of one criteo_kaggle batch at
B=65536 through the per-field sort and kernel 3, with gradients of 0.01
times unit normals in bf16:

  zipf   chip_smoke.py's train batch (the synthetic zipf stream, 135,762
         touched rows) on an f32 table: kernel 4 adagrad and sgd, kernel 5
         (rowwise_adam), and kernel 7 at nb = 1 (adagrad) on the same uids
         and gsum, the yardstick kernel 4 should not lose to;
  bench  the bench twin's (`python -m cffm_tpu_torch.bench --feed=staged`:
         bench.py's uniform ids, ~1.25M touched rows) on a bf16 table with
         stochastic rounding: kernel 4 adagrad.

One line per timing (CUDA events, ms per call) with its bound, then the
card. It imports whichever `cffm_tpu_torch` comes first on the path, so
it also times another checkout's kernels, e.g. the parent commit's:
`PYTHONPATH=<checkout> python <path of this file>`. Exits nonzero
without a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12  # outside the tensor cores


def bound_ms(nbytes: float, ops: float) -> tuple:
    """(ms, "bytes" or "operations"): the larger of bytes over the memory
    rate and f32 operations over their peak rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def apply_bytes(m_pad: int, rows: int, w: int, table_bytes: int, mode: str) -> int:
    """Bytes the apply must move: the uids once, each touched row's bf16
    gradient, its table row read and written, its state read and written
    (m rows for rowwise_adam, a scalar for adagrad and rowwise_adam)."""
    nbytes = m_pad * 4 + rows * w * 2 + rows * w * table_bytes * 2
    if mode == "rowwise_adam":
        nbytes += rows * w * 4 * 2
    return nbytes + (rows * 4 * 2 if mode != "sgd" else 0)


def apply_inputs(shape: str, device="cuda", seed: int = 6, batch: int = 65536) -> dict:
    """The apply's inputs at `shape` ("zipf" or "bench") and `batch`: uids
    (M,) with the sentinel V, gsum (M, W) bf16, the touched rows, V and W."""
    from cffm_tpu_torch.config import get_config
    from cffm_tpu_torch.models.cffm import field_offsets
    from cffm_tpu_torch.ops import sorted_segment as ss
    from cffm_tpu_torch.ops import streamed_update as su
    from cffm_tpu_torch.optim.rowwise import _per_field_sorted, unique_bound

    cfg = get_config("criteo_kaggle")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=batch))
    if shape == "zipf":
        from cffm_tpu_torch.data.loader import make_dataset

        ids = next(make_dataset(cfg, prefetch=0))["ids"]
    else:
        from cffm_tpu_torch.bench import staged_batch

        ids = staged_batch(cfg)["ids"]
    mcfg = cfg.model
    fs, w, v = mcfg.small_field_prefix, mcfg.table_width, mcfg.total_vocab
    offs = tuple(int(o) for o in field_offsets(mcfg))[fs:]
    ids_fm = torch.from_numpy(ids).to(device).t()[fs:]
    sid, _ = _per_field_sorted(ids_fm.reshape(-1), offs, False, True)
    n = sid.numel()
    gen = torch.Generator(device=device).manual_seed(seed)
    grads = (torch.randn((n, w), generator=gen, device=device) * 0.01).to(torch.bfloat16)
    m_pad = su.padded_entries(min(n, unique_bound(mcfg.vocab_sizes[fs:], batch)),
                              su.pick_tile(v))
    uids, gsum, count = ss.sorted_segment_sum_compact(sid, grads, m_pad)
    del grads
    uids_s = torch.where(torch.arange(m_pad, device=device) < count, uids, v).to(torch.int32)
    return {"uids": uids_s, "gsum": gsum, "rows": int(count), "v": v, "w": w}


def time_zipf(x: dict, reps: int) -> dict:
    """Kernel 4 adagrad and sgd, kernel 5 and kernel 7 at nb = 1 on an f32
    table: {name: (ms, bound ms)}."""
    from cffm_tpu_torch.ops import streamed_update as su
    from cffm_tpu_torch.utils.timing import device_time

    uids, gsum, rows, v, w = x["uids"], x["gsum"], x["rows"], x["v"], x["w"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    table = torch.randn((v, w), generator=gen, device="cuda") * 0.01
    accum = torch.full((v, 1), 0.1, device="cuda")
    m_pad = uids.numel()
    out = {}
    calls = {
        "kernel4_adagrad": (lambda: su.streamed_rowwise_apply(table, accum, uids, gsum, 1e-9,
                                                              1e-8), "adagrad"),
        "kernel4_sgd": (lambda: su.streamed_rowwise_apply(table, None, uids, gsum, 1e-9, 1e-8),
                        "sgd"),
        "kernel7_nb1_adagrad": (lambda: su.bucketed_rowwise_apply(
            table, accum, uids[None], gsum[None], 1e-9, 1e-8), "adagrad"),
    }
    for name, (fn, mode) in calls.items():
        out[name] = (device_time(fn, n=reps) * 1e3,
                     bound_ms(apply_bytes(m_pad, rows, w, 4, mode), rows * w * 6)[0])
    mom = torch.zeros((v, w), device="cuda")
    vv = torch.zeros((v, 1), device="cuda")
    out["kernel5_rowwise_adam"] = (
        device_time(lambda: su.streamed_rowwise_adam_apply(table, mom, vv, uids, gsum, 1e-9,
                                                           1e-8, 0.9, 0.999, 1), n=reps) * 1e3,
        bound_ms(apply_bytes(m_pad, rows, w, 4, "rowwise_adam"), rows * w * 10)[0])
    return out


def time_bench(x: dict, reps: int) -> dict:
    """Kernel 4 adagrad on a bf16 table with stochastic rounding:
    {name: (ms, bound ms)}."""
    from cffm_tpu_torch.ops import streamed_update as su
    from cffm_tpu_torch.utils.timing import device_time

    uids, gsum, rows, v, w = x["uids"], x["gsum"], x["rows"], x["v"], x["w"]
    gen = torch.Generator(device="cuda").manual_seed(8)
    table = (torch.randn((v, w), generator=gen, device="cuda") * 0.01).to(torch.bfloat16)
    accum = torch.full((v, 1), 0.1, device="cuda")
    ms = device_time(lambda: su.streamed_rowwise_apply(table, accum, uids, gsum, 1e-9, 1e-8,
                                                       sr_seed=1234), n=reps) * 1e3
    return {"kernel4_adagrad_bf16_sr": (
        ms, bound_ms(apply_bytes(uids.numel(), rows, w, 2, "adagrad"), rows * w * 6)[0])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="both", choices=("zipf", "bench", "both"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_apply: no CUDA device", file=sys.stderr)
        return 1
    from cffm_tpu_torch.bench import card_line

    for shape, timer in (("zipf", time_zipf), ("bench", time_bench)):
        if args.shape not in (shape, "both"):
            continue
        x = apply_inputs(shape)
        for name, (ms, bound) in timer(x, args.reps).items():
            print(f"bench_apply {shape} {name}: {ms:.4f} ms, bound {bound:.4f} ms "
                  f"({bound / ms:.1%}), touched rows {x['rows']} of {x['uids'].numel()} slots",
                  flush=True)
        del x
        torch.cuda.empty_cache()
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

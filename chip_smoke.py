#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases=name,...]

Run from the root of a checkout. Needs one CUDA card and nvcc; exits
nonzero without them, or when any phase fails. Phases, in order:

  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ops/csrc (one nvcc each, in parallel);
  3. parity: hold each forward entry against its plain PyTorch version on
     the card: criteo_kaggle shapes at B=4096 for the split field-major,
     field-major and flat full-rows entries, movielens shapes for the
     sliced field-aware and hadamard entries (and field-aware at d=8,
     which takes the CUDA-core kernels in bf16 too); f32 (TF32 off) at
     rtol=atol=1e-4 and bf16 at rtol=atol=2e-2, lin at 1e-5; the sliced
     entry in bf16 at k and C1 that give the tensor-core kernel 1 to 7
     m-tiles; the split field-major entry in bf16 at B = 1, 7, 8, 131,
     4097 and 65536, y and lin bit-equal in two runs;
  4. parity_bwd: the same entries' backward (kernel 2, through autograd)
     against the plain backward: dE f32 rtol=atol=1e-4, bf16 2e-2; dW
     rtol=1e-4 with atol 1e-4 of max|dW|; pad lanes and diagonal blocks of
     dE exact zeros, the fused column exactly glin; dW bit-equal in two runs;
     then the tensor-core (wgmma) kernel's edges through the split
     field-major entry in bf16, each with those checks: B = 1, 7, 8, 131,
     4097, 65536; (k, C1) giving every m-tile count 1-7 of its tap window
     and C1 up to 128 at k=3 (BWD_WIDTHS) at B=4096; an odd split nf0=7
     at B=4097;
  4b. parity_caps: the overrides past the named configs' shapes, each on
     the card and held against the plain version, its route printed from
     the launch counts: a bucketed adagrad update of a (100000, 2560)
     table (kernel 7's gate sends it to kernels 3-4; against kernel 7's
     plain version: table steps within 1% of the largest step, accum
     within 2^-6 relative; rows outside the buckets bit-equal); through the
     split field-major entry at B=4096 with the phase-4 tolerances, C1=128
     in bf16 (kernel 1, kernel 2 on wgmma) and in f32 (kernel 2 on the
     CUDA cores) and k=9 in bf16 (kernels 1 and 2 on the CUDA cores);
     C1=128 sliced hadamard in bf16; k=9 layer 1 and conv tail, forward
     and backward at B=4096 in f32 through kernels 1 and 2 against the
     plain route in float64 (1e-4 of the largest value); the gates' CPU
     rules equal the libraries' (kernel 7's width, and bwd_kernel_takes
     over 216 (d, k, C1, cross));
  5. parity_segment: kernel 3 on the sorted big-field ids of one B=65536
     synthetic criteo_kaggle batch (zipf, hot segments) and on ids up to
     2^31-2: uids and count exact, empty slots zero, gsum within half a
     bf16 ulp of the exact (f64) sums plus 4 * 2^-24 * sqrt(len * sum g^2)
     for the f32 sum's own error;
  6. parity_apply: kernels 4 and 5 on the full 2.6M x 640 table with that
     batch's uids and sums, f32 and bf16: rows outside uids bit-equal;
     touched rows within 1e-6 (f32) or one bf16 ulp (nearest); stochastic
     rounding within one ulp of nearest with a mean signed error near 0;
  7. serve criteo_kaggle at full width through cffm_tpu_torch.score:
     the 2.6M x 640 f32 table on the card, random params from a fixed
     generator, 8 val batches of 4096; check finite metrics, the count,
     one kernel launch per batch, and the kernel route's logits against
     the reference route's in f32 on one batch;
  8. time the forward kernel, its plain version, torch's conv1d on an
     already built cross map and build_cross_map + conv1d together (CUDA
     events) at B=4096 and B=65536, split one call at B=4096 into the
     kernel's device time and the wrapper's preparation (profiler), hold the
     kernel against its plain version at B=65536 (bf16, 2e-2), and time the
     forward end to end at B=65536;
  9. train criteo_kaggle at full width through cffm_tpu_torch.train.run:
     B=65536 for 3 steps (adagrad, f32 table), 2 steps with a bf16 table
     (stochastic rounding) and 2 steps of rowwise_adam, launch counts set
     to 0 before and read after each run; finite loss and AUC;
 10. step_vs_cpu: train steps from the same state and batches on the card
     and on the CPU (f32, f32 table, streamed update on, B=4096): one
     adagrad step, two rowwise-Adam steps;
 11. time kernels 2-5, their plain versions, library yardsticks and bounds
     at the B=65536 training shapes (kernel 2 at B=4096 too), hold kernel
     2 against its plain version there (the phase-4 checks), and time the
     train step end to end with a torch.profiler breakdown;
 12. parity_segment_by_seg: kernel 6 on the segment stream of one B=65536
     batch routed at T=1 and on rank 0's at T=4: within half a bf16 ulp of
     the exact sums plus the f32 term (phase 5's limit), slots past the
     count exact zeros, and against its plain version;
 13. parity_bucketed: kernel 7 on rank 0's table shard and the buckets its
     peers send it for that batch at T=1 (the full table), 4 and 8 (rows
     in several buckets): adagrad, sgd with a clip and rowwise_adam on f32
     tables (1e-6), adagrad on bf16 tables (nearest within one ulp,
     stochastic within one ulp of nearest), NaN in every sentinel slot's
     grads, rows outside the buckets bit-equal; first the edge cases (a
     row in all 8 buckets and rows 0 and V-1, an all-sentinel bucket, no
     live slot at all) on f32 tables, each against the plain version,
     bit-equal in two runs and bit-equal to the results the replaced
     warp-per-slot kernel gave (their sha256 in K7_F32_DIGESTS);
 14. train_sharded: criteo_kaggle with the row-sharded table at full width
     through make_sharded_train_step on an NCCL group of one, B=65536: 3
     adagrad steps (f32 table), 2 with a bf16 table (stochastic rounding),
     2 of rowwise_adam, each with 2 sharded eval batches, launch counts
     set to 0 before and read after each run (kernels 1, 2, 6 and 7 once
     per step), no overflow, finite losses and AUC; then one adagrad step
     against the single-device train_step from the same state and batch;
 15. sharded_multi: with more than one card, the sharded step on
     min(cards, 4) NCCL ranks against the single-device step (two adagrad
     steps); with one card it prints that it was not run;
 16. time kernels 6 and 7 at the T=1 and T=4 rank-0 shapes (kernel, plain,
     library yardstick: index_add_ of the sgd step, beside the kernel in
     sgd mode; bound) and the sharded step end to end with a
     torch.profiler breakdown;
 17. parity_bwd_v1: kernel 8a (ops.bwd_variants.bwd_v1) at criteo_kaggle
     shapes against its plain version and against kernel 2 (bwd_v0), and
     row 8b (bwd_v2, kernel 2 from the variants' weights) against the
     plain version: B=512 in f32 (the CUDA-core kernels), B=4096 and 65536
     in bf16 (tensor cores), and kernel 8a alone at C1=72 in bf16, B=512
     (its bf16 CUDA-core kernel, at the phase-4 tolerances); bf16 dE
     within one bf16 ulp of the product plus two ulps of the product
     taken from |E|, |W|, |g| (and at the phase-4 tolerances; f32 at
     rtol=atol=1e-4 against kernel 2), dW at 1e-4 of
     max|dW|, pad lanes, diagonal blocks and dW's pad rows exact zeros, the
     fused column exactly glin, dW bit-equal in two runs; then kernel 8a
     and kernel 2 in the variants' layout (row 8b) timed at B=65536;
 18. parity_dot_probe: kernel 9's three modes against the plain version at
     the probe's shapes (rtol 1e-5, atol 1e-5 of max|out|), timed with
     TMAC/s, torch.matmul as the yardstick;
 19. tools: main(argv) of `python -m cffm_tpu_torch.bench` (--feed=staged,
     score, sharded), of the scripts bench_kernel, bench_bwd_variants
     --check, probe_dot_orient, profile_step full and trace_step, in
     process, launch counts set to 0 before and read after each: exit code
     0, each kernel of its path launched, and each bench line with a value
     and the card.

Prints one JSON line of kernel records, then the card line, and ends
with {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate
# and arithmetic rates by operand type, for the bound of each kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
KERNEL_SOURCES = ["cross_conv1_fwd", "cross_conv1_bwd", "sorted_segment",
                  "streamed_update", "cross_conv1_bwd_v1", "dot_orient_probe"]


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _criteo_model(dtype: str):
    from cffm_tpu_torch.config import get_config

    return dataclasses.replace(get_config("criteo_kaggle").model, compute_dtype=dtype)


def _movielens_model(cross: str, dtype: str, d: int = 16):
    from cffm_tpu_torch.config import get_config

    return dataclasses.replace(get_config("movielens").model, cross=cross,
                               compute_dtype=dtype, embed_dim=d)


# movielens sliced cases (cross, embed_dim): bf16 rows with d=16 take the
# tensor-core kernels (the backward's hadamard form excepted); d=8 holds
# the bf16 CUDA-core kernels, which take every other shape
MOVIELENS_CASES = (("field_aware", 16), ("hadamard", 16), ("field_aware", 8))


def _inputs(cfg, b: int, dtype, gen, fm_split: int | None = None):
    """Unit-scale random kernel inputs: rows and the layer-1 weight."""
    import torch

    c1 = cfg.conv_channels[0]
    w1 = torch.randn((c1, cfg.num_pairs, cfg.conv_kernel), generator=gen,
                     device="cuda") * math.sqrt(2.0 / (cfg.num_pairs * cfg.conv_kernel))
    if fm_split is None:
        shape = ((b, cfg.num_fields, cfg.num_fields, cfg.embed_dim)
                 if cfg.cross == "field_aware" else (b, cfg.num_fields, cfg.embed_dim))
        return torch.randn(shape, generator=gen, device="cuda").to(dtype), w1
    e = torch.randn((cfg.num_fields, b, cfg.table_width), generator=gen,
                    device="cuda").to(dtype)
    return (e[:fm_split].contiguous(), e[fm_split:].contiguous()), w1


def phase_parity() -> float:
    """Every entry against its plain version; returns the fm2 bf16 error."""
    import torch

    from cffm_tpu_torch.ops import interaction_conv as ic

    gen = torch.Generator(device="cuda").manual_seed(1)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    fm2_err = float("nan")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        cfg = _criteo_model(name)
        fs = cfg.small_field_prefix
        (es, eb), w1 = _inputs(cfg, 4096, dtype, gen, fm_split=fs)
        e3 = torch.cat([es, eb])
        flat = e3.transpose(0, 1).contiguous()
        y_ref, lin_ref = ic._rows_reference(flat, w1, cfg)
        cases = [
            ("fm2", ic.cross_conv1_lin_fm2(es, eb, w1, cfg)),
            ("fm", ic.cross_conv1_lin_fm(e3, w1, cfg)),
            ("flat", ic.cross_conv1_lin(flat.reshape(4096, -1), w1, cfg)),
        ]
        for case, (y, lin) in cases:
            err = (y.float() - y_ref.float()).abs().max().item()
            lerr = (lin - lin_ref).abs().max().item()
            print(f"parity criteo_kaggle {case} {name} B=4096: y max_abs_err={err:.3e} "
                  f"(rtol=atol={tol[dtype]}, max|y|={y_ref.abs().max().item():.3f}) "
                  f"lin max_abs_err={lerr:.3e} (atol=1e-5)",
                  flush=True)
            torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol[dtype],
                                       atol=tol[dtype])
            torch.testing.assert_close(lin, lin_ref, rtol=0.0, atol=1e-5)
            if case == "fm2" and dtype == torch.bfloat16:
                fm2_err = err
        del es, eb, e3, flat
        for cross, d in MOVIELENS_CASES:
            mcfg = _movielens_model(cross, name, d)
            emb, w1 = _inputs(mcfg, 4096, dtype, gen)
            y = ic.cross_conv1(emb, w1, mcfg)
            y_ref = ic.cross_conv1_reference(emb, w1, mcfg)
            err = (y.float() - y_ref.float()).abs().max().item()
            print(f"parity movielens sliced {cross} d={d} {name} B=4096: y max_abs_err="
                  f"{err:.3e} (rtol=atol={tol[dtype]}, "
                  f"max|y|={y_ref.abs().max().item():.3f})", flush=True)
            torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol[dtype],
                                       atol=tol[dtype])
    return max(fm2_err, _parity_widths(gen), _parity_batches(gen))


# (conv width k, C1) beyond the configs' k=3: every m-tile count 1-7 of the
# tensor-core kernel's k*C1 stacked weight rows
PARITY_WIDTHS = ((1, 64), (5, 48), (5, 64), (7, 48), (7, 64))


def _parity_widths(gen) -> float:
    """The sliced field-aware bf16 entry (movielens, d=16) at PARITY_WIDTHS
    against its plain version (rtol=atol=2e-2), B=1000."""
    import torch

    from cffm_tpu_torch.ops import interaction_conv as ic

    worst = 0.0
    for k, c1 in PARITY_WIDTHS:
        cfg = dataclasses.replace(_movielens_model("field_aware", "bfloat16"), conv_kernel=k,
                                  conv_channels=(c1, c1))
        emb, w1 = _inputs(cfg, 1000, torch.bfloat16, gen)
        y = ic.cross_conv1(emb, w1, cfg)
        y_ref = ic.cross_conv1_reference(emb, w1, cfg)
        err = (y.float() - y_ref.float()).abs().max().item()
        print(f"parity movielens sliced field_aware k={k} C1={c1} bfloat16 B=1000: y "
              f"max_abs_err={err:.3e} (rtol=atol=2e-2, max|y|={y_ref.abs().max().item():.3f})",
              flush=True)
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=2e-2, atol=2e-2)
        worst = max(worst, err)
    return worst


# batches of the split field-major bf16 entry: one example, ragged tiles
# of the tensor-core kernel's 8-example tiles, more tiles than SMs
PARITY_BATCHES = (1, 7, 8, 131, 4097, 65536)


def _parity_batches(gen) -> float:
    """The split field-major bf16 entry at PARITY_BATCHES against its plain
    version (rtol=atol=2e-2, lin 1e-5), y and lin bit-equal in two runs.
    Returns the largest y error."""
    import torch

    from cffm_tpu_torch.ops import interaction_conv as ic

    cfg = _criteo_model("bfloat16")
    worst = 0.0
    for b in PARITY_BATCHES:
        (es, eb), w1 = _inputs(cfg, b, torch.bfloat16, gen, fm_split=cfg.small_field_prefix)
        y, lin = ic.cross_conv1_lin_fm2(es, eb, w1, cfg)
        y2, lin2 = ic.cross_conv1_lin_fm2(es, eb, w1, cfg)
        y_ref, lin_ref = ic._rows_reference(torch.cat([es, eb]).transpose(0, 1), w1, cfg)
        err = (y.float() - y_ref.float()).abs().max().item()
        lerr = (lin - lin_ref).abs().max().item()
        same = torch.equal(y, y2) and torch.equal(lin, lin2)
        print(f"parity criteo_kaggle fm2 bfloat16 B={b}: y max_abs_err={err:.3e} (rtol=atol="
              f"2e-2, max|y|={y_ref.abs().max().item():.3f}) lin max_abs_err={lerr:.3e} "
              f"(atol=1e-5), two runs bit-equal: {same}", flush=True)
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(lin, lin_ref, rtol=0.0, atol=1e-5)
        if not same:
            fail(f"parity fm2 B={b}: two runs differ")
        worst = max(worst, err)
        del es, eb, y, y2, y_ref
        torch.cuda.empty_cache()
    return worst


def phase_serve():
    """Serve criteo_kaggle at full width; returns (launches, params, cfg)."""
    import torch

    from cffm_tpu_torch import score as score_lib
    from cffm_tpu_torch.config import get_config
    from cffm_tpu_torch.data.loader import make_dataset
    from cffm_tpu_torch.models.cffm import forward, init_params
    from cffm_tpu_torch.ops import interaction_conv as ic
    from cffm_tpu_torch.train import batch_to_device

    cfg = get_config("criteo_kaggle")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg.model, gen)
    table = params["embed"]["table"]
    print(f"serve: table {tuple(table.shape)} {table.dtype} "
          f"{table.numel() * table.element_size() / 1e9:.2f} GB on {table.device}",
          flush=True)

    n_batches = 8
    torch.cuda.synchronize()
    ic.reset_launches()
    t0 = time.perf_counter()
    result = score_lib.score(cfg, params, num_batches=n_batches, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ic.ENTRIES}
    print(f"serve: {json.dumps(result)} launches={launches} "
          f"wall={wall:.3f}s ({result['count'] / wall:.1f} ex/s incl. data)", flush=True)
    for key in ("auc", "logloss", "calibration"):
        if not math.isfinite(result[key]):
            fail(f"serve: {key} is not finite: {result[key]}")
    if result["count"] != n_batches * cfg.data.batch_size:
        fail(f"serve: count {result['count']} != {n_batches * cfg.data.batch_size}")
    if launches["cross_conv1_lin_fm2"] != n_batches or sum(launches.values()) != n_batches:
        fail(f"serve: want one cross_conv1_lin_fm2 launch per batch, got {launches}")

    # the kernel route against the reference route, f32 compute, one batch
    f32 = dataclasses.replace(cfg.model, compute_dtype="float32")
    batch = next(make_dataset(cfg, split="val", prefetch=0))
    ids, dense, _ = batch_to_device(batch, torch.device("cuda"))
    with torch.inference_mode():
        got = forward(params, ids, dense, f32, interaction_fn=ic.make_interaction_fn())
        ref = forward(params, ids, dense, f32, interaction_fn=None)
    err = (got - ref).abs().max().item()
    print(f"serve: f32 logits kernel route vs reference route max_abs_err={err:.3e} "
          f"(rtol=atol=1e-4), logits in [{ref.min().item():.4f}, {ref.max().item():.4f}]",
          flush=True)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    return launches["cross_conv1_lin_fm2"], params, cfg


def _fwd_split(es, eb, w1, mcfg, reps: int = 20) -> dict:
    """Device time of one cross_conv1_lin_fm2 call split by the profiler
    into the forward kernel's own time and the wrapper's preparation (the
    weight layout and any other device op of the call), in ms per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cffm_tpu_torch.ops import interaction_conv as ic

    for _ in range(2):
        ic.cross_conv1_lin_fm2(es, eb, w1, mcfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ic.cross_conv1_lin_fm2(es, eb, w1, mcfg)
        torch.cuda.synchronize()
    kernel = prep = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "cross_conv1_fwd" in e.key:
            kernel += e.self_device_time_total
        else:
            prep += e.self_device_time_total
    return {"kernel_ms": kernel / 1e3 / reps, "prep_ms": prep / 1e3 / reps}


def phase_time(params, cfg) -> dict:
    """Kernel, plain version and library conv at B=4096 and 65536 (bf16,
    criteo_kaggle fm2 shapes), the kernel held against the plain version at
    65536 (the training batch), and forward end to end at 65536."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from cffm_tpu_torch.models.cffm import field_offsets, forward
    from cffm_tpu_torch.ops import interaction_conv as ic
    from cffm_tpu_torch.ops.cross import build_cross_map

    mcfg = _criteo_model("bfloat16")
    fs = mcfg.small_field_prefix
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for b in (4096, 65536):
        (es, eb), w1 = _inputs(mcfg, b, torch.bfloat16, gen, fm_split=fs)
        rows = torch.cat([es, eb]).transpose(0, 1)
        reps = 20 if b == 4096 else 5
        ms = cuda_ms(lambda: ic.cross_conv1_lin_fm2(es, eb, w1, mcfg), reps)
        plain_ms = cuda_ms(lambda: ic._rows_reference(
            torch.cat([es, eb]).transpose(0, 1), w1, mcfg), reps)
        if b == 65536:
            y, lin = ic.cross_conv1_lin_fm2(es, eb, w1, mcfg)
            y_ref, lin_ref = ic._rows_reference(rows, w1, mcfg)
            out["max_abs_err_65536"] = err = (y.float() - y_ref.float()).abs().max().item()
            lerr = (lin - lin_ref).abs().max().item()
            print(f"parity criteo_kaggle fm2 bfloat16 B={b}: y max_abs_err={err:.3e} "
                  f"(rtol=atol=2e-2, max|y|={y_ref.abs().max().item():.3f}) lin "
                  f"max_abs_err={lerr:.3e} (atol=1e-5)", flush=True)
            torch.testing.assert_close(y.float(), y_ref.float(), rtol=2e-2, atol=2e-2)
            torch.testing.assert_close(lin, lin_ref, rtol=0.0, atol=1e-5)
            del y, y_ref
        emb = rows[..., : mcfg.row_width].reshape(b, mcfg.num_fields, mcfg.num_fields,
                                                   mcfg.embed_dim)
        m = build_cross_map(emb, mcfg)
        w_b = w1.to(torch.bfloat16)
        k = mcfg.conv_kernel
        library_ms = cuda_ms(lambda: F.conv1d(m, w_b, padding=k // 2), reps)
        # like for like: what PyTorch needs for the same function
        pair_ms = cuda_ms(lambda: F.conv1d(build_cross_map(emb, mcfg), w_b, padding=k // 2), reps)
        split = _fwd_split(es, eb, w1, mcfg) if b == 4096 else None
        c1 = w1.shape[0]
        nbytes = ((es.numel() + eb.numel()) * es.element_size()
                  + w1.numel() * w1.element_size()
                  + b * c1 * mcfg.embed_dim * 2 + b * 4)
        ops = 2 * b * c1 * mcfg.embed_dim * mcfg.num_pairs * k
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
        out[b] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "build_and_conv1d_ms": pair_ms, "split": split,
                  "bound_ms": max(t_bytes, t_ops),
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                  "bytes": nbytes, "flops": ops}
        print(f"time B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"conv1d on built M (excludes M's build) {library_ms:.4f} ms, "
              f"build_cross_map + conv1d {pair_ms:.4f} ms, "
              f"bound {max(t_bytes, t_ops):.4f} ms ({out[b]['bound_by']}: "
              f"{nbytes / 1e9:.3f} GB, {ops / 1e9:.1f} GFLOP)"
              + ("" if split is None else
                 f"; profiler per call: kernel {split['kernel_ms']:.4f} ms, wrapper's "
                 f"preparation {split['prep_ms']:.4f} ms"), flush=True)
        del es, eb, rows, m, emb
        torch.cuda.empty_cache()

    b = 65536
    model = cfg.model
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(
        np.stack([rng.integers(0, v, size=b) for v in model.vocab_sizes], axis=1)
        .astype(np.int32) + field_offsets(model)[None, :].astype(np.int32)).cuda()
    dense = torch.from_numpy(rng.normal(size=(b, model.num_dense)).astype(np.float32)).cuda()
    fn = ic.make_interaction_fn()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: forward(params, ids, dense, model, interaction_fn=fn), 5)
    out["forward_ms_65536"] = fwd_ms
    print(f"time forward criteo_kaggle B={b} bf16 (uniform ids): {fwd_ms:.3f} ms = "
          f"{b / fwd_ms * 1e3:.1f} ex/s", flush=True)

    # where the forward's device time goes: device kernels by self time
    from torch.profiler import ProfilerActivity, profile

    reps = 3
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            forward(params, ids, dense, model, interaction_fn=fn)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    print(f"profile forward B={b}: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"wall per forward (idle share {1 - busy_ms / wall_ms:.3f}, profiler on)",
          flush=True)
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        ms = e.self_device_time_total / 1e3 / reps
        print(f"profile   {ms:8.3f} ms {ms / busy_ms:6.1%} x{e.count // reps} "
              f"{e.key[:90]}", flush=True)
    return out


def _bound(nbytes: float, ops: float, kind: str = "bfloat16") -> dict:
    """Least time for the work: max(bytes / memory rate, ops / peak rate)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def _grad_rows(ic, cfg, entry: str, es, eb, w1, gy, glin):
    """dE (B, F, W) and dW through one full-rows entry's autograd."""
    import torch

    w = w1.detach().requires_grad_()
    if entry == "fm2":
        parts = [es.detach().requires_grad_(), eb.detach().requires_grad_()]
        y, lin = ic.cross_conv1_lin_fm2(parts[0], parts[1], w, cfg)
    elif entry == "fm":
        parts = [torch.cat([es, eb]).requires_grad_()]
        y, lin = ic.cross_conv1_lin_fm(parts[0], w, cfg)
    else:
        b = es.shape[1]
        parts = [torch.cat([es, eb]).transpose(0, 1).reshape(b, -1).contiguous()
                 .requires_grad_()]
        y, lin = ic.cross_conv1_lin(parts[0], w, cfg)
    *dparts, dw = torch.autograd.grad((y, lin), (*parts, w), (gy, glin))
    if entry == "flat":
        drows = dparts[0].reshape(es.shape[1], cfg.num_fields, -1)
    else:
        drows = torch.cat(dparts).transpose(0, 1)
    return drows, dw


def _check_dw(dw, dw_ref, what: str) -> float:
    import torch

    err = (dw - dw_ref).abs().max().item()
    scale = dw_ref.abs().max().item()
    print(f"parity_bwd {what}: dW max_abs_err={err:.3e} (rtol=1e-4, atol=1e-4*"
          f"max|dW|={1e-4 * scale:.3e})", flush=True)
    torch.testing.assert_close(dw, dw_ref, rtol=1e-4, atol=1e-4 * scale)
    return err


def _check_rows_grad(drows, drows_ref, dw, dw_ref, glin, cfg, what: str) -> float:
    """A full-rows gradient (B, F, W) and dW against the plain backward:
    dE at rtol=atol 1e-4 (f32) or 2e-2 (bf16), dW at 1e-4 of max|dW|, the
    diagonal blocks and the pad lanes exact zeros, the fused column exactly
    glin. Returns the dE error."""
    import torch

    tol = 1e-4 if drows.dtype == torch.float32 else 2e-2
    rw, d = cfg.row_width, cfg.embed_dim
    err = (drows.float() - drows_ref.float()).abs().max().item()
    print(f"parity_bwd {what}: dE max_abs_err={err:.3e} (rtol=atol={tol}, max|dE|="
          f"{drows_ref.abs().max().item():.3f})", flush=True)
    torch.testing.assert_close(drows.float(), drows_ref.float(), rtol=tol, atol=tol)
    _check_dw(dw, dw_ref, what)
    diag = torch.stack([drows[:, f, f * d:(f + 1) * d] for f in range(cfg.num_fields)])
    if (diag != 0).any() or (drows[..., rw + 1:] != 0).any():
        fail(f"parity_bwd {what}: diagonal or pad lanes of dE not zero")
    if not torch.equal(drows[..., rw], glin.to(drows.dtype)[:, None].expand(-1, cfg.num_fields)):
        fail(f"parity_bwd {what}: fused column of dE is not glin")
    return err


# (conv width k, C1) of the backward's tensor-core kernel: every m-tile
# count 1-7 of its k*C1 tap-window rows, and C1 up to 128 at k=3
BWD_WIDTHS = ((1, 32), (1, 64), (3, 32), (3, 64), (3, 96), (3, 128), (5, 32), (5, 64),
              (7, 32), (7, 48), (7, 64))


def _bwd_takes_wgmma(ic, cfg, es, eb, gy) -> bool:
    """Whether the library sends these split field-major rows to the
    tensor-core backward kernel (the wrapper's own query)."""
    lib = ic._bwd_library()
    (e0, _, fs0, bs0), (e1, _, fs1, bs1) = ic._descriptors("fm2", cfg, (es, eb))
    return bool(lib.cffm_cross_conv1_bwd_wgmma(
        1, e0.data_ptr(), e1.data_ptr(), fs0, bs0, fs1, bs1, e0.data_ptr(), e1.data_ptr(),
        fs0, bs0, fs1, bs1, gy.data_ptr(), cfg.num_fields, cfg.embed_dim, cfg.conv_kernel,
        gy.shape[1], 0))


def _parity_bwd_edges(gen) -> float:
    """Kernel 2's tensor-core path through the split field-major entry in
    bf16 against the plain backward (the phase-4 checks, dW bit-equal in
    two runs): criteo_kaggle (k=3, C1=64, nf0=13) at PARITY_BATCHES, at
    BWD_WIDTHS (B=4096) and with an odd split nf0=7 (B=4097). Returns the
    largest dE error."""
    import torch

    from cffm_tpu_torch.ops import interaction_conv as ic

    base = _criteo_model("bfloat16")
    fs = base.small_field_prefix
    cases = ([(b, 3, 64, fs) for b in PARITY_BATCHES]
             + [(4096, k, c1, fs) for k, c1 in BWD_WIDTHS] + [(4097, 3, 64, 7)])
    worst = 0.0
    for b, k, c1, nf0 in cases:
        cfg = dataclasses.replace(base, conv_kernel=k, conv_channels=(c1, 64))
        (es, eb), w1 = _inputs(cfg, b, torch.bfloat16, gen, fm_split=nf0)
        gy = torch.randn((b, c1, cfg.embed_dim), generator=gen,
                         device="cuda").to(torch.bfloat16)
        glin = torch.randn((b,), generator=gen, device="cuda")
        if not _bwd_takes_wgmma(ic, cfg, es, eb, gy):
            fail(f"parity_bwd B={b} k={k} C1={c1}: not the tensor-core backward")
        n0 = ic.cross_conv1_bwd.launches
        drows, dw = _grad_rows(ic, cfg, "fm2", es, eb, w1, gy, glin)
        _, dw2 = _grad_rows(ic, cfg, "fm2", es, eb, w1, gy, glin)
        if ic.cross_conv1_bwd.launches - n0 != 2:
            fail(f"parity_bwd B={b} k={k} C1={c1}: the backward kernel was not launched")
        rows = torch.cat([es, eb]).transpose(0, 1)
        drows_ref, dw_ref = ic._rows_bwd_reference(rows, w1, gy, glin, cfg)
        err = _check_rows_grad(drows, drows_ref, dw, dw_ref, glin, cfg,
                               f"wgmma fm2 bfloat16 B={b} k={k} C1={c1} nf0={nf0}")
        if not torch.equal(dw, dw2):
            fail(f"parity_bwd B={b} k={k} C1={c1}: dW differs between two runs")
        worst = max(worst, err)
        del es, eb, rows, drows, drows_ref, dw, dw2, dw_ref
        torch.cuda.empty_cache()
    print(f"parity_bwd wgmma edges: {len(cases)} cases, dW bit-equal in two runs", flush=True)
    return worst


def phase_parity_bwd() -> float:
    """Kernel 2 through every entry against the plain backward, then the
    tensor-core kernel's edges; returns the largest bf16 dE error of the
    split field-major entry."""
    import torch

    from cffm_tpu_torch.ops import interaction_conv as ic

    gen = torch.Generator(device="cuda").manual_seed(3)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    fm2_err = float("nan")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        cfg = _criteo_model(name)
        fs, d = cfg.small_field_prefix, cfg.embed_dim
        (es, eb), w1 = _inputs(cfg, 4096, dtype, gen, fm_split=fs)
        gy = torch.randn((4096, w1.shape[0], d), generator=gen, device="cuda").to(dtype)
        glin = torch.randn((4096,), generator=gen, device="cuda")
        rows = torch.cat([es, eb]).transpose(0, 1)
        drows_ref, dw_ref = ic._rows_bwd_reference(rows, w1, gy, glin, cfg)
        for entry in ("fm2", "fm", "flat"):
            drows, dw = _grad_rows(ic, cfg, entry, es, eb, w1, gy, glin)
            err = _check_rows_grad(drows, drows_ref, dw, dw_ref, glin, cfg,
                                   f"criteo_kaggle {entry} {name} B=4096")
            if entry == "fm2":
                if dtype == torch.bfloat16:
                    fm2_err = err
                _, dw2 = _grad_rows(ic, cfg, entry, es, eb, w1, gy, glin)
                if not torch.equal(dw, dw2):
                    fail(f"parity_bwd fm2 {name}: dW differs between two runs")
        print(f"parity_bwd {name}: diagonal and pad lanes exact zeros, fused column "
              f"== glin, dW bit-equal in two runs", flush=True)
        del es, eb, rows, drows_ref
        for cross, d in MOVIELENS_CASES:
            mcfg = _movielens_model(cross, name, d)
            emb, w1 = _inputs(mcfg, 4096, dtype, gen)
            gy = torch.randn((4096, w1.shape[0], mcfg.embed_dim), generator=gen,
                             device="cuda").to(dtype)
            e = emb.detach().requires_grad_()
            w = w1.detach().requires_grad_()
            de, dw = torch.autograd.grad(ic.cross_conv1(e, w, mcfg), (e, w), gy)
            de_ref, dw_ref = ic.cross_conv1_bwd_reference(emb, w1, gy, mcfg)
            err = (de.float() - de_ref.float()).abs().max().item()
            print(f"parity_bwd movielens sliced {cross} d={d} {name} B=4096: dE "
                  f"max_abs_err={err:.3e} (rtol=atol={tol[dtype]})", flush=True)
            torch.testing.assert_close(de.float(), de_ref.float(), rtol=tol[dtype],
                                       atol=tol[dtype])
            _check_dw(dw, dw_ref, f"movielens sliced {cross} d={d} {name}")
    return max(fm2_err, _parity_bwd_edges(gen))


def _real_batch(b: int):
    """One synthetic criteo_kaggle train batch at batch b (numpy, global ids)."""
    from cffm_tpu_torch.config import get_config
    from cffm_tpu_torch.data.loader import make_dataset

    cfg = get_config("criteo_kaggle")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=b))
    return cfg, next(make_dataset(cfg, prefetch=0))


def _sorted_big_ids(cfg, ids):
    """The per-field sorted big-field ids of the hybrid route (sid, order)."""
    import torch

    from cffm_tpu_torch.models.cffm import field_offsets
    from cffm_tpu_torch.optim.rowwise import _per_field_sorted

    fs = cfg.model.small_field_prefix
    offs = tuple(int(o) for o in field_offsets(cfg.model))[fs:]
    ids_fm = torch.from_numpy(ids).cuda().t()[fs:]
    return _per_field_sorted(ids_fm.reshape(-1), offs, False, True)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    import torch

    _, e = torch.frexp(x.float().abs().clamp(min=1e-30))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def _check_segments(ss, sid, grads, m_pad: int, what: str) -> float:
    import torch

    uids, gsum, count = ss.sorted_segment_sum_compact(sid, grads, m_pad)
    seg, count_ref = ss.segments(sid)
    uids_ref, gsum_ref = ss.sorted_segment_sum_reference(sid, seg, grads.to(torch.bfloat16),
                                                         m_pad)
    if not torch.equal(uids, uids_ref) or int(count) != int(count_ref):
        fail(f"parity_segment {what}: uids or count differ")
    _check_sums("parity_segment", gsum, seg, grads, int(count),
                f"{what}: n={sid.numel()} count={int(count)} m_pad={m_pad} max id "
                f"{int(sid.max())}: uids and count exact,")
    return (gsum.float() - gsum_ref.float()).abs().max().item()


def _check_sums(phase: str, gsum, seg, grads, c: int, what: str):
    """The kernel's bf16 segment sums against the exact (f64) sums of the
    bf16 grads, and zero rows past the count."""
    import torch

    # the kernel's bf16 result is its f32 sum rounded to nearest: half a bf16
    # ulp, plus the f32 sum's own error, for which 4 * 2^-24 * sqrt(len *
    # sum g^2) (len times the segment's RMS) stands ~30x above the spread of
    # sequential f32 sums of random signs and far below one entry of a hot
    # segment. An exact sum halfway between two bf16 values (a tie) sits at
    # 1.000 of its limit.
    if (gsum[c:] != 0).any():
        fail(f"{phase} {what} empty slots hold nonzero rows")
    sl = seg.long()
    g64 = grads.to(torch.bfloat16).double()
    exact = torch.zeros((c, grads.shape[1]), dtype=torch.float64,
                        device=seg.device).index_add_(0, sl, g64)
    sumsq = torch.zeros_like(exact).index_add_(0, sl, g64 * g64)
    del g64
    runs = torch.zeros((c,), dtype=torch.float64, device=seg.device).index_add_(
        0, sl, torch.ones_like(seg, dtype=torch.float64))
    f32_term = 4 * 2.0**-24 * (runs[:, None] * sumsq).sqrt()
    got = gsum[:c]
    err = (got.double() - exact).abs()
    limit = 0.5 * _bf16_ulp(torch.maximum(got.float().abs(), exact.float().abs())).double()
    limit += f32_term
    del sumsq
    bad = int((err > limit).sum())
    ratio = err / limit.clamp(min=1e-300)
    worst = int(ratio.argmax())
    row, col = divmod(worst, gsum.shape[1])
    hot = int(runs.argmax())
    print(f"{phase} {what} longest segment {int(runs[hot])} entries, gsum "
          f"max_abs_err={err.max().item():.3e} against the exact sums, {bad} entries beyond "
          f"half a bf16 ulp + the f32 term (f32 term on the longest segment at most "
          f"{f32_term[hot].max().item():.3e}; worst entry at {ratio.max().item():.3f} of its "
          f"limit: kernel {got[row, col].item():.6e}, exact {exact[row, col].item():.6e}, "
          f"segment of {int(runs[row])}); rows past the count exact zeros", flush=True)
    if bad:
        fail(f"{phase} {what} gsum beyond half a bf16 ulp + the f32 term")


def phase_parity_segment():
    """Kernel 3 on a real batch and on wide ids; returns (error, inputs of
    the apply parity: uids with the sentinel, gsum, count)."""
    import torch

    from cffm_tpu_torch.ops import sorted_segment as ss
    from cffm_tpu_torch.ops.streamed_update import padded_entries, pick_tile
    from cffm_tpu_torch.optim.rowwise import unique_bound

    cfg, batch = _real_batch(65536)
    model = cfg.model
    fs = model.small_field_prefix
    sid, _ = _sorted_big_ids(cfg, batch["ids"])
    n, w = sid.numel(), model.table_width
    gen = torch.Generator(device="cuda").manual_seed(4)
    grads = (torch.randn((n, w), generator=gen, device="cuda") * 0.01).to(torch.bfloat16)
    m_pad = padded_entries(min(n, unique_bound(model.vocab_sizes[fs:], 65536)),
                           pick_tile(model.total_vocab))
    err = _check_segments(ss, sid, grads, m_pad, "criteo_kaggle B=65536 big fields")
    uids, gsum, count = ss.sorted_segment_sum_compact(sid, grads, m_pad)
    del grads

    wide = torch.randint(0, 2**31 - 1, (100_000,), generator=gen, device="cuda",
                         dtype=torch.int32)
    wide[:5000] = 2**31 - 2
    wide[5000:6000] = 1 << 24
    wide[6000:7000] = (1 << 16) + 1
    wide_sid = torch.sort(wide).values
    wide_g = torch.randn((wide_sid.numel(), 128), generator=gen, device="cuda")
    _check_segments(ss, wide_sid, wide_g, padded_entries(wide_sid.numel(), 512),
                    "ids up to 2^31-2")
    slots = torch.arange(m_pad, device="cuda")
    uids_s = torch.where(slots < count, uids, model.total_vocab).to(torch.int32)
    return err, (uids_s, gsum, count, sid)


def _compare_tables(a, b, base, touched, atol_ulps: bool, what: str,
                    phase: str = "parity_apply"):
    """Chunked: max |a - b| on all rows (in ulps of b for bf16), and
    whether any row outside `touched` moved from base in a or b."""
    import torch

    err, moved = 0.0, 0
    for r0 in range(0, a.shape[0], 1 << 18):
        sl = slice(r0, r0 + (1 << 18))
        d = (a[sl].float() - b[sl].float()).abs()
        if atol_ulps:
            d = d / _bf16_ulp(b[sl])
        err = max(err, d.max().item())
        for t in (a, b):
            changed = (t[sl] != base[sl]).reshape(t[sl].shape[0], -1).any(dim=1)
            moved += int((changed & ~touched[sl]).sum())
    if moved:
        fail(f"{phase} {what}: {moved} untouched rows changed")
    return err


def phase_parity_apply(seg_out) -> dict:
    """Kernels 4 and 5 against the plain apply on the full table."""
    import torch

    from cffm_tpu_torch.ops import streamed_update as su

    uids_s, gsum, count, _ = seg_out
    cfg = _criteo_model("bfloat16")
    v, w = cfg.total_vocab, cfg.table_width
    gen = torch.Generator(device="cuda").manual_seed(5)
    touched = torch.zeros((v,), dtype=torch.bool, device="cuda")
    touched[uids_s[uids_s < v].long()] = True
    print(f"parity_apply: table {v} x {w}, {int(count)} touched rows of {uids_s.numel()} "
          f"slots", flush=True)
    lr, eps, b1, b2, t = 0.05, 1e-8, 0.9, 0.999, 3
    errs = {}
    base = torch.randn((v, w), generator=gen, device="cuda") * 0.01
    acc0 = torch.rand((v, 1), generator=gen, device="cuda") + 0.1
    for mode in ("adagrad", "sgd", "rowwise_adam"):
        tk, tr = base.clone(), base.clone()
        if mode == "rowwise_adam":
            m0 = torch.randn((v, w), generator=gen, device="cuda") * 0.01
            v0 = torch.rand((v, 1), generator=gen, device="cuda") * 1e-4
            mk, mr, vk, vr = m0.clone(), m0.clone(), v0.clone(), v0.clone()
            su.streamed_rowwise_adam_apply(tk, mk, vk, uids_s, gsum, lr, eps, b1, b2, t)
            su.streamed_apply_reference(tr, {"m": mr, "v": vr}, uids_s, gsum,
                                        su._hyper(lr, eps, su._adam_extra(b1, b2, t)),
                                        "rowwise_adam")
            state_err = max(_compare_tables(mk, mr, m0, touched, False, "m"),
                            _compare_tables(vk, vr, v0, touched, False, "v"))
            del mk, mr, vk, vr, m0, v0
        else:
            acc_k, acc_r = (acc0.clone(), acc0.clone()) if mode == "adagrad" else (None, None)
            su.streamed_rowwise_apply(tk, acc_k, uids_s, gsum, lr, eps)
            su.streamed_apply_reference(tr, {"accum": acc_r} if acc_k is not None else {},
                                        uids_s, gsum, su._hyper(lr, eps), mode)
            state_err = (_compare_tables(acc_k, acc_r, acc0, touched, False, "accum")
                         if acc_k is not None else 0.0)
        err = _compare_tables(tk, tr, base, touched, False, f"{mode} f32")
        print(f"parity_apply {mode} f32: table max_abs_err={err:.3e}, state "
              f"max_abs_err={state_err:.3e} (atol=1e-6), untouched rows bit-equal",
              flush=True)
        if err > 1e-6 or state_err > 1e-6:
            fail(f"parity_apply {mode} f32 beyond 1e-6")
        errs[mode] = max(err, state_err)
        del tk, tr
    # bf16 table, adagrad: nearest, then stochastic against nearest
    b16 = base.to(torch.bfloat16)
    del base
    tk, tr = b16.clone(), b16.clone()
    su.streamed_rowwise_apply(tk, acc0.clone(), uids_s, gsum, lr, eps)
    su.streamed_apply_reference(tr, {"accum": acc0.clone()}, uids_s, gsum,
                                su._hyper(lr, eps), "adagrad")
    ulps = _compare_tables(tk, tr, b16, touched, True, "adagrad bf16 nearest")
    print(f"parity_apply adagrad bf16 nearest: max {ulps:.2f} ulp from the plain "
          f"version (limit 1), untouched rows bit-equal", flush=True)
    if ulps > 1:
        fail("parity_apply bf16 nearest beyond one ulp")
    ts = b16.clone()
    su.streamed_rowwise_apply(ts, acc0.clone(), uids_s, gsum, lr, eps, sr_seed=1234)
    ulps_sr = _compare_tables(ts, tk, b16, touched, True, "adagrad bf16 stochastic")
    # signed rounding error against the exact f32 result, on the touched rows
    rows = uids_s[uids_s < v].long()
    exact = b16[rows].float()
    su.streamed_apply_reference(exact, {"accum": acc0[rows].clone()},
                                torch.arange(rows.numel(), device="cuda", dtype=torch.int32),
                                gsum[: rows.numel()], su._hyper(lr, eps), "adagrad")
    e_sr = ((ts[rows].float() - exact) / _bf16_ulp(exact)).mean().item()
    e_rn = ((tk[rows].float() - exact) / _bf16_ulp(exact)).mean().item()
    dithered = (ts[rows] != tk[rows]).float().mean().item()
    print(f"parity_apply adagrad bf16 stochastic: max {ulps_sr:.2f} ulp from nearest "
          f"(limit 1), mean signed error {e_sr:+.5f} ulp (nearest {e_rn:+.5f}, limit "
          f"|0.01|), {dithered:.3f} of touched values rounded the other way",
          flush=True)
    if ulps_sr > 1 or abs(e_sr) > 0.01 or dithered == 0:
        fail("parity_apply bf16 stochastic rounding out of bounds")
    return errs


def _run_cfg(overrides: dict):
    """criteo_kaggle with dotted overrides, as the command line takes them."""
    from cffm_tpu_torch.cli import _apply_override
    from cffm_tpu_torch.config import get_config

    cfg = get_config("criteo_kaggle")
    for dotted, value in overrides.items():
        cfg = _apply_override(cfg, dotted, str(value))
    return cfg


def _counts():
    from cffm_tpu_torch.ops import interaction_conv as ic
    from cffm_tpu_torch.ops import sorted_segment as ss
    from cffm_tpu_torch.ops import streamed_update as su

    out = {fn.__name__: fn.launches for fn in ic.ENTRIES + (ic.cross_conv1_bwd,)}
    for fn in _counted(ss, su) + _counted_tools():
        out[fn.__name__] = fn.launches
    return out


def _counted_tools():
    """The launch-counted wrappers of kernels 8a (bwd_v1), 9 (dot_probe) and
    of kernel 2 in the variants' layout (bwd_v0, bwd_v2)."""
    from cffm_tpu_torch.ops import bwd_variants as bv
    from cffm_tpu_torch.ops import dot_probe as dp

    return tuple(bv.VARIANTS.values()) + (dp.dot_probe,)


def _counted(ss, su):
    """The launch-counted wrappers of kernels 3-7."""
    return (ss.sorted_segment_sum_compact, ss.sorted_segment_sum_by_seg,
            su.streamed_rowwise_apply, su.streamed_rowwise_adam_apply,
            su.bucketed_rowwise_apply, su.bucketed_rowwise_adam_apply)


def _reset_counts():
    from cffm_tpu_torch.ops import interaction_conv as ic
    from cffm_tpu_torch.ops import sorted_segment as ss
    from cffm_tpu_torch.ops import streamed_update as su

    ic.reset_launches()
    for fn in _counted(ss, su) + _counted_tools():
        fn.launches = 0


def phase_train() -> dict:
    """Three full-width runs through train.run; returns their launch counts."""
    import torch

    from cffm_tpu_torch import train

    runs = {
        "adagrad_f32": (3, {}, {"cross_conv1_lin_fm2": 3 + 2, "cross_conv1_bwd": 3,
                                "sorted_segment_sum_compact": 3,
                                "streamed_rowwise_apply": 3}),
        "adagrad_bf16_table": (2, {"model.table_dtype": "bfloat16"},
                               {"cross_conv1_lin_fm2": 2 + 2, "cross_conv1_bwd": 2,
                                "sorted_segment_sum_compact": 2,
                                "streamed_rowwise_apply": 2}),
        # no hybrid for rowwise_adam: the fm route trains, eval takes fm2
        "rowwise_adam": (2, {"optim.sparse_optimizer": "rowwise_adam"},
                         {"cross_conv1_lin_fm": 2, "cross_conv1_lin_fm2": 2,
                          "cross_conv1_bwd": 2, "sorted_segment_sum_compact": 2,
                          "streamed_rowwise_adam_apply": 2}),
    }
    out = {}
    for name, (steps, extra, want) in runs.items():
        cfg = _run_cfg({"data.batch_size": 65536, "data.num_train_steps": steps,
                        "data.eval_batches": 2, "log_every": 1, **extra})
        logs = []
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        result = train.run(cfg, device="cuda", log_fn=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        losses = [json.loads(x)["loss"] for x in logs if '"loss"' in x]
        print(f"train {name}: B=65536 {steps} steps, losses {losses}, eval "
              f"{json.dumps(result)}, launches {counts}, wall {wall:.1f}s incl. data",
              flush=True)
        if not all(math.isfinite(x) for x in losses + [result["auc"], result["logloss"]]):
            fail(f"train {name}: loss or AUC not finite")
        for fn, n in counts.items():
            if n != want.get(fn, 0):
                fail(f"train {name}: want launches {want}, got {counts}")
        out[name] = counts
        torch.cuda.empty_cache()
    return out


def _tree_to(tree, device):
    import torch

    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    if tree.dim() == 0 and tree.dtype == torch.int32:
        return tree.clone()  # step counters stay on the CPU
    return tree.to(device)


def _rows_apart(cpu, gpu, moved):
    """Chunked over rows of two (V, n) tensors: max |cpu - gpu| on the
    moved rows, and whether the other rows are bit-equal."""
    import torch

    err, equal = 0.0, True
    for r0 in range(0, cpu.shape[0], 1 << 18):
        sl = slice(r0, r0 + (1 << 18))
        c, g, mv = cpu[sl].cuda(), gpu[sl], moved[sl]
        if mv.any():
            err = max(err, (c[mv] - g[mv]).abs().max().item())
        equal &= torch.equal(c[~mv], g[~mv])
    return err, equal


def _step_vs_cpu(sparse: str, steps: int):
    """`steps` train steps on the card and on the CPU from one state and
    the same batches; card and CPU held to each other."""
    import torch

    from cffm_tpu_torch import train
    from cffm_tpu_torch.data.loader import make_dataset

    cfg = _run_cfg({"model.compute_dtype": "float32", "optim.streamed_update": "on",
                    "data.batch_size": 4096, "optim.sparse_optimizer": sparse})
    state_cpu = train.create_state(cfg, torch.Generator().manual_seed(7))
    state_gpu = train.TrainState(0, _tree_to(state_cpu.params, "cuda"),
                                 _tree_to(state_cpu.dense_opt_state, "cuda"),
                                 _tree_to(state_cpu.sparse_opt_state, "cuda"))
    table0 = state_gpu.params["embed"]["table"].clone()
    dense0 = [t.clone() for t in train.tree_leaves(train.split_dense_params(state_cpu.params))]
    data = make_dataset(cfg, prefetch=0)
    batches = [next(data) for _ in range(steps)]
    fn = train.default_interaction_fn(cfg)
    losses = {}
    states = {"cpu": state_cpu, "cuda": state_gpu}
    for dev in states:
        t0 = time.perf_counter()
        for batch in batches:
            ids, dense, labels = train.batch_to_device(batch, torch.device(dev))
            states[dev], m = train.train_step(states[dev], ids, dense, labels, cfg, fn)
            losses.setdefault(dev, []).append(float(m["loss"]))
        print(f"step_vs_cpu {sparse}: {steps} steps on {dev} took "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    cpu, gpu = states["cpu"], states["cuda"]
    # the first step starts from one state: rtol 1e-5; later steps start
    # from tables whose bf16-rounded row sums may differ by an ulp in a few
    # lanes (f32 sums in another order): rtol 1e-4
    lerr = [abs(a - b) / abs(a) for a, b in zip(losses["cpu"], losses["cuda"])]
    # dense params: atol 1e-5 after one step. After more, Adam's m/sqrt(v)
    # turns the f32 noise of a gradient that nearly cancels across steps
    # into a visible share of lr in single elements, so the whole dense step
    # is held instead: |cpu - card| / |card - start| <= 1e-3 (L2 norms)
    pairs = list(zip(train.tree_leaves(train.split_dense_params(cpu.params)),
                     train.tree_leaves(train.split_dense_params(gpu.params)), dense0))
    dense_err = max((a.cuda() - b).abs().max().item() for a, b, _ in pairs)
    dense_rel = (math.sqrt(sum(float(((a.cuda() - b) ** 2).sum()) for a, b, _ in pairs))
                 / math.sqrt(sum(float(((b - c.cuda()) ** 2).sum()) for _, b, c in pairs)))
    dense_bad = dense_err > 1e-5 if steps == 1 else dense_rel > 1e-3
    tgpu = gpu.params["embed"]["table"]
    moved = (tgpu != table0).any(dim=1)
    delta = max((tgpu[sl] - table0[sl]).abs().max().item()
                for sl in (slice(r, r + (1 << 18)) for r in range(0, tgpu.shape[0], 1 << 18)))
    # rows the card left alone are bit-equal to the start, so CPU == card
    # there means the CPU left them alone too
    terr, untouched = _rows_apart(cpu.params["embed"]["table"], tgpu, moved)
    # sparse state on the moved rows: the accumulator at atol 1e-6 (a row
    # mean of squares, where an ulp of one lane's bf16 sum all but vanishes);
    # Adam's m, a row sum itself, at 1e-2 of max|m| like the table's step;
    # v at 1e-2 of max|v|
    state_bad, state_msg = False, []
    for k, v in gpu.sparse_opt_state["embed"].items():
        c = cpu.sparse_opt_state["embed"][k]
        if v.dim() == 0:
            ok = int(c) == int(v)
            state_msg.append(f"{k} {int(c)}/{int(v)}")
        else:
            err, equal = _rows_apart(c, v, moved)
            scale = v.abs().max().item()
            ok = equal and err <= (1e-6 if k == "accum" else 1e-2 * scale)
            state_msg.append(f"{k} max_abs_err {err:.2e} (max|{k}| {scale:.3e}), "
                             f"untouched rows equal {equal}")
        state_bad |= not ok
    print(f"step_vs_cpu criteo_kaggle {sparse} B=4096 f32, {steps} steps: losses cpu "
          f"{losses['cpu']} card {losses['cuda']} (relative err "
          f"{', '.join(f'{e:.2e}' for e in lerr)}; rtol 1e-5, then 1e-4); dense params "
          f"max_abs_err {dense_err:.2e} (atol 1e-5 after one step), relative L2 error of "
          f"the dense step {dense_rel:.2e} (1e-3 after more); {int(moved.sum())} moved "
          f"rows, max "
          f"|delta| {delta:.3e}, table max_abs_err {terr:.2e} (atol 1e-2*max|delta|), "
          f"the other rows bit-equal on both {untouched}; sparse state: "
          f"{'; '.join(state_msg)}", flush=True)
    if (lerr[0] > 1e-5 or any(e > 1e-4 for e in lerr[1:]) or dense_bad
            or terr > 1e-2 * delta or not untouched or state_bad):
        fail(f"step_vs_cpu {sparse}: card and CPU disagree")
    return losses


def phase_step_vs_cpu():
    """Train steps on the card and on the CPU from one state and the same
    batches: one adagrad step (the hybrid route, kernels 1-4) and two
    rowwise-Adam steps (the fm route, kernel 5)."""
    _step_vs_cpu("adagrad", 1)
    _step_vs_cpu("rowwise_adam", 2)


def phase_time_train() -> dict:
    """Kernels 2-5 at the B=65536 training shapes: kernel, plain, library,
    bound, and kernel 2 held against its plain version there; then the
    train step end to end and its profile."""
    import torch
    import torch.nn.functional as F

    from cffm_tpu_torch import train
    from cffm_tpu_torch.ops import interaction_conv as ic
    from cffm_tpu_torch.ops import sorted_segment as ss
    from cffm_tpu_torch.ops import streamed_update as su
    from cffm_tpu_torch.ops.cross import build_cross_map

    b = 65536
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(6)
    mcfg = _criteo_model("bfloat16")
    fs, f, w, d, k = (mcfg.small_field_prefix, mcfg.num_fields, mcfg.table_width,
                      mcfg.embed_dim, mcfg.conv_kernel)

    def time_bwd(bb: int) -> dict:
        """Kernel 2 through the fm2 layout at batch bb: kernel, plain,
        library and bound, and the kernel held against its plain version."""
        (es, eb), w1 = _inputs(mcfg, bb, torch.bfloat16, gen, fm_split=fs)
        c1 = w1.shape[0]
        gy = torch.randn((bb, c1, d), generator=gen, device="cuda").to(torch.bfloat16)
        glin = torch.randn((bb,), generator=gen, device="cuda")
        des, deb = torch.empty_like(es), torch.empty_like(eb)

        def kernel2():
            return ic.cross_conv1_bwd(ic._descriptors("fm2", mcfg, (es, eb)),
                                      ic._descriptors("fm2", mcfg, (des, deb)), w1, gy, glin,
                                      mcfg, w)

        ms = cuda_ms(kernel2, 5 if bb > 4096 else 50)
        rows = torch.cat([es, eb]).transpose(0, 1)
        plain_ms = cuda_ms(lambda: ic._rows_bwd_reference(rows, w1, gy, glin, mcfg),
                           2 if bb > 4096 else 10, warmup=1)
        dw = kernel2()
        drows_ref, dw_ref = ic._rows_bwd_reference(rows, w1, gy, glin, mcfg)
        err = _check_rows_grad(torch.cat([des, deb]).transpose(0, 1), drows_ref, dw, dw_ref,
                               glin, mcfg, f"criteo_kaggle fm2 bfloat16 B={bb}")
        del drows_ref, dw_ref
        m = build_cross_map(rows[..., : mcfg.row_width].reshape(bb, f, f, d), mcfg)
        wb = w1.to(torch.bfloat16)
        library_ms = cuda_ms(lambda: (
            torch.nn.grad.conv1d_weight(m, wb.shape, gy, padding=k // 2),
            F.conv_transpose1d(gy, wb, padding=k // 2)), 5 if bb > 4096 else 50)
        nbytes = (2 * (es.numel() + eb.numel()) * 2 + gy.numel() * 2 + bb * 4
                  + w1.numel() * 2 + w1.numel() * 4)
        ops = 2 * (2 * bb * d * mcfg.num_pairs * k * c1)
        del es, eb, des, deb, gy, glin, rows, m
        torch.cuda.empty_cache()
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "max_abs_err": err, "batch": bb, **_bound(nbytes, ops)}

    # kernel 2: fm2 backward, at the training batch and at the eval batch
    out["cross_conv1_bwd"] = time_bwd(b)
    out["cross_conv1_bwd_4096"] = time_bwd(4096)

    # kernel 3 on the real batch's sorted big-field ids
    cfg, batch = _real_batch(b)
    sid, _ = _sorted_big_ids(cfg, batch["ids"])
    n = sid.numel()
    grads = (torch.randn((n, w), generator=gen, device="cuda") * 0.01).to(torch.bfloat16)
    from cffm_tpu_torch.optim.rowwise import unique_bound

    m_pad = su.padded_entries(min(n, unique_bound(mcfg.vocab_sizes[fs:], b)),
                              su.pick_tile(mcfg.total_vocab))
    ms = cuda_ms(lambda: ss.sorted_segment_sum_compact(sid, grads, m_pad), 5)
    seg, count = ss.segments(sid)
    plain_ms = cuda_ms(lambda: ss.sorted_segment_sum_reference(sid, seg, grads, m_pad), 3)
    seg_l = seg.long()
    acc = torch.zeros((m_pad, w), dtype=torch.bfloat16, device="cuda")
    library_ms = cuda_ms(lambda: acc.index_add_(0, seg_l, grads), 5)
    nbytes = n * 4 + n * w * 2 + m_pad * (w * 2 + 4)
    out["sorted_segment_sum"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                                 **_bound(nbytes, n * w), "n": n, "count": int(count),
                                 "m_pad": m_pad}
    uids, gsum, count = ss.sorted_segment_sum_compact(sid, grads, m_pad)
    del grads, acc, seg_l
    uids_s = torch.where(torch.arange(m_pad, device="cuda") < count, uids,
                         mcfg.total_vocab).to(torch.int32)
    cnt = int(count)

    # kernels 4 and 5 on the full f32 table, touched rows only
    v = mcfg.total_vocab
    table = torch.randn((v, w), generator=gen, device="cuda") * 0.01
    accum = torch.full((v, 1), 0.1, device="cuda")
    ms = cuda_ms(lambda: su.streamed_rowwise_apply(table, accum, uids_s, gsum, 1e-9, 1e-8), 5)
    sgd_ms = cuda_ms(lambda: su.streamed_rowwise_apply(table, None, uids_s, gsum, 1e-9, 1e-8), 5)
    hyper = su._hyper(1e-9, 1e-8)
    plain_ms = cuda_ms(lambda: su.streamed_apply_reference(
        table, {"accum": accum}, uids_s, gsum, hyper, "adagrad"), 3)
    rows = uids_s[:cnt].long()
    sgd_delta = gsum[:cnt].float() * -1e-9
    library_ms = cuda_ms(lambda: table.index_add_(0, rows, sgd_delta), 5)
    base = m_pad * 4 + cnt * w * 2 + cnt * w * 4 * 2
    out["streamed_apply"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                             "sgd_ms": sgd_ms, **_bound(base + cnt * 4 * 2, cnt * w * 6,
                                                        "float32"),
                             "touched_rows": cnt}
    mom = torch.zeros((v, w), device="cuda")
    vv = torch.zeros((v, 1), device="cuda")
    ms = cuda_ms(lambda: su.streamed_rowwise_adam_apply(table, mom, vv, uids_s, gsum, 1e-9,
                                                        1e-8, 0.9, 0.999, 1), 5)
    ahyper = su._hyper(1e-9, 1e-8, su._adam_extra(0.9, 0.999, 1))
    plain_ms = cuda_ms(lambda: su.streamed_apply_reference(
        table, {"m": mom, "v": vv}, uids_s, gsum, ahyper, "rowwise_adam"), 3)
    out["streamed_apply_rowwise_adam"] = {
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        **_bound(base + cnt * w * 4 * 2 + cnt * 4 * 2, cnt * w * 10, "float32"),
        "touched_rows": cnt}
    del table, accum, mom, vv, gsum, uids, uids_s, rows, sgd_delta
    torch.cuda.empty_cache()
    for name, r in out.items():
        print(f"time {name} B={r.get('batch', b)}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bytes'] / 1e9:.3f} GB, {r['ops'] / 1e9:.2f} GOP)"
              + (f", touched rows {r['touched_rows']}" if "touched_rows" in r else "")
              + (f", sgd kernel {r['sgd_ms']:.4f} ms" if "sgd_ms" in r else ""),
              flush=True)

    # the train step end to end, bf16 compute, f32 table, adagrad
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=b))
    state = train.create_state(cfg, torch.Generator(device="cuda").manual_seed(0))
    ids, dense, labels = train.batch_to_device(batch, torch.device("cuda"))
    fn = train.default_interaction_fn(cfg)
    box = [state]

    def step():
        box[0], _ = train.train_step(box[0], ids, dense, labels, cfg, fn)

    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / reps
    out["train_step_ms_65536"] = step_ms
    print(f"time train step criteo_kaggle B={b} bf16 compute, f32 table, adagrad "
          f"(zipf ids, staged batch): {step_ms:.3f} ms = {b / step_ms * 1e3:.1f} ex/s",
          flush=True)
    print(f"memory: peak allocated over the train steps "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)

    from torch.profiler import ProfilerActivity, profile

    reps = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    out["profile"] = {"busy_ms": busy_ms, "wall_ms": wall_ms}
    print(f"profile train step B={b}: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"wall per step (idle share {1 - busy_ms / wall_ms:.3f}, profiler on)",
          flush=True)
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:14]:
        ms = e.self_device_time_total / 1e3 / reps
        print(f"profile   {ms:8.3f} ms {ms / busy_ms:6.1%} x{e.count // reps} "
              f"{e.key[:90]}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Shapes beyond the kernels' caps: the gates' routes on the card
# ---------------------------------------------------------------------------


def _routes(counts: dict) -> dict:
    return {name: n for name, n in counts.items() if n}


def phase_parity_caps() -> dict:
    """The overrides past the named configs' shapes, each on the card and
    held against the plain version: kernel 7's width (its gate sends a
    wider table to kernels 3-4), C1=128 and k=9 (kernels 1 and 2 take
    them). Prints each route from the launch counters; checks the gates'
    CPU rules against the libraries. Returns the routes."""
    import numpy as np
    import torch

    from cffm_tpu_torch.config import OptimizerConfig
    from cffm_tpu_torch.ops import interaction_conv as ic
    from cffm_tpu_torch.ops import streamed_update as su
    from cffm_tpu_torch.optim import rowwise as rw

    cap = su._library().cffm_bucketed_max_width()
    grid = [(d, k, c1, cross) for d in (8, 16, 32) for k in (1, 3, 5, 7, 9, 11)
            for c1 in (32, 64, 72, 96, 128, 136) for cross in ("field_aware", "hadamard")]
    apart = []
    for d, k, c1, cross in grid:
        cfg = dataclasses.replace(_movielens_model(cross, "float32", d), conv_kernel=k)
        if ic.bwd_kernel_takes(cfg, c1) != ic.bwd_kernel_takes(cfg, c1, "cuda"):
            apart.append((d, k, c1, cross))
    print(f"parity_caps: bucketed width cap {cap} (BUCKETED_MAX_WIDTH "
          f"{su.BUCKETED_MAX_WIDTH}); bwd_kernel_takes' CPU rule against the library at "
          f"{len(grid)} (d, k, C1, cross): {len(apart)} apart {apart[:4]}; kernel widths "
          f"{ic.KERNEL_WIDTHS}", flush=True)
    if cap != su.BUCKETED_MAX_WIDTH or apart:
        fail("parity_caps: a gate's CPU rule differs from its library's")
    routes = {}

    # 1. kernel 7's width: a (100k, 2560) table (criteo_kaggle at embed_dim=64)
    rng = np.random.default_rng(21)
    v, w, nb, c = 100_000, 2560, 4, 8192
    ids = np.full((nb, c), v, np.int32)
    for o in range(nb):
        rows = np.unique(np.concatenate([[0, 7, v - 1], rng.choice(v, size=6000,
                                                                  replace=False)]))
        ids[o, :rows.size] = rows
    ids_t = torch.from_numpy(ids).cuda()
    g = torch.randn((nb, c, w), generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda") * 0.01
    g[ids_t >= v] = float("nan")  # garbage in sentinel slots
    table = torch.randn((v, w), generator=torch.Generator(device="cuda").manual_seed(6),
                        device="cuda") * 0.01
    opt = OptimizerConfig(sparse_optimizer="adagrad", sparse_lr=0.05, clip_norm=0.05)
    state = {"accum": torch.full((v, 1), 0.1, device="cuda")}
    base, acc0 = table.clone(), state["accum"].clone()
    torch.cuda.synchronize()
    _reset_counts()
    rw.bucketed_rowwise_update(table, state, ids_t, g, opt)
    torch.cuda.synchronize()
    routes["bucketed_w2560"] = _routes(_counts())
    ref_t, ref_acc = base.clone(), {"accum": acc0.clone()}
    su.bucketed_apply_reference(ref_t, ref_acc, ids_t, g, su._hyper(0.05, opt.eps), "adagrad",
                                clip=opt.clip_norm)
    step, ref_step = table - base, ref_t - base
    err = (step - ref_step).abs().max().item()
    lim = 0.01 * ref_step.abs().max().item()
    aerr = ((state["accum"] - ref_acc["accum"]).abs()
            / ref_acc["accum"].abs()).max().item()
    touched = torch.zeros(v, dtype=torch.bool, device="cuda")
    touched[ids_t[ids_t < v].long()] = True
    print(f"parity_caps bucketed adagrad (V={v}, W={w}, NB={nb}, C={c}, clip "
          f"{opt.clip_norm}): route {routes['bucketed_w2560']}; table step max_abs_err="
          f"{err:.3e} (atol 1% of max step {lim:.3e}), accum max rel err {aerr:.3e} "
          f"(rtol 2^-6: the route rounds each row's total to bf16)", flush=True)
    if routes["bucketed_w2560"] != {"sorted_segment_sum_compact": 1, "streamed_rowwise_apply": 1}:
        fail(f"parity_caps: W={w} took {routes['bucketed_w2560']}, not kernels 3-4")
    if err > lim or aerr > 2.0**-6 or not torch.isfinite(table).all():
        fail("parity_caps: the flattened route disagrees with kernel 7's plain version")
    if not (torch.equal(table[~touched], base[~touched])
            and torch.equal(state["accum"][~touched], acc0[~touched])):
        fail("parity_caps: rows outside the buckets changed")
    del table, base, ref_t, g, state, ref_acc, step, ref_step
    torch.cuda.empty_cache()

    # 2. C1=128 through the split field-major entry (bf16: the tensor-core
    # backward at 6 m-tiles; f32: the CUDA-core one, two channel groups a
    # thread), then k=9 in bf16 (the CUDA-core forward and backward)
    gen = torch.Generator(device="cuda").manual_seed(22)
    b = 4096
    for case, dtype, k, c1 in (("c1_128", "bfloat16", 3, 128), ("c1_128_f32", "float32", 3, 128),
                               ("k9_fm2", "bfloat16", 9, 64)):
        cfg = dataclasses.replace(_criteo_model(dtype), conv_channels=(c1, 64), conv_kernel=k)
        dt = getattr(torch, dtype)
        (es, eb), w1 = _inputs(cfg, b, dt, gen, fm_split=cfg.small_field_prefix)
        gy = torch.randn((b, c1, cfg.embed_dim), generator=gen, device="cuda").to(dt)
        glin = torch.randn((b,), generator=gen, device="cuda")
        wgmma = dtype == "bfloat16" and _bwd_takes_wgmma(ic, cfg, es, eb, gy)
        _reset_counts()
        y, lin = ic.cross_conv1_lin_fm2(es, eb, w1, cfg)
        drows, dw = _grad_rows(ic, cfg, "fm2", es, eb, w1, gy, glin)
        torch.cuda.synchronize()
        routes[case] = _routes(_counts())
        rows = torch.cat([es, eb]).transpose(0, 1)
        y_ref, lin_ref = ic._rows_reference(rows, w1, cfg)
        tol = 2e-2 if dtype == "bfloat16" else 1e-4
        yerr = (y.float() - y_ref.float()).abs().max().item()
        print(f"parity_caps k={k} C1={c1} fm2 {dtype} B={b}: route {routes[case]}, backward "
              f"{'wgmma' if wgmma else 'CUDA cores'}; y max_abs_err={yerr:.3e} "
              f"(rtol=atol={tol})", flush=True)
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(lin, lin_ref, rtol=0.0, atol=1e-5)
        drows_ref, dw_ref = ic._rows_bwd_reference(rows, w1, gy, glin, cfg)
        _check_rows_grad(drows, drows_ref, dw, dw_ref, glin, cfg,
                         f"caps k={k} C1={c1} fm2 {dtype} B={b}")
        if routes[case] != {"cross_conv1_lin_fm2": 2, "cross_conv1_bwd": 1}:
            fail(f"parity_caps: {case} took {routes[case]}, not kernels 1 and 2")
        if wgmma != (case == "c1_128"):
            fail(f"parity_caps: {case} took the {'wgmma' if wgmma else 'CUDA-core'} backward")
        del es, eb, rows, drows, drows_ref
        torch.cuda.empty_cache()

    # 3. C1=128 hadamard (sliced, movielens): the CUDA-core backward's dE sum
    cfg = dataclasses.replace(_movielens_model("hadamard", "bfloat16"), conv_channels=(128, 64))
    emb, w1 = _inputs(cfg, b, torch.bfloat16, gen)
    gy = torch.randn((b, 128, cfg.embed_dim), generator=gen, device="cuda").to(torch.bfloat16)
    _reset_counts()
    e, w = emb.detach().requires_grad_(), w1.detach().requires_grad_()
    y = ic.cross_conv1(e, w, cfg)
    de, dw = torch.autograd.grad(y, (e, w), gy)
    torch.cuda.synchronize()
    routes["c1_128_hadamard"] = _routes(_counts())
    torch.testing.assert_close(y.float(), ic.cross_conv1_reference(emb, w1, cfg).float(),
                               rtol=2e-2, atol=2e-2)
    de_ref, dw_ref = ic.cross_conv1_bwd_reference(emb, w1, gy, cfg)
    err = (de.float() - de_ref.float()).abs().max().item()
    print(f"parity_caps C1=128 sliced hadamard bfloat16 B={b}: route "
          f"{routes['c1_128_hadamard']}; dE max_abs_err={err:.3e} (rtol=atol=2e-2)", flush=True)
    torch.testing.assert_close(de.float(), de_ref.float(), rtol=2e-2, atol=2e-2)
    _check_dw(dw, dw_ref, f"caps C1=128 sliced hadamard bfloat16 B={b}")
    if routes["c1_128_hadamard"] != {"cross_conv1": 1, "cross_conv1_bwd": 1}:
        fail(f"parity_caps: C1=128 hadamard took {routes['c1_128_hadamard']}")

    # 4. k=9, layer 1 and the conv tail, forward and backward, f32 against
    # the plain route in float64
    cfg = dataclasses.replace(_criteo_model("float32"), conv_kernel=9)
    emb, w1 = _inputs(cfg, b, torch.float32, gen)
    layers = [{"w": w1, "b": torch.randn((64,), generator=gen, device="cuda")},
              {"w": torch.randn((64, 64, 9), generator=gen, device="cuda") * 0.04,
               "b": torch.randn((64,), generator=gen, device="cuda")}]

    def fwd_bwd(fn, e, lays, gout):
        e = e.detach().requires_grad_()
        lays = [{n: t.detach().requires_grad_() for n, t in lay.items()} for lay in lays]
        out = fn(e, lays, cfg)
        grads = torch.autograd.grad(out, [e] + [t for lay in lays for t in lay.values()], gout)
        return out.detach(), grads

    plain = ic.make_interaction_fn(use_kernel=False)
    gout = torch.randn(plain(emb, layers, cfg).shape, generator=gen, device="cuda")
    _reset_counts()
    out, grads = fwd_bwd(ic.make_interaction_fn(), emb, layers, gout)
    torch.cuda.synchronize()
    routes["k9"] = _routes(_counts())
    f64 = [{n: t.double() for n, t in lay.items()} for lay in layers]
    out_d, grads_d = fwd_bwd(plain, emb.double(), f64, gout.double())
    errs = [(a.double() - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
            for a, r in zip((out,) + grads, (out_d,) + grads_d)]
    print(f"parity_caps k=9 sliced field_aware float32 B={b}: route {routes['k9']}; "
          f"output and grads max err / max|ref| {max(errs):.3e} against the plain route "
          f"in float64 (1e-4)", flush=True)
    if routes["k9"] != {"cross_conv1": 1, "cross_conv1_bwd": 1}:
        fail(f"parity_caps: k=9 took {routes['k9']}, not kernels 1 and 2")
    if max(errs) > 1e-4:
        fail("parity_caps: k=9 on the card disagrees with the float64 plain route")
    return routes


# ---------------------------------------------------------------------------
# The row-sharded path: kernels 6 and 7, the sharded step
# ---------------------------------------------------------------------------


def _sharded_cfg(overrides=None):
    """criteo_kaggle with the row-sharded table at B=65536."""
    return _run_cfg({"data.batch_size": 65536, "sharding.table_sharded": True,
                     **(overrides or {})})


def _tree_clone(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _rank0_stream(cfg, ids_np, t: int):
    """What rank 0 of t shards computes for one global batch split in t
    blocks: the segment index of its own block's big-field ids routed at t
    (kernel 6's input), the segment-sum slots m_pad, and the buckets its
    peers send it (kernel 7's input): (seg, m_pad, ids_bkt (t, C), Vs)."""
    import torch

    from cffm_tpu_torch.optim.rowwise import unique_bound
    from cffm_tpu_torch.parallel.mesh import Mesh
    from cffm_tpu_torch.parallel.sharded_embedding import EB
    from cffm_tpu_torch.parallel.sharded_train import _make_flat_router

    model = cfg.model
    fs = model.small_field_prefix
    b = ids_np.shape[0] // t
    router = _make_flat_router(cfg, Mesh(None, 0, t, torch.device("cuda"), False))
    c, vs = router.capacity, router.rows_per_shard
    blocks = [torch.from_numpy(ids_np[p * b:(p + 1) * b]).cuda().t()[fs:].reshape(-1).long()
              for p in range(t)]
    sk = torch.sort((blocks[0] % t) * vs + blocks[0] // t).values
    first = torch.ones_like(sk, dtype=torch.int32)
    first[1:] = (sk[1:] != sk[:-1]).to(torch.int32)
    seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
    m = min(sk.numel(), unique_bound(model.vocab_sizes[fs:], b))
    m_pad = -(-m // EB) * EB + -(-c // EB) * EB
    ids_bkt = torch.full((t, c), vs, dtype=torch.int32, device="cuda")
    for p, ids_p in enumerate(blocks):  # peer p's distinct ids that rank 0 owns
        rows = torch.unique(ids_p[ids_p % t == 0]) // t
        ids_bkt[p, :min(rows.numel(), c)] = rows[:c].to(torch.int32)
    return seg, m_pad, ids_bkt, vs


def phase_parity_segment_by_seg(ids_np) -> float:
    """Kernel 6 against its plain version and the exact sums, on the seg
    stream of one B=65536 batch routed at T=1 and on rank 0's at T=4."""
    import torch

    from cffm_tpu_torch.ops import sorted_segment as ss

    cfg = _sharded_cfg()
    gen = torch.Generator(device="cuda").manual_seed(8)
    err = 0.0
    for t in (1, 4):
        seg, m_pad, _, _ = _rank0_stream(cfg, ids_np, t)
        n, count = seg.numel(), int(seg[-1]) + 1
        grads = (torch.randn((n, cfg.model.table_width), generator=gen, device="cuda")
                 * 0.01).to(torch.bfloat16)
        gsum = ss.sorted_segment_sum_by_seg(seg, grads, m_pad)
        plain = ss.sorted_segment_by_seg_reference(seg, grads, m_pad)
        e = (gsum.float() - plain.float()).abs().max().item()
        _check_sums("parity_segment_by_seg", gsum, seg, grads, count,
                    f"T={t} rank 0: n={n} count={count} m_pad={m_pad} (kernel vs plain "
                    f"max_abs_err={e:.3e}):")
        err = max(err, e)
        del grads, gsum, plain
        torch.cuda.empty_cache()
    return err


# sha256 of kernel 7's f32 results on the edge cases of `_bucketed_edges`
# (touched rows of table and state after one update), captured from the
# kernel this one replaced (warp per slot, global binary searches); the
# redesigned kernel must reproduce them bit for bit.
K7_F32_DIGESTS = {
    "all_nb/adagrad":
        "9c604ad89fbcf0d334aca466e7c05f4c973a183be54fdf6fab50fe1a9669bc03",
    "all_nb/sgd":
        "5584ca89549c79bcdf365fa3fe3826ec5450f9f1f6a807275d6bf4dbc6a60808",
    "all_nb/rowwise_adam":
        "8e44b8e03ed3d33121da0ecb4e5d953c817c720e7453cebb07f667270349346f",
    "sentinel_bucket/adagrad":
        "2b631f8c29617606559f198a57e692818f237defad7b2b54567d55d9e43e419a",
    "sentinel_bucket/sgd":
        "8cd4d27b3996554c6ce76bfb1bf8151d196a02ab60f6024b4fa239646a818dff",
    "sentinel_bucket/rowwise_adam":
        "fd18e37174cbec031493644db2f3466dc6e91c0af0e0e922b36b078f296fef7f",
    "empty/adagrad":
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "empty/sgd":
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "empty/rowwise_adam":
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
}


def _bucketed_edge_inputs(case: str):
    """Numpy inputs of one kernel-7 edge case (V rows of W lanes, NB
    buckets of C slots, sentinels >= V in the tails, NaN in sentinel
    grads): "all_nb" puts rows 0, 7 and V-1 in every bucket of NB=8;
    "sentinel_bucket" leaves bucket 2 of 8 all sentinel; "empty" has
    no live slot in any of 4 buckets."""
    import numpy as np

    rng = np.random.default_rng({"all_nb": 11, "sentinel_bucket": 12, "empty": 13}[case])
    v, w, c = 100_003, 640, 4096
    nb = 4 if case == "empty" else 8
    ids = np.full((nb, c), v, dtype=np.int32)
    ids[1::2] = v + 5  # any value >= V is a sentinel
    for o in range(nb):
        if case == "empty" or (case == "sentinel_bucket" and o == 2):
            continue
        n = int(rng.integers(c // 8, c - 8))
        rows = rng.choice(v, size=n, replace=False)
        if case == "all_nb":
            rows = np.union1d(rows, [0, 7, v - 1])[: c]
        rows = np.unique(rows)
        ids[o, : rows.size] = rows
    g = (rng.standard_normal((nb, c, w), dtype=np.float32) * 0.01)
    g[ids >= v] = np.nan
    table = rng.standard_normal((v, w), dtype=np.float32) * 0.01
    accum = rng.random((v, 1), dtype=np.float32) + 0.1
    m = rng.standard_normal((v, w), dtype=np.float32) * 0.01
    vv = rng.random((v, 1), dtype=np.float32) * 1e-4
    return ids, g, table, accum, m, vv


def _bucketed_edges() -> tuple:
    """Kernel 7 on the edge cases of `_bucketed_edge_inputs`, f32 tables:
    adagrad, sgd with a clip, rowwise_adam. Each against the plain version
    (1e-6, rows outside the buckets bit-equal), bit-equal in two runs, and
    against `K7_F32_DIGESTS`. Returns (largest error, {key: digest})."""
    import hashlib

    import torch

    from cffm_tpu_torch.ops import streamed_update as su

    lr, eps, b1, b2, t_step, clip = 0.05, 1e-8, 0.9, 0.999, 3, 0.05
    worst, digests = 0.0, {}
    for case in ("all_nb", "sentinel_bucket", "empty"):
        ids_np, g_np, t_np, a_np, m_np, v_np = _bucketed_edge_inputs(case)
        ids = torch.from_numpy(ids_np).cuda()
        g = torch.from_numpy(g_np).cuda().to(torch.bfloat16)
        base = torch.from_numpy(t_np).cuda()
        v = base.shape[0]
        touched = torch.zeros((v,), dtype=torch.bool, device="cuda")
        touched[ids[ids < v].long()] = True
        rows = touched.nonzero()[:, 0]
        for mode, cl in (("adagrad", 0.0), ("sgd", clip), ("rowwise_adam", 0.0)):
            runs = []
            for _ in range(2):
                tk = base.clone()
                if mode == "rowwise_adam":
                    st = {"m": torch.from_numpy(m_np).cuda(), "v": torch.from_numpy(v_np).cuda()}
                    su.bucketed_rowwise_adam_apply(tk, st["m"], st["v"], ids, g, lr, eps, b1,
                                                   b2, t_step, clip=cl)
                else:
                    st = {"accum": torch.from_numpy(a_np).cuda()} if mode == "adagrad" else {}
                    su.bucketed_rowwise_apply(tk, st.get("accum"), ids, g, lr, eps, clip=cl)
                runs.append((tk, st))
            (tk, st), (tk2, st2) = runs
            if not torch.equal(tk, tk2) or any(not torch.equal(st[n], st2[n]) for n in st):
                fail(f"parity_bucketed edge {case} {mode}: two runs differ")
            tr = base.clone()
            if mode == "rowwise_adam":
                sr = {"m": torch.from_numpy(m_np).cuda(), "v": torch.from_numpy(v_np).cuda()}
                hyper = su._hyper(lr, eps, su._adam_extra(b1, b2, t_step))
            else:
                sr = {"accum": torch.from_numpy(a_np).cuda()} if mode == "adagrad" else {}
                hyper = su._hyper(lr, eps)
            su.bucketed_apply_reference(tr, sr, ids, g, hyper, mode, cl)
            err = _compare_tables(tk, tr, base, touched, False, f"edge {case} {mode}",
                                  "parity_bucketed")
            for n in st:
                s0 = torch.from_numpy({"accum": a_np, "m": m_np, "v": v_np}[n]).cuda()
                err = max(err, _compare_tables(st[n], sr[n], s0, touched, False,
                                               f"edge {case} {mode} {n}", "parity_bucketed"))
            h = hashlib.sha256(tk[rows].cpu().numpy().tobytes())
            for n in sorted(st):
                h.update(st[n][rows].cpu().numpy().tobytes())
            key = f"{case}/{mode}"
            digests[key] = h.hexdigest()
            want = K7_F32_DIGESTS.get(key)
            print(f"parity_bucketed edge {case} {mode} (clip {cl}): {int(rows.numel())} rows, "
                  f"max_abs_err={err:.3e} (atol=1e-6), two runs bit-equal, rows outside the "
                  f"buckets bit-equal, sha256 {digests[key][:16]} "
                  f"{'equals the replaced kernel' if want == digests[key] else 'REPLACED KERNEL: ' + str(want)[:16]}",
                  flush=True)
            if err > 1e-6:
                fail(f"parity_bucketed edge {case} {mode} beyond 1e-6")
            if K7_F32_DIGESTS and want != digests[key]:
                fail(f"parity_bucketed edge {case} {mode}: f32 result differs from the "
                     f"replaced kernel's")
            worst = max(worst, err)
        del ids, g, base, tk, tk2, tr
        torch.cuda.empty_cache()
    return worst, digests


def phase_parity_bucketed(ids_np) -> float:
    """Kernel 7 against its plain version on rank 0's shard and buckets at
    T=1 (the full table), 4 and 8: adagrad, sgd with a clip, rowwise_adam on
    f32 tables; adagrad on bf16 tables rounded to nearest and
    stochastically; NaN in every sentinel slot's grads. Returns the largest
    f32 error."""
    import torch

    from cffm_tpu_torch.ops import streamed_update as su

    cfg = _sharded_cfg()
    w = cfg.model.table_width
    gen = torch.Generator(device="cuda").manual_seed(9)
    lr, eps, b1, b2, t_step, clip = 0.05, 1e-8, 0.9, 0.999, 3, 0.05
    worst = _bucketed_edges()[0]
    for t in (1, 4, 8):
        _, _, ids_bkt, vs = _rank0_stream(cfg, ids_np, t)
        nb, c = ids_bkt.shape
        valid = ids_bkt < vs
        present = torch.zeros((vs,), dtype=torch.int32, device="cuda")
        present.index_add_(0, ids_bkt[valid].long(),
                           torch.ones_like(ids_bkt[valid], dtype=torch.int32))
        touched = present > 0
        g = (torch.randn((nb, c, w), generator=gen, device="cuda") * 0.01).to(torch.bfloat16)
        g[~valid] = float("nan")
        what = f"NB={nb}"
        print(f"parity_bucketed {what}: shard {vs} x {w}, C={c}, {int(valid.sum())} valid "
              f"slots, {int(touched.sum())} distinct rows, {int((present > 1).sum())} of them "
              f"in more than one bucket; NaN in all {int((~valid).sum())} sentinel slots' "
              f"grads", flush=True)
        base = torch.randn((vs, w), generator=gen, device="cuda") * 0.01
        acc0 = torch.rand((vs, 1), generator=gen, device="cuda") + 0.1
        for mode, cl in (("adagrad", 0.0), ("sgd", clip), ("rowwise_adam", 0.0)):
            tk, tr = base.clone(), base.clone()
            if mode == "rowwise_adam":
                m0 = torch.randn((vs, w), generator=gen, device="cuda") * 0.01
                v0 = torch.rand((vs, 1), generator=gen, device="cuda") * 1e-4
                mk, mr, vk, vr = m0.clone(), m0.clone(), v0.clone(), v0.clone()
                su.bucketed_rowwise_adam_apply(tk, mk, vk, ids_bkt, g, lr, eps, b1, b2, t_step,
                                               clip=cl)
                su.bucketed_apply_reference(tr, {"m": mr, "v": vr}, ids_bkt, g,
                                            su._hyper(lr, eps, su._adam_extra(b1, b2, t_step)),
                                            "rowwise_adam", cl)
                state_err = max(
                    _compare_tables(mk, mr, m0, touched, False, f"{what} m", "parity_bucketed"),
                    _compare_tables(vk, vr, v0, touched, False, f"{what} v", "parity_bucketed"))
                del mk, mr, vk, vr, m0, v0
            else:
                acc_k, acc_r = ((acc0.clone(), acc0.clone()) if mode == "adagrad"
                                else (None, None))
                su.bucketed_rowwise_apply(tk, acc_k, ids_bkt, g, lr, eps, clip=cl)
                su.bucketed_apply_reference(tr, {"accum": acc_r} if acc_r is not None else {},
                                            ids_bkt, g, su._hyper(lr, eps), mode, cl)
                state_err = (_compare_tables(acc_k, acc_r, acc0, touched, False,
                                             f"{what} accum", "parity_bucketed")
                             if acc_k is not None else 0.0)
            err = _compare_tables(tk, tr, base, touched, False, f"{what} {mode} f32",
                                  "parity_bucketed")
            print(f"parity_bucketed {what} {mode} (clip {cl}) f32: table max_abs_err={err:.3e}, "
                  f"state max_abs_err={state_err:.3e} (atol=1e-6), rows outside the buckets "
                  f"bit-equal", flush=True)
            if err > 1e-6 or state_err > 1e-6 or not torch.isfinite(tk).all():
                fail(f"parity_bucketed {what} {mode} f32 beyond 1e-6 or not finite")
            worst = max(worst, err, state_err)
            del tk, tr
        # bf16 table, adagrad: nearest, then stochastic against nearest
        b16 = base.to(torch.bfloat16)
        tk, tr = b16.clone(), b16.clone()
        su.bucketed_rowwise_apply(tk, acc0.clone(), ids_bkt, g, lr, eps)
        su.bucketed_apply_reference(tr, {"accum": acc0.clone()}, ids_bkt, g, su._hyper(lr, eps),
                                    "adagrad")
        ulps = _compare_tables(tk, tr, b16, touched, True, f"{what} adagrad bf16 nearest",
                               "parity_bucketed")
        ts = b16.clone()
        su.bucketed_rowwise_apply(ts, acc0.clone(), ids_bkt, g, lr, eps, sr_seed=1234)
        ulps_sr = _compare_tables(ts, tk, b16, touched, True, f"{what} adagrad bf16 stochastic",
                                  "parity_bucketed")
        exact = b16.float()
        del base
        su.bucketed_apply_reference(exact, {"accum": acc0.clone()}, ids_bkt, g,
                                    su._hyper(lr, eps), "adagrad")
        rows = touched.nonzero()[:, 0]
        ex = exact[rows]
        del exact
        e_sr = ((ts[rows].float() - ex) / _bf16_ulp(ex)).mean().item()
        e_rn = ((tk[rows].float() - ex) / _bf16_ulp(ex)).mean().item()
        dithered = (ts[rows] != tk[rows]).float().mean().item()
        print(f"parity_bucketed {what} adagrad bf16: nearest max {ulps:.2f} ulp from the plain "
              f"version (limit 1); stochastic max {ulps_sr:.2f} ulp from nearest (limit 1), "
              f"mean signed error {e_sr:+.5f} ulp (nearest {e_rn:+.5f}, limit |0.01|), "
              f"{dithered:.3f} of touched values rounded the other way; rows outside the "
              f"buckets bit-equal", flush=True)
        if ulps > 1 or ulps_sr > 1 or abs(e_sr) > 0.01 or dithered == 0:
            fail(f"parity_bucketed {what} bf16 rounding out of bounds")
        del b16, tk, tr, ts, ex, g, acc0
        torch.cuda.empty_cache()
    return worst


def _sharded_run(cfg, mesh, steps: int, eval_batches: int, seed: int = 0):
    """create_sharded_state, `steps` train steps and `eval_batches` eval
    batches through make_sharded_train_step / make_sharded_eval_step, with
    the batches staged first; returns (losses, overflows, eval, eval
    overflow, wall seconds) and the launch counts of that run."""
    import torch

    from cffm_tpu_torch import metrics, train
    from cffm_tpu_torch.data.loader import make_dataset
    from cffm_tpu_torch.parallel.sharded_train import (create_sharded_state,
                                                       make_sharded_eval_step,
                                                       make_sharded_train_step)

    dev = mesh.device
    fn = train.default_interaction_fn(cfg)
    state = create_sharded_state(cfg, torch.Generator(device=dev).manual_seed(seed), mesh)
    step = make_sharded_train_step(cfg, mesh, fn)
    ev = make_sharded_eval_step(cfg, mesh, fn)
    data = make_dataset(cfg, mesh.rank, mesh.world, prefetch=0)
    val = make_dataset(cfg, mesh.rank, mesh.world, split="val", prefetch=0)
    batches = [train.batch_to_device(next(data), dev) for _ in range(steps)]
    vbatches = [train.batch_to_device(next(val), dev) for _ in range(eval_batches)]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    losses, overflows = [], []
    for ids, dense, labels in batches:
        state, m = step(state, ids, dense, labels)
        losses.append(float(m["loss"]))
        overflows.append(int(m["overflow"]))
    auc, eval_ovf = metrics.auc_state_init(device=dev), 0
    for ids, dense, labels in vbatches:
        auc, ovf = ev(state, auc, ids, dense, labels)
        eval_ovf += int(ovf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    result = {k: float(v) for k, v in metrics.auc_state_finalize(auc).items()}
    return (losses, overflows, result, eval_ovf, wall), _counts()


def phase_train_sharded(mesh) -> dict:
    """criteo_kaggle with the row-sharded table at full width, B=65536,
    through make_sharded_train_step on an NCCL group of one: three runs with
    launch counts, then one adagrad step against the single-device step."""
    import torch

    from cffm_tpu_torch import train
    from cffm_tpu_torch.data.loader import make_dataset
    from cffm_tpu_torch.parallel.sharded_train import (create_sharded_state,
                                                       make_sharded_train_step)

    k = {"fm2": "cross_conv1_lin_fm2", "fm": "cross_conv1_lin_fm", "flat": "cross_conv1_lin",
         "bwd": "cross_conv1_bwd", "k6": "sorted_segment_sum_by_seg",
         "k7": "bucketed_rowwise_apply", "k7adam": "bucketed_rowwise_adam_apply"}
    ev = 2
    runs = {
        "adagrad_f32": (3, {}, {k["fm2"]: 3, k["bwd"]: 3, k["k6"]: 3, k["k7"]: 3,
                                k["flat"]: ev}),
        "adagrad_bf16_table": (2, {"model.table_dtype": "bfloat16"},
                               {k["fm2"]: 2, k["bwd"]: 2, k["k6"]: 2, k["k7"]: 2,
                                k["flat"]: ev}),
        # no hybrid for rowwise_adam: the fm route trains, eval takes the flat entry
        "rowwise_adam": (2, {"optim.sparse_optimizer": "rowwise_adam"},
                         {k["fm"]: 2, k["bwd"]: 2, k["k6"]: 2, k["k7adam"]: 2, k["flat"]: ev}),
    }
    out = {}
    for name, (steps, extra, want) in runs.items():
        cfg = _sharded_cfg(extra)
        (losses, ovfs, result, eval_ovf, wall), counts = _sharded_run(cfg, mesh, steps, ev)
        per_step = {fn: n / steps for fn, n in counts.items() if n and fn != k["flat"]}
        print(f"train_sharded {name}: B=65536, T={mesh.world}, {steps} steps, losses {losses}, "
              f"overflow {ovfs}, eval {json.dumps(result)} (eval overflow {eval_ovf}), "
              f"launches {counts}, per train step {per_step}, wall {wall:.2f}s", flush=True)
        if not all(math.isfinite(x) for x in losses + [result["auc"], result["logloss"]]):
            fail(f"train_sharded {name}: loss or AUC not finite")
        if any(ovfs) or eval_ovf:
            fail(f"train_sharded {name}: ids overflowed the capacity")
        if any(n != want.get(fn, 0) for fn, n in counts.items()):
            fail(f"train_sharded {name}: want launches {want}, got {counts}")
        out[name] = counts
        torch.cuda.empty_cache()

    # one adagrad step, sharded (T=1: the natural layout) vs single-device
    cfg = _sharded_cfg()
    fn = train.default_interaction_fn(cfg)
    sharded = create_sharded_state(cfg, torch.Generator(device="cuda").manual_seed(5), mesh)
    single = train.TrainState(0, _tree_clone(sharded.params),
                              _tree_clone(sharded.dense_opt_state),
                              _tree_clone(sharded.sparse_opt_state))
    table0 = sharded.params["embed"]["table"].clone()
    ids, dense, labels = train.batch_to_device(next(make_dataset(cfg, prefetch=0)),
                                               torch.device("cuda"))
    sharded, m_sh = make_sharded_train_step(cfg, mesh, fn)(sharded, ids, dense, labels)
    single, m_si = train.train_step(single, ids, dense, labels, cfg, fn)
    l_sh, l_si = float(m_sh["loss"]), float(m_si["loss"])
    t_sh, t_si = sharded.params["embed"]["table"], single.params["embed"]["table"]
    moved = (t_si != table0).any(dim=1)
    delta = max((t_si[sl] - table0[sl]).abs().max().item()
                for sl in (slice(r, r + (1 << 18)) for r in range(0, t_si.shape[0], 1 << 18)))
    terr, untouched = _rows_apart(t_si, t_sh, moved)
    aerr, aequal = _rows_apart(single.sparse_opt_state["embed"]["accum"],
                               sharded.sparse_opt_state["embed"]["accum"], moved)
    dense_err = max((a - b).abs().max().item() for a, b in zip(
        train.tree_leaves(train.split_dense_params(single.params)),
        train.tree_leaves(train.split_dense_params(sharded.params))))
    print(f"train_sharded step vs single-device criteo_kaggle adagrad B=65536: loss sharded "
          f"{l_sh} single {l_si} (relative err {abs(l_sh - l_si) / abs(l_si):.2e}, rtol 1e-5); "
          f"{int(moved.sum())} moved rows, max |delta| {delta:.3e}, table max_abs_err "
          f"{terr:.2e} (atol 1e-2*max|delta|), other rows bit-equal {untouched}; accum "
          f"max_abs_err {aerr:.2e} (atol 1e-6), equal elsewhere {aequal}; dense params "
          f"max_abs_err {dense_err:.2e} (atol 1e-5)", flush=True)
    if (abs(l_sh - l_si) > 1e-5 * abs(l_si) or terr > 1e-2 * delta or not untouched
            or aerr > 1e-6 or not aequal or dense_err > 1e-5):
        fail("train_sharded: the sharded step and the single-device step disagree")
    return out


def _multi_rank(rank: int, world: int, port: int, out_dir: str):
    """One rank of sharded_multi: two sharded adagrad steps on this rank's
    block of two B=65536 batches; rank 0 then runs the single-device step
    on the whole batches from the same state and compares."""
    import torch
    import torch.distributed as dist

    from cffm_tpu_torch import train
    from cffm_tpu_torch.data.loader import make_dataset
    from cffm_tpu_torch.parallel import sharded_embedding as se
    from cffm_tpu_torch.parallel.mesh import close_mesh, make_mesh
    from cffm_tpu_torch.parallel.sharded_train import make_sharded_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)
    mesh = make_mesh(init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                     backend="nccl", device=dev)
    try:
        # f32 compute, as step_vs_cpu: in bf16 the ranks' partial dense grads
        # round apart from the whole batch's, which Adam magnifies
        cfg = _sharded_cfg({"model.compute_dtype": "float32"})
        fn = train.default_interaction_fn(cfg)
        v = cfg.model.total_vocab
        # the same natural-layout state on every rank, from one seed
        full = train.create_state(cfg, torch.Generator(device=dev).manual_seed(3))

        def shard(x):
            storage = se.to_mod_sharded(x, world)
            vs = storage.shape[0] // world
            return storage[rank * vs:(rank + 1) * vs].clone()

        params = {k: _tree_clone(x) for k, x in full.params.items() if k != "embed"}
        params["embed"] = {"table": shard(full.params["embed"]["table"])}
        accum = shard(full.sparse_opt_state["embed"]["accum"])
        state = train.TrainState(0, params, _tree_clone(full.dense_opt_state),
                                 {"embed": {"accum": accum}})
        dense0 = [x.clone() for x in train.tree_leaves(train.split_dense_params(full.params))]
        table0 = full.params["embed"]["table"].clone() if rank == 0 else None
        if rank != 0:
            del full
        data = make_dataset(cfg, prefetch=0)
        batches = [train.batch_to_device(next(data), dev) for _ in range(2)]
        b = cfg.data.batch_size // world
        step = make_sharded_train_step(cfg, mesh, fn)
        losses = []
        for ids, dense, labels in batches:
            blk = slice(rank * b, (rank + 1) * b)
            state, m = step(state, ids[blk], dense[blk], labels[blk])
            losses.append(float(m["loss"]))
        gathered = {}
        for name, x in (("table", state.params["embed"]["table"]),
                        ("accum", state.sparse_opt_state["embed"]["accum"])):
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x.contiguous())
            gathered[name] = se.from_mod_sharded(torch.cat(parts), world, v) if rank == 0 else None
            del parts
        if rank == 0:
            single, single_losses = full, []
            for ids, dense, labels in batches:
                single, m = train.train_step(single, ids, dense, labels, cfg, fn)
                single_losses.append(float(m["loss"]))
            t_si = single.params["embed"]["table"]
            moved = (t_si != table0).any(dim=1)
            delta = (t_si - table0).abs().max().item()
            terr, untouched = _rows_apart(t_si, gathered["table"], moved)
            aerr, aequal = _rows_apart(single.sparse_opt_state["embed"]["accum"],
                                       gathered["accum"], moved)
            pairs = list(zip(train.tree_leaves(train.split_dense_params(single.params)),
                             train.tree_leaves(train.split_dense_params(state.params)), dense0))
            dense_rel = (math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b, _ in pairs))
                         / math.sqrt(sum(float(((a - c) ** 2).sum()) for a, _, c in pairs)))
            lerr = [abs(a - b) / abs(b) for a, b in zip(losses, single_losses)]
            ok = (lerr[0] <= 1e-5 and lerr[1] <= 1e-4 and dense_rel <= 1e-3
                  and terr <= 1e-2 * delta and untouched and aerr <= 1e-6 and aequal)
            with open(f"{out_dir}/multi.json", "w") as f:
                json.dump({"ok": ok, "world": world, "losses_sharded": losses,
                           "losses_single": single_losses, "loss_relative_err": lerr,
                           "dense_step_relative_l2": dense_rel, "moved_rows": int(moved.sum()),
                           "max_delta": delta, "table_max_abs_err": terr,
                           "untouched_equal": untouched, "accum_max_abs_err": aerr,
                           "accum_untouched_equal": aequal}, f)
        dist.barrier()
    finally:
        close_mesh(mesh)


def phase_sharded_multi():
    """The sharded step on min(cards, 4) NCCL ranks against the
    single-device step, when the machine has more than one card."""
    import os

    import torch
    import torch.multiprocessing as mp

    from cffm_tpu_torch.parallel.mesh import free_port

    n = torch.cuda.device_count()
    if n < 2:
        print(f"sharded_multi: not run: {n} CUDA card visible, and the multi-rank NCCL step "
              f"needs at least 2 (on a machine with more cards this phase spawns "
              f"min(cards, 4) ranks)", flush=True)
        return None
    world = min(n, 4)
    out_dir = os.path.join("build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    mp.spawn(_multi_rank, args=(world, free_port(), out_dir), nprocs=world, join=True)
    with open(os.path.join(out_dir, "multi.json")) as f:
        res = json.load(f)
    print(f"sharded_multi: criteo_kaggle adagrad f32 B=65536 on {world} NCCL ranks, 2 steps vs the "
          f"single-device step: {json.dumps(res)} (rtol 1e-5 then 1e-4 on the losses, 1e-3 "
          f"on the dense step's relative L2, 1e-2*max|delta| on the moved table rows, 1e-6 "
          f"on the accumulator; other rows bit-equal); {time.perf_counter() - t0:.1f}s",
          flush=True)
    if not res["ok"]:
        fail("sharded_multi: the multi-rank step and the single-device step disagree")
    return res


def phase_time_sharded(mesh, ids_np) -> dict:
    """Kernels 6 and 7 at the T=1 and T=4 rank-0 shapes: kernel, plain
    version, library yardstick and bound; then the sharded step end to end
    at B=65536 and its profile."""
    import torch

    from cffm_tpu_torch import train
    from cffm_tpu_torch.data.loader import make_dataset
    from cffm_tpu_torch.ops import sorted_segment as ss
    from cffm_tpu_torch.ops import streamed_update as su
    from cffm_tpu_torch.parallel.sharded_train import (create_sharded_state,
                                                       make_sharded_train_step)

    cfg = _sharded_cfg()
    w = cfg.model.table_width
    gen = torch.Generator(device="cuda").manual_seed(10)
    out = {}
    for t in (1, 4):
        seg, m_pad, ids_bkt, vs = _rank0_stream(cfg, ids_np, t)
        n = seg.numel()
        grads = (torch.randn((n, w), generator=gen, device="cuda") * 0.01).to(torch.bfloat16)
        ms = cuda_ms(lambda: ss.sorted_segment_sum_by_seg(seg, grads, m_pad), 5)
        plain_ms = cuda_ms(lambda: ss.sorted_segment_by_seg_reference(seg, grads, m_pad), 3)
        seg_l, grads_f = seg.long(), grads.float()
        acc = torch.zeros((m_pad, w), dtype=torch.float32, device="cuda")
        library_ms = cuda_ms(lambda: acc.index_add_(0, seg_l, grads_f), 5)
        out[f"k6_t{t}"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                           **_bound(n * 4 + n * w * 2 + m_pad * w * 2, n * w),
                           "n": n, "count": int(seg[-1]) + 1, "m_pad": m_pad}
        del grads, grads_f, acc, seg_l

        nb, c = ids_bkt.shape
        valid = ids_bkt < vs
        g = (torch.randn((nb, c, w), generator=gen, device="cuda") * 0.01).to(torch.bfloat16)
        g[~valid] = float("nan")
        table = torch.randn((vs, w), generator=gen, device="cuda") * 0.01
        accum = torch.full((vs, 1), 0.1, device="cuda")
        ms = cuda_ms(lambda: su.bucketed_rowwise_apply(table, accum, ids_bkt, g, 1e-9, 1e-8), 5)
        sgd_ms = cuda_ms(lambda: su.bucketed_rowwise_apply(table, None, ids_bkt, g, 1e-9, 1e-8), 5)
        hyper = su._hyper(1e-9, 1e-8)
        plain_ms = cuda_ms(lambda: su.bucketed_apply_reference(
            table, {"accum": accum}, ids_bkt, g, hyper, "adagrad"), 3)
        rows = ids_bkt[valid].long()
        sgd_delta = g[valid].float() * -1e-9
        library_ms = cuda_ms(lambda: table.index_add_(0, rows, sgd_delta), 5)
        slots, distinct = rows.numel(), int(torch.unique(rows).numel())
        nbytes = nb * c * 4 + slots * w * 2 + distinct * (w * 4 * 2 + 4 * 2)
        out[f"k7_t{t}"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                           "sgd_ms": sgd_ms,
                           **_bound(nbytes, slots * w + distinct * w * 6, "float32"),
                           "nb": nb, "c": c, "valid_slots": slots, "touched_rows": distinct}
        del g, table, accum, rows, sgd_delta, ids_bkt, seg
        torch.cuda.empty_cache()
    for name, r in out.items():
        print(f"time {name} B=65536: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bytes'] / 1e9:.3f} GB, {r['ops'] / 1e9:.2f} GOP), "
              + ", ".join(f"{k} {v}" for k, v in r.items() if k in
                          ("n", "count", "m_pad", "nb", "c", "valid_slots", "touched_rows"))
              + (f", sgd kernel {r['sgd_ms']:.4f} ms" if "sgd_ms" in r else ""), flush=True)

    # the sharded step end to end: bf16 compute, f32 table, adagrad, T=1
    fn = train.default_interaction_fn(cfg)
    box = [create_sharded_state(cfg, torch.Generator(device="cuda").manual_seed(0), mesh)]
    step = make_sharded_train_step(cfg, mesh, fn)
    ids, dense, labels = train.batch_to_device(next(make_dataset(cfg, prefetch=0)),
                                               torch.device("cuda"))

    def one():
        box[0], _ = step(box[0], ids, dense, labels)

    torch.cuda.reset_peak_memory_stats()
    one()
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        one()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / reps
    out["sharded_step_ms_65536"] = step_ms
    print(f"time sharded train step criteo_kaggle B=65536 T={mesh.world} bf16 compute, f32 "
          f"table, adagrad (zipf ids, staged batch): {step_ms:.3f} ms = "
          f"{65536 / step_ms * 1e3:.1f} ex/s; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    from torch.profiler import ProfilerActivity, profile

    reps = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    out["profile"] = {"busy_ms": busy_ms, "wall_ms": wall_ms}
    print(f"profile sharded step B=65536: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"wall per step (idle share {1 - busy_ms / wall_ms:.3f}, profiler on)", flush=True)
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:16]:
        ms = e.self_device_time_total / 1e3 / reps
        print(f"profile   {ms:8.3f} ms {ms / busy_ms:6.1%} x{e.count // reps} "
              f"{e.key[:90]}", flush=True)
    return out


# ---------------------------------------------------------------------------
# The measurement entry points: kernels 8a and 9, the bench and the scripts
# ---------------------------------------------------------------------------


def _variant_grads(bv, cfg, x, name: str):
    """(dE as (B, F, W), dW as (C1, P, k)) of one backward variant."""
    fn = bv.VARIANTS[name]
    de, dw = fn(x["emb3"], x["wr"] if name == "v1" else x["wrs"], x["g"], x["glin"], cfg)
    p = cfg.num_pairs
    if (dw[:, p:] != 0).any():
        fail(f"parity_bwd_v1 {name}: dW rows past P={p} are not zero")
    return de.transpose(0, 1), dw[:, :p].permute(2, 1, 0)


def _de_limit_ratio(got, ref, de_abs) -> float:
    """max |got - ref| / limit with limit = one bf16 ulp of |ref| (the
    product's own rounding) plus two bf16 ulps of de_abs, the same product
    taken from |E|, |W| and |g|: dM is summed in f32 in another order and
    rounded to bf16, so where the sum nearly cancels it can sit ulps of
    sum|w*g| apart, which the partner row scales. In slices of the leading
    axis, to bound the f32 temporaries."""
    worst = 0.0
    for s in range(0, got.shape[0], 4096):
        g, r = got[s:s + 4096].float(), ref[s:s + 4096].float()
        limit = _bf16_ulp(r) + 2 * _bf16_ulp(de_abs[s:s + 4096].float())
        worst = max(worst, ((g - r).abs() / limit).max().item())
    return worst


def phase_parity_bwd_v1() -> dict:
    """Kernel 8a (bwd_v1) against its plain version and against kernel 2
    (bwd_v0) at B=4096 and 65536 in bf16 and at B=512 in f32, criteo_kaggle
    shapes; then kernel 8a, row 8b (bwd_v2, kernel 2 in the variants'
    layout), their plain versions, library yardstick and bound at B=65536."""
    import torch
    import torch.nn.functional as F

    from cffm_tpu_torch.ops import bwd_variants as bv
    from cffm_tpu_torch.ops import interaction_conv as ic
    from cffm_tpu_torch.ops.cross import build_cross_map
    from cffm_tpu_torch.scripts.bench_bwd_variants import make_inputs

    out = {"max_abs_err": 0.0, "v2_max_abs_err": 0.0}
    # 8a's bf16 CUDA-core kernel, which bf16 rows with C1 > 64 take
    cfg = dataclasses.replace(_criteo_model("bfloat16"), conv_channels=(72, 64))
    x = make_inputs(cfg, 512, "cuda", torch.bfloat16)
    de1, dw1 = _variant_grads(bv, cfg, x, "v1")
    de_ref, dw_ref = bv.bwd_v1_reference(x["emb3"], x["wr"], x["g"], x["glin"], cfg)
    out["max_abs_err"] = _check_rows_grad(
        de1, de_ref.transpose(0, 1), dw1, dw_ref[:, :cfg.num_pairs].permute(2, 1, 0),
        x["glin"], cfg, "v1 (kernel 8a, CUDA cores) vs plain criteo_kaggle C1=72 bfloat16 B=512")
    del x, de1, dw1, de_ref, dw_ref
    for b, dtype in ((512, torch.float32), (4096, torch.bfloat16), (65536, torch.bfloat16)):
        name = str(dtype).removeprefix("torch.")
        cfg = _criteo_model(name)
        x = make_inputs(cfg, b, "cuda", dtype)
        glin = x["glin"]
        de1, dw1 = _variant_grads(bv, cfg, x, "v1")
        de_ref, dw_ref = bv.bwd_v1_reference(x["emb3"], x["wr"], x["g"], glin, cfg)
        de_ref, dw_ref = de_ref.transpose(0, 1), dw_ref[:, :cfg.num_pairs].permute(2, 1, 0)
        what = f"criteo_kaggle {name} B={b}"
        err = _check_rows_grad(de1, de_ref, dw1, dw_ref, glin, cfg,
                               f"v1 (kernel 8a) vs plain {what}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        de0, dw0 = _variant_grads(bv, cfg, x, "v0")
        _check_dw(dw1, dw0, f"v1 (kernel 8a) vs v0 (kernel 2) {what}")
        # row 8b: v2 (kernel 2 from wrs) against the same plain backward
        de2, dw2 = _variant_grads(bv, cfg, x, "v2")
        err2 = _check_rows_grad(de2, de_ref, dw2, dw_ref, glin, cfg,
                                f"v2 (kernel 2) vs plain {what}")
        out["v2_max_abs_err"] = max(out["v2_max_abs_err"], err2)
        if dtype == torch.bfloat16:
            de_abs = bv.bwd_v1_reference(x["emb3"].abs(), x["wr"].abs(), x["g"].abs(),
                                         torch.zeros_like(glin), cfg)[0].transpose(0, 1)
            r_ref, r_k2 = _de_limit_ratio(de1, de_ref, de_abs), _de_limit_ratio(de1, de0, de_abs)
            r_v2 = _de_limit_ratio(de2, de_ref, de_abs)
            print(f"parity_bwd_v1 {what}: dE of v1 vs plain at {r_ref:.3f}, v1 vs kernel 2 at "
                  f"{r_k2:.3f}, v2 vs plain at {r_v2:.3f} of the limit (one bf16 ulp of the "
                  f"product plus two of the product taken from |E|, |W|, |g|)", flush=True)
            if max(r_ref, r_k2, r_v2) > 1:
                fail(f"parity_bwd_v1 {what}: dE beyond its ulp limit")
            del de_abs
        else:
            torch.testing.assert_close(de1, de0, rtol=1e-4, atol=1e-4)
        dw1b = bv.bwd_v1(x["emb3"], x["wr"], x["g"], glin, cfg)[1]
        if not torch.equal(dw1b[:, :cfg.num_pairs].permute(2, 1, 0), dw1):
            fail(f"parity_bwd_v1 {what}: dW differs between two runs")
        del de1, dw1, de0, dw0, de2, dw2, de_ref, dw_ref, dw1b
        if b != 65536:
            del x
            torch.cuda.empty_cache()
    print("parity_bwd_v1: diagonal and pad lanes exact zeros, fused column == glin, "
          "dW pad rows zero and bit-equal in two runs", flush=True)

    # times at B=65536 (bf16), the inputs of the last case
    f, w, d, k = cfg.num_fields, cfg.table_width, cfg.embed_dim, cfg.conv_kernel
    c1, p = cfg.conv_channels[0], cfg.num_pairs
    p_pad = x["wrs"].shape[1]
    args = {name: (x["emb3"], x["wr"] if name == "v1" else x["wrs"], x["g"], glin, cfg)
            for name in ("v1", "v2")}
    rows = x["emb3"].transpose(0, 1)
    m = build_cross_map(rows[..., : cfg.row_width].reshape(b, f, f, d), cfg)
    wb = bv.w1_from_wrs(x["wrs"], cfg).contiguous()
    gy = x["g"].reshape(b, c1, d)
    library_ms = cuda_ms(lambda: (torch.nn.grad.conv1d_weight(m, wb.shape, gy, padding=k // 2),
                                  F.conv_transpose1d(gy, wb, padding=k // 2)), 5)
    del m, rows
    torch.cuda.empty_cache()
    nbytes = 2 * f * b * w * 2 + b * c1 * d * 2 + b * 4 + p_pad * k * c1 * 2 + k * p_pad * c1 * 4
    ops = 2 * (2 * b * d * p * k * c1)
    for name, ref in (("v1", bv.bwd_v1_reference), ("v2", bv.bwd_v2_reference)):
        ms = cuda_ms(lambda: bv.VARIANTS[name](*args[name]), 5)
        plain_ms = cuda_ms(lambda: ref(*args[name]), 2, warmup=1)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     **_bound(nbytes, ops)}
        print(f"time bwd {name} ({'kernel 8a' if name == 'v1' else 'kernel 2'}) B={b}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (conv1d_weight + "
              f"conv_transpose1d on a built M) {library_ms:.4f} ms, bound "
              f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']}: {nbytes / 1e9:.3f} GB, "
              f"{ops / 1e9:.1f} GFLOP)", flush=True)
    ic.reset_launches()
    bv.reset_launches()
    return out


def phase_parity_dot_probe() -> dict:
    """Kernel 9's three modes against the plain version at the probe's
    shapes (BT=128, P=744, KC=192, D=16, 512 steps); kernel, plain version,
    torch.matmul yardstick (one product, scaled to the call's MACs), bound."""
    import torch

    from cffm_tpu_torch.ops import dot_probe as dp
    from cffm_tpu_torch.scripts.probe_dot_orient import D, STEPS, make_operands

    out = {"max_abs_err": 0.0}
    for mode in dp.MODES:
        a, b = make_operands(mode, "cuda")
        got = dp.dot_probe(a, b, mode, STEPS, D)
        ref = dp.dot_probe_reference(a, b, mode, STEPS, D)
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        print(f"parity_dot_probe {mode}: max_abs_err={err:.3e} (rtol=1e-5, atol=1e-5*max|out|="
              f"{1e-5 * scale:.3e})", flush=True)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * scale)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        macs = dp.macs(mode, a, b, STEPS, D)
        ms = cuda_ms(lambda: dp.dot_probe(a, b, mode, STEPS, D), 20)
        plain_ms = cuda_ms(lambda: dp.dot_probe_reference(a, b, mode, STEPS, D), 2, warmup=1)
        left, right = dp.operands(mode, a, b)
        library_ms = cuda_ms(lambda: torch.matmul(left, right), 50) * STEPS * D
        out[mode] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "tmac_s": macs / ms / 1e9,
                     **_bound(a.numel() * 2 + b.numel() * 2 + got.numel() * 4, 2 * macs)}
        print(f"time dot_probe {mode}: kernel {ms:.4f} ms ({out[mode]['tmac_s']:.1f} TMAC/s), "
              f"plain {plain_ms:.4f} ms, torch.matmul x{STEPS * D} {library_ms:.4f} ms, bound "
              f"{out[mode]['bound_ms']:.4f} ms ({out[mode]['bound_by']}: {macs:.4e} MAC)",
              flush=True)
    dp.dot_probe.launches = 0
    return out


# the tools run in process: (name, module, argv, kernels that must launch)
TOOLS = (
    ("bench_staged", "cffm_tpu_torch.bench", ["--feed=staged"],
     ("cross_conv1_lin_fm2", "cross_conv1_bwd", "sorted_segment_sum_compact",
      "streamed_rowwise_apply")),
    ("bench_score", "cffm_tpu_torch.bench", ["--feed=score"], ("cross_conv1_lin_fm2",)),
    ("bench_sharded", "cffm_tpu_torch.bench", ["--feed=sharded"],
     ("cross_conv1_lin_fm2", "cross_conv1_bwd", "sorted_segment_sum_by_seg",
      "bucketed_rowwise_apply")),
    ("bench_kernel", "cffm_tpu_torch.scripts.bench_kernel", [],
     ("cross_conv1", "cross_conv1_bwd")),
    ("bench_bwd_variants", "cffm_tpu_torch.scripts.bench_bwd_variants", ["--check"],
     ("bwd_v0", "bwd_v1", "bwd_v2", "cross_conv1_bwd")),
    ("probe_dot_orient", "cffm_tpu_torch.scripts.probe_dot_orient", [], ("dot_probe",)),
    ("profile_step_full", "cffm_tpu_torch.scripts.profile_step", ["full"],
     ("cross_conv1_lin_fm2", "cross_conv1_bwd", "sorted_segment_sum_compact",
      "streamed_rowwise_apply")),
    ("trace_step", "cffm_tpu_torch.scripts.trace_step", [],
     ("cross_conv1_lin_fm2", "cross_conv1_bwd")),
)


def phase_tools() -> dict:
    """Each measurement entry point's main(argv) in process, launch counts
    set to 0 before and read after each; any failure, or a kernel of its
    path that did not launch, fails the run. Returns {name: {rc, launches,
    lines}}."""
    import contextlib
    import importlib
    import io

    import torch

    out = {}
    for name, module, argv, must in TOOLS:
        main = importlib.import_module(module).main
        buf = io.StringIO()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        lines = buf.getvalue().strip().splitlines()
        for line in lines:
            print(f"tools {name}: {line}", flush=True)
        launched = {k: v for k, v in counts.items() if v}
        print(f"tools {name}: python -m {module} {' '.join(argv)} -> rc {rc} in {wall:.1f}s, "
              f"launches {launched}", flush=True)
        if rc != 0:
            fail(f"tools {name}: exit code {rc}")
        missing = [k for k in must if not counts[k]]
        if missing:
            fail(f"tools {name}: kernels {missing} never launched ({launched})")
        out[name] = {"rc": rc, "launches": counts, "lines": lines}
        if module == "cffm_tpu_torch.bench":
            rec = json.loads(lines[-1])
            if not rec["value"] > 0 or "error" in rec or not rec.get("card"):
                fail(f"tools {name}: bad bench line {rec}")
            out[name]["bench"] = rec
        torch.cuda.empty_cache()
    return out


PHASES = ("parity", "parity_bwd", "parity_caps", "parity_segment", "parity_apply", "serve",
          "time", "train", "step_vs_cpu", "time_train", "parity_segment_by_seg",
          "parity_bucketed", "train_sharded", "sharded_multi", "time_sharded",
          "parity_bwd_v1", "parity_dot_probe", "tools")
# the phases that run on the NCCL group of one
GROUP_PHASES = ("train_sharded", "time_sharded")


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="smoke test of the port on one GPU")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {PHASES} (default: all)")
    phases = parser.parse_args(argv).phases.split(",")
    if set(phases) - set(PHASES):
        fail(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from cffm_tpu_torch.bench import card_line
        from cffm_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"cannot import cffm_tpu_torch ({e}): run from the root of a checkout")
    # f32 parity needs full-f32 matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    took = _build.build(KERNEL_SOURCES, verbose=True)
    print(f"build: {json.dumps(took)} total {time.perf_counter() - t0:.1f}s", flush=True)

    def phase(name, fn, *args):
        if name not in phases:
            return None
        t = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"phase {name}: done in {time.perf_counter() - t:.1f}s", flush=True)
        return res

    mesh = None
    if set(phases) & set(GROUP_PHASES):
        from cffm_tpu_torch.parallel.mesh import free_port, make_mesh

        # the sharded program on an NCCL group of one, as bench.py's sharded
        # feed runs it on one device
        mesh = make_mesh(init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
                         backend="nccl", device="cuda:0")
    try:
        return _run_phases(phases, phase, mesh)
    finally:
        if mesh is not None:
            from cffm_tpu_torch.parallel.mesh import close_mesh

            close_mesh(mesh)


def _run_phases(phases, phase, mesh) -> int:
    import torch

    from cffm_tpu_torch.bench import card_line

    fm2_err = phase("parity", phase_parity)
    bwd_err = phase("parity_bwd", phase_parity_bwd)
    phase("parity_caps", phase_parity_caps)
    seg = phase("parity_segment", phase_parity_segment)
    apply_errs = phase("parity_apply", phase_parity_apply, seg[1]) if seg else None
    seg = seg[0] if seg else None
    served = phase("serve", phase_serve)
    times = phase("time", phase_time, *served[1:]) if served else None
    trained = phase("train", phase_train)
    phase("step_vs_cpu", phase_step_vs_cpu)
    ttimes = phase("time_train", phase_time_train)
    sharded_phases = {"parity_segment_by_seg", "parity_bucketed", "time_sharded"}
    ids_np = _real_batch(65536)[1]["ids"] if set(phases) & sharded_phases else None
    k6_err = phase("parity_segment_by_seg", phase_parity_segment_by_seg, ids_np)
    k7_err = phase("parity_bucketed", phase_parity_bucketed, ids_np)
    strained = phase("train_sharded", phase_train_sharded, mesh)
    phase("sharded_multi", phase_sharded_multi)
    stimes = phase("time_sharded", phase_time_sharded, mesh, ids_np)
    v1 = phase("parity_bwd_v1", phase_parity_bwd_v1)
    probe = phase("parity_dot_probe", phase_parity_dot_probe)
    tools = phase("tools", phase_tools)

    if set(phases) == set(PHASES):
        t = times[4096]
        fwd = {
            "name": "cross_conv1_fwd", "route": "cuda",
            "source": "cffm_tpu_torch/ops/csrc/cross_conv1_fwd.cu",
            "replaces": "cffm_tpu/ops/interaction_conv.py:132",
            "launches": served[0], "max_abs_err": max(fm2_err, times["max_abs_err_65536"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "build_and_conv1d_ms": t["build_and_conv1d_ms"], "split_4096": t["split"],
            "at_batch_65536": {k: times[65536][k] for k in
                               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                "build_and_conv1d_ms")},
            "forward_ms_65536": times["forward_ms_65536"],
            "train_launches": trained["adagrad_f32"]["cross_conv1_lin_fm2"],
        }
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        new = [
            ("cross_conv1_bwd", "cross_conv1_bwd.cu", "cffm_tpu/ops/interaction_conv.py:268",
             trained["adagrad_f32"]["cross_conv1_bwd"],
             max(bwd_err, ttimes["cross_conv1_bwd"]["max_abs_err"])),
            ("sorted_segment_sum", "sorted_segment.cu", "cffm_tpu/ops/sorted_segment.py:65",
             trained["adagrad_f32"]["sorted_segment_sum_compact"], seg),
            ("streamed_apply", "streamed_update.cu", "cffm_tpu/ops/streamed_update.py:103",
             trained["adagrad_f32"]["streamed_rowwise_apply"], apply_errs["adagrad"]),
            ("streamed_apply_rowwise_adam", "streamed_update.cu",
             "cffm_tpu/ops/streamed_update.py:205",
             trained["rowwise_adam"]["streamed_rowwise_adam_apply"],
             apply_errs["rowwise_adam"]),
        ]
        records = [fwd] + [
            {"name": name, "route": "cuda", "source": f"cffm_tpu_torch/ops/csrc/{src}",
             "replaces": rep, "launches": launches, "max_abs_err": err,
             **{k: ttimes[name][k] for k in keys}, "batch": 65536}
            for name, src, rep, launches, err in new]
        records[-1]["train_step_ms_65536"] = ttimes["train_step_ms_65536"]
        records[1]["at_batch_4096"] = {k: ttimes["cross_conv1_bwd_4096"][k]
                                       for k in keys + ("max_abs_err",)}
        # kernels 6-7 at the T=1 shapes of the sharded step, T=4 rank 0 beside
        for name, src, rep, launches, err, tk in (
                ("sorted_segment_sum_by_seg", "sorted_segment.cu",
                 "cffm_tpu/ops/sorted_segment.py:245",
                 strained["adagrad_f32"]["sorted_segment_sum_by_seg"], k6_err, "k6"),
                ("bucketed_apply", "streamed_update.cu", "cffm_tpu/ops/streamed_update.py:278",
                 strained["adagrad_f32"]["bucketed_rowwise_apply"], k7_err, "k7")):
            records.append({
                "name": name, "route": "cuda", "source": f"cffm_tpu_torch/ops/csrc/{src}",
                "replaces": rep, "launches": launches, "max_abs_err": err,
                **{k: stimes[f"{tk}_t1"][k] for k in keys}, "batch": 65536, "shards": 1,
                "at_t4_rank0": {k: stimes[f"{tk}_t4"][k] for k in keys}})
        records[-1]["sgd_ms"] = stimes["k7_t1"]["sgd_ms"]
        records[-1]["at_t4_rank0"]["sgd_ms"] = stimes["k7_t4"]["sgd_ms"]
        records[-1]["sharded_step_ms_65536"] = stimes["sharded_step_ms_65536"]
        # kernels 8a, 8b (kernel 2 in the variants' layout) and 9: launches
        # from the scripts' runs in the tools phase
        bwd_launches = tools["bench_bwd_variants"]["launches"]
        for name, src, rep, key, err in (
                ("cross_conv1_bwd_v1", "cross_conv1_bwd_v1.cu",
                 "scripts/bench_bwd_variants.py:44", "v1", v1["max_abs_err"]),
                ("cross_conv1_bwd_v2", "cross_conv1_bwd.cu",
                 "scripts/bench_bwd_variants.py:144", "v2", v1["v2_max_abs_err"])):
            records.append({
                "name": name, "route": "cuda", "source": f"cffm_tpu_torch/ops/csrc/{src}",
                "replaces": rep, "launches": bwd_launches[f"bwd_{key}"],
                "max_abs_err": err, **{k: v1[key][k] for k in keys}, "batch": 65536})
        records.append({
            "name": "dot_orient_probe", "route": "cuda",
            "source": "cffm_tpu_torch/ops/csrc/dot_orient_probe.cu",
            "replaces": "scripts/probe_dot_orient.py:32",
            "launches": tools["probe_dot_orient"]["launches"]["dot_probe"],
            "max_abs_err": probe["max_abs_err"], **{k: probe["lane"][k] for k in keys},
            "by_mode": {m: {k: probe[m][k] for k in keys + ("tmac_s",)}
                        for m in ("lane", "sub", "rhs")}})
        print(json.dumps({"kernels": records}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

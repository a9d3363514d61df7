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
     against the plain backward: dE f32 rtol=atol=1e-4, bf16 2e-2 (the
     sliced hadamard bf16 dE at its ulp limit instead, as in parity_caps,
     on its first draw and on HADAMARD_SEEDS); dW rtol=1e-4 with atol
     1e-4 of max|dW|; pad lanes and diagonal blocks of dE exact zeros,
     the fused column exactly glin; dW bit-equal in two runs;
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
     split field-major entry at B=4096 with the phase-4 tolerances, each
     timed forward and forward + backward: C1=128 in bf16 (kernel 1,
     kernel 2 on wgmma) and in f32 (kernel 2 on the CUDA cores), C1=136
     in bf16 and f32 (the CUDA-core backward in two channel slices), k=9
     in bf16 and k=11 in bf16 and f32 (kernels 1 and 2 on the CUDA cores,
     k=11 on their run-time-k instantiations); C1=128 sliced hadamard in
     bf16 at k=3 and k=7, each on its first draw and on HADAMARD_SEEDS,
     dE within the ulp limit (one bf16 ulp of dE plus two of dE taken
     from |E|, |W|, |gY|; the first draw at rtol=atol=2e-2 too); k=9 and
     k=11 layer 1 and conv tail, forward and backward at B=4096 in f32
     through kernels 1 and 2 against the plain route in float64 (1e-4 of
     the largest value; at k=11 at most K11_MAX_FLIPS ReLU masks or pool
     picks apart, the examples they touch held with the card's decisions
     there); the gates' CPU rules equal the libraries' (kernel 7's width,
     and bwd_kernel_takes over 336 (d, k, C1, cross), k up to 13 and C1
     up to 256);
  5. parity_segment: kernel 3 on the sorted big-field ids of one B=65536
     synthetic criteo_kaggle batch (zipf, hot segments; two calls bit-equal)
     and on ids up to 2^31-2: uids and count exact, empty slots zero, gsum
     within half a bf16 ulp of the exact (f64) sums plus 4 * 2^-24 *
     sqrt(len * sum g^2) for the f32 sum's own error; then on the edge
     streams (`_edge_streams`: n = 0 and 1, one segment over 131 chunks of
     the tree's first pass, every entry its own segment, boundaries on the
     chunks', one entry off them and on the second pass's chunks, 20,000
     singletons and a tail segment of 280,000, a hot segment, a count past
     m_pad) at W = 128, 640 and 2048, small-integer grads bit for bit
     against the plain version and unit normals within that limit;
  6. parity_apply: kernels 4 and 5 on the full 2.6M x 640 table with that
     batch's uids and sums, f32 and bf16: rows outside uids bit-equal;
     touched rows within 1e-6 (f32) or one bf16 ulp (nearest); stochastic
     rounding within one ulp of nearest with a mean signed error near 0;
     kernels 4-5 bit-equal to kernel 7 at nb=1 on the same uids and sums
     in sgd, adagrad and rowwise_adam on f32 and bf16 (nearest) tables;
     the edges (no live slot, every slot live, live counts that end inside
     a block's share) and a 2560-lane table through the chunked route,
     each against the plain version with its launch counted; the route
     rule's CPU copy equal to the library's at every width to 8192;
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
  9a. learn: the flagship learn check through the training CLI
     (`cli.main` in process, the argv of `scripts.run_pending_experiments`'
     learn checks): criteo_kaggle, 300 steps at B=8192, log_every=50, 8
     eval batches, once with an f32 table and once with a bf16 table
     (stochastic rounding), launch counts set to 0 before and read after
     each; the loss curve, the eval and the launches printed; kernels 1
     and 2 launched, every logged train loss and the eval logloss at least
     LEARN_LOSS_DROP below ln 2 (the loss at the start), eval AUC above
     LEARN_MIN_AUC in both runs and the two AUCs within LEARN_MAX_AUC_GAP;
  9b. checkpoint: criteo_kaggle at full width (B=65536, f32 table,
     adagrad) in a temporary directory with room for three checkpoints
     (or it fails with the space it found): two train steps, a save and a
     restore into a state drawn from another seed (bytes, seconds and
     GB/s printed), every leaf bit-equal, one further step from each with
     loss and table bit-equal; train.run for 3 steps twice (the controls),
     then with a checkpoint_dir and a guard tripped as step 2 is logged
     (preempted_at_step 2), then again (resumes from step 2 and skips 2
     batches): auc, logloss and final_train_loss of the resumed run within
     the controls' own spread (bit-equal when they agree), kernels 1-4
     once a step and kernel 1 once an eval batch in each run; score.main
     from the checkpoint, 8 kernel-1 launches and exactly the metrics of
     score() on the restored params; export.main from it in f32, the
     artifact run at B=4096, 1000 and 1 against the eager scoring_fn
     (rtol=atol=1e-6) and score's kernel route (1e-4);
 10. step_vs_cpu: train steps from the same state and batches on the card
     and on the CPU (f32, f32 table, streamed update on, B=4096): one
     adagrad step, two rowwise-Adam steps;
 11. time kernels 2-5, their plain versions, library yardsticks and bounds
     at the B=65536 training shapes (kernel 2 at B=4096 too), hold kernel
     2 against its plain version there (the phase-4 checks), kernel 7 at
     nb=1 beside kernel 4, kernel 4 at the bench twin's shape (a bf16
     table, stochastic rounding, ~1.25M touched rows of bench.py's uniform
     ids), and time the train step end to end with a torch.profiler
     breakdown;
 12. parity_segment_by_seg: kernel 6 on the segment stream of one B=65536
     batch routed at T=1 and on rank 0's at T=4: within half a bf16 ulp of
     the exact sums plus the f32 term (phase 5's limit), slots past the
     count exact zeros, against its plain version, two calls bit-equal;
     then on phase 5's edge streams, as kernel 3 there;
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
     steps); with 4, as 2 hosts of 2 cards, also the hier step from the
     same shards against the flat step, the intra-host (2D) step against
     the single-device step with the hosts' replicas bit-equal, and the
     hier routing's overflow of each stage at multihost's own caps
     (cap_rows 8192, cap_rows_host 16384, B=32768); with one card it
     prints that it was not run;
 16. time kernels 6 and 7 at the T=1 and T=4 rank-0 shapes (kernel, plain,
     library yardstick: index_add_ of the sgd step, beside the kernel in
     sgd mode; bound) and the sharded step end to end with a
     torch.profiler breakdown;
 16b. train_hier: multihost at full width (26,000,832 x 640 bf16 table,
     adagrad, stochastic rounding, B=32768, kernel 7's apply forced on)
     through the hierarchical step on the NCCL group of one (H = C = 1): 2
     steps and 2 eval batches, launch counts set to 0 before and read
     after (kernels 1, 2 and 7 once a step, kernel 6 twice, kernel 1 once
     an eval batch), finite losses and AUC, each stage's overflow 0; then
     one criteo_kaggle adagrad step (f32 table, B=65536) of the hier step
     against the flat step from the same state and batch (loss rtol 1e-5,
     moved rows within 1e-2*max|delta|, other rows bit-equal, accumulator
     1e-6);
 16c. train_2d: criteo_kaggle with table_axis="intra_host" (H = C = 1,
     B=65536, f32 table, adagrad): 2 steps and an eval batch with launch
     counts (kernels 1, 2 and 6 once a step, 3, 4, 5 and 7 never), then
     one step against the single-device train_step at train_sharded's
     tolerances;
 16d. time_hier: the hier step end to end (multihost B=32768; criteo_kaggle
     B=65536 beside the flat step in turns), its profile, kernel 6 at the
     stage-2 input shape (two calls bit-equal; kernel, plain, index_add_
     yardstick, bound), and the intra-host step end to end with its
     profile;
 17. parity_bwd_v1: kernel 8a (ops.bwd_variants.bwd_v1) at criteo_kaggle
     shapes against its plain version and against kernel 2 (bwd_v0), and
     row 8b (bwd_v2, kernel 2 from the variants' weights) against the
     plain version, each case's route checked (V1_CASES): k=3 at B=512
     in f32 (the CUDA-core kernels) and at B=1, 7, 131, 4096 and 65536 in
     bf16 (kernel 8a on wgmma), every other wgmma instantiation (k, C1) at
     B=131 and C1 = 48, 16 and 8 there with zero channels added, k=5 at
     C1=64 (CUDA cores), k=9 at B=512 in f32 and bf16 (CUDA cores),
     and kernel 8a alone at C1=72 in bf16, B=512 (its bf16 CUDA-core
     kernel, at the phase-4 tolerances); bf16 dE
     within one bf16 ulp of the product plus two ulps of the product
     taken from |E|, |W|, |g| (and at the phase-4 tolerances; f32 at
     rtol=atol=1e-4 against kernel 2), dW at 1e-4 of
     max|dW|, pad lanes, diagonal blocks and dW's pad rows exact zeros, the
     fused column exactly glin, dW bit-equal in two runs; then kernel 8a
     and kernel 2 in the variants' layout (row 8b) timed at B=65536;
 18. parity_dot_probe: kernel 9's three modes (wgmma, K-major and MN-major
     operands) against the plain version at the probe's shapes and at a
     ragged shape (rtol 1e-5, atol 1e-5 of max|out|), its grid against the
     CPU rule, timed with TMAC/s and the MN-major modes' time against
     lane's, torch.matmul as the yardstick;
 19. tools: main(argv) of `python -m cffm_tpu_torch.bench` (--feed=staged,
     score, sharded), of the scripts bench_kernel, bench_bwd_variants
     --check, probe_dot_orient, bench_apply, profile_step full,
     trace_step, measure_id_stats (multihost's hier stage occupancy at
     B=32768 on 1, 2x2 and 2x8 cards), bench_scaling --hier=1x1,
     check_onchip_parity (kernels 1-4 on the JAX sweep's cases; it must end
     ONCHIP PARITY: OK), profile_sparse update,segkernel,apply (kernels
     3-4), profile_sharded_step and trace_sharded (kernels 1, 2, 6 and 7),
     probe_gather, probe_h2d and run_pending_experiments
     --only=probe_gather (the runner, one experiment in a subprocess), in
     process, launch counts set to 0 before and read after each: exit code
     0, each kernel of its path launched, and each bench line with a value
     and the card;
 20. data: the data layer at criteo_kaggle's B=65536: the native parser
     built from native/cffm_native.cpp; a Criteo TSV of 13 x 65536 rows and
     an Avazu CSV of 2 x 65536 rows written from a seed; the native-mt,
     native and Python readers bit-equal on both (host ms per batch of
     each); the reader's rows/s at 1, 2, 4 and 8 threads and the .cfb
     read (scripts.bench_input); train.run on the TSV at full width for 3
     steps with eval_batches=0 (a full pass over the held-out split, its
     last batch padded), once with device_prefetch and once with a
     synchronous copy in its place: kernels 1-4 launched (kernel 1 once
     per step and per eval batch), the native-mt route's chunk parser
     called, the eval count equal to the split's rows, and losses, eval
     and every state leaf bit-equal between the two; the H2D bytes and ms
     of a raw and a packed batch from pinned memory, the packed batch's
     unpack on the card (its ids equal to the raw batch's) and its pack
     on the host; and
     the bench's staged, reader and prehashed feeds in one call, kernels
     1-4 launched in each;
 21. lookup: the field-major lookup kernel (ops/embed_lookup) on one
     B=65536 criteo_kaggle batch of the benchmark's zipf traffic
     (benchmark/traffic/train_zipf.json): bit-equal to its plain version
     for f32 and bf16 tables and int32, int64 and strided ids; one launch
     in a train step and one in a forward; then timed with CUDA events:
     the kernel, its plain version, the chain the port ran before it
     (index_select, the cast and where, the library yardstick) and its
     bound (the outputs written once, the distinct rows and the ids read
     once);
 22. conv_tail: the conv tail's kernel (ops/interaction_conv.conv_tail) at
     criteo_kaggle's (64, 64) and movielens' (32, 32) channels, B = 65536,
     65537, 1000, 17 and 1, f32 and bf16 weights: with one-hot conv-2
     weights (one tap of one channel each, so every sum is exact) equal to
     its plain version, which holds layer 1's bias, ReLU and pool bit for
     bit; with drawn weights within `tail_limit` (the two roundings of conv
     2 and its bias add, and the f32 sums' own error), with the features
     more than one bf16 ulp apart counted; then timed with CUDA events
     beside its plain version (the eager chain) and its bound (y read once,
     the features written once). Its backward (ops/interaction_conv.
     conv_tail_bwd) at the same widths, batches and weight dtypes against
     its plain version and against eager autograd through the forward's
     plain version: with one-hot conv-2 weights and with values on coarse
     grids (every sum behind gy exact) gy equal, the weight and bias
     gradients within `grad_close`; with drawn weights each gradient's norm
     gap within 1e-2 of the plain version's (a pool window whose two values
     conv 2's sum order rounds apart routes its gradient elsewhere), with
     gy's elements more than one bf16 ulp apart counted; two calls bit-equal; timed beside
     the eager chain's forward and backward, the Function's forward and
     backward, and its bound (y and g read once, gy written once). A train
     step at the cells' B=65536 launches the forward and the backward once
     each, a forward without a gradient the forward once and the backward
     never.
 23. train_full: criteo_full through train.run on one card (its launches,
     the dither's draws, the loss);
 24. scatter: the scatter route's kernels (ops/sorted_segment.
     scatter_segment_sum, ops/streamed_update.scatter_rowwise_apply)
     through check_onchip_parity's check_scatter_update at full-train-zipf's
     shapes, then each timed beside the eager chain they replaced and its
     bound.

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
                  "streamed_update", "cross_conv1_bwd_v1", "dot_orient_probe", "embed_lookup",
                  "conv_tail"]


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
# seeds of the sliced hadamard bf16 draws after the first (phase 4 and
# parity_caps hold dE at its ulp limit on each)
HADAMARD_SEEDS = (0, 1, 2, 3)


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


def _hadamard_de_over_seeds(cfg, first, what: str):
    """The sliced hadamard bf16 backward at B=4096 on the first draw and on
    HADAMARD_SEEDS: dE at its ulp limit (sweep_bwd_seeds.de_limit_ratio: one
    bf16 ulp of dE plus two of dE taken from |E|, |W| and |gY|), dW at 1e-4
    of max|dW|; prints the elements outside rtol=atol=2e-2. Where dE's sum
    over pairs cancels, one dM rounded to its other bf16 neighbour stands
    out against dE: 2e-2 is no limit of that arithmetic."""
    import torch

    from cffm_tpu_torch.scripts import sweep_bwd_seeds as sweep

    for which, seed in [("first draw", None)] + [(f"seed {s}", s) for s in HADAMARD_SEEDS]:
        x = first if seed is None else sweep.draw(
            cfg, 4096, torch.Generator(device="cuda").manual_seed(seed))
        r = sweep.backward(cfg, *x)
        m = sweep.report(r)
        print(f"parity_bwd {what} bfloat16 B=4096 {which}: dE max_abs_err={m['de_err']:.3e}, "
              f"{m['outside_2e-2']} elements outside rtol=atol=2e-2, {m['ulp_ratio']:.3f} of "
              f"the ulp limit (one bf16 ulp of dE plus two of dE taken from |E|, |W|, |gY|)",
              flush=True)
        if m["ulp_ratio"] > 1 or r["launches"] != 1:
            fail(f"parity_bwd {what} {which}: dE beyond its ulp limit or not the kernel")
        _check_dw(r["dw"], r["dw_ref"], f"{what} bfloat16 {which}")
        del r


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
            if cross == "hadamard" and dtype == torch.bfloat16:
                _hadamard_de_over_seeds(mcfg, (emb, w1, gy), f"movielens sliced {cross} d={d}")
                continue
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


def _check_segments(ss, sid, grads, m_pad: int, what: str, exact: bool = False,
                    verbose: bool = True) -> tuple:
    """Kernel 3 against its plain version (uids and count exact; gsum bit
    for bit too when `exact`: every sum exact in f32) and the exact sums:
    (largest difference from the plain version, `_check_sums`' share)."""
    import torch

    uids, gsum, count = ss.sorted_segment_sum_compact(sid, grads, m_pad)
    seg, count_ref = ss.segments(sid)
    uids_ref, gsum_ref = ss.sorted_segment_sum_reference(sid, seg, grads.to(torch.bfloat16),
                                                         m_pad)
    if not torch.equal(uids, uids_ref) or int(count) != int(count_ref):
        fail(f"parity_segment {what}: uids or count differ")
    if exact and not torch.equal(gsum, gsum_ref):
        fail(f"parity_segment {what}: exact sums differ from the plain version's")
    max_id = int(sid.max()) if sid.numel() else None
    share = _check_sums("parity_segment", gsum, seg, grads, int(count),
                        f"{what}: n={sid.numel()} count={int(count)} m_pad={m_pad} max id "
                        f"{max_id}: uids and count exact,", verbose)
    return _max_diff(gsum, gsum_ref), share


def _max_diff(a, b) -> float:
    return (a.float() - b.float()).abs().max().item() if a.numel() else 0.0


def _check_sums(phase: str, gsum, seg, grads, c: int, what: str,
                verbose: bool = True) -> float:
    """The kernel's bf16 segment sums against the exact (f64) sums of the
    bf16 grads, and zero rows past the count (segments at or past m_pad
    are dropped); returns the worst entry's share of its limit."""
    import torch

    # the kernel's bf16 result is its f32 sum rounded to nearest: half a bf16
    # ulp, plus the f32 sum's own error, for which 4 * 2^-24 * sqrt(len *
    # sum g^2) (len times the segment's RMS) stands ~30x above the spread of
    # sequential f32 sums of random signs and far below one entry of a hot
    # segment. An exact sum halfway between two bf16 values (a tie) sits at
    # 1.000 of its limit.
    c = min(c, gsum.shape[0])
    if (gsum[c:] != 0).any():
        fail(f"{phase} {what} empty slots hold nonzero rows")
    if c == 0:
        return 0.0
    keep = seg < c
    sl = seg[keep].long()
    g64 = grads[keep].to(torch.bfloat16).double()
    exact = torch.zeros((c, grads.shape[1]), dtype=torch.float64,
                        device=seg.device).index_add_(0, sl, g64)
    sumsq = torch.zeros_like(exact).index_add_(0, sl, g64 * g64)
    del g64
    runs = torch.zeros((c,), dtype=torch.float64, device=seg.device).index_add_(
        0, sl, torch.ones_like(sl, dtype=torch.float64))
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
    if bad or verbose:
        print(f"{phase} {what} longest segment {int(runs[hot])} entries, gsum "
              f"max_abs_err={err.max().item():.3e} against the exact sums, {bad} entries "
              f"beyond half a bf16 ulp + the f32 term (f32 term on the longest segment at most "
              f"{f32_term[hot].max().item():.3e}; worst entry at {ratio.max().item():.3f} of "
              f"its limit: kernel {got[row, col].item():.6e}, exact "
              f"{exact[row, col].item():.6e}, segment of {int(runs[row])}); rows past the "
              f"count exact zeros", flush=True)
    if bad:
        fail(f"{phase} {what} gsum beyond half a bf16 ulp + the f32 term")
    return ratio.max().item()


def _edge_streams():
    """Kernels 3 and 6's edge streams, against the tree's chunks (level 0's
    CHUNK0 entries, level 1's CHUNK0 * CHUNK_N): [(name, seg (n,) numpy,
    m_pad)]; m_pad bounds the count in all but the last."""
    import numpy as np

    from cffm_tpu_torch.ops.sorted_segment import CHUNK0, CHUNK_N

    k0, k1, ar = CHUNK0, CHUNK0 * CHUNK_N, np.arange
    rng = np.random.default_rng(12)
    steps = (rng.random(200_000) < 0.1).astype(np.int64)
    steps[0], steps[70_000:120_000] = 0, 0  # a hot segment of 50,000 entries
    streams = [
        ("n=0", ar(0)),
        ("n=1", ar(1)),
        (f"one segment over {131 * k0 + 5} entries (131 chunks)", np.zeros(131 * k0 + 5)),
        ("every entry its own segment", ar(70_000)),
        ("boundaries on the chunks'", ar(40 * k0) // k0),
        ("boundaries one entry past the chunks'", np.maximum(ar(40 * k0 + 7) - 1, 0) // k0),
        ("boundaries one entry before the chunks'", (ar(40 * k0) + 1) // k0),
        ("boundaries on level 1's chunks", ar(5 * k1 + 3) // k1),
        ("20,000 singletons then a tail segment of 280,000 (stage 2 scaled)",
         np.minimum(ar(300_000), 20_000)),
        ("random steps with a hot segment of 50,000", np.cumsum(steps)),
    ]
    out = [(name, seg.astype(np.int32), (-(-(int(seg[-1]) + 1 if seg.size else 0) // 128)
                                          + 1) * 128) for name, seg in streams]
    return out + [("count 10,000 past m_pad 4096", (ar(30_000) // 3).astype(np.int32), 4096)]


def _segment_edges(entry: str) -> float:
    """Kernel 3 or 6 (entry "k3" or "k6") on every edge stream at W = 128,
    640 and 2048: small-integer grads (every sum exact in f32) bit for bit
    against the plain version, unit-normal grads against the exact sums
    (`_check_sums`). Returns the largest difference from the plain
    version."""
    import torch

    from cffm_tpu_torch.ops import sorted_segment as ss

    phase = "parity_segment" if entry == "k3" else "parity_segment_by_seg"
    gen = torch.Generator(device="cuda").manual_seed(13)
    err = 0.0
    for name, seg_np, m_pad in _edge_streams():
        n = seg_np.size
        seg = torch.from_numpy(seg_np).cuda()
        count = int(seg[-1]) + 1 if n else 0
        worst = 0.0
        for w in (128, 640, 2048):
            for kind in ("integer", "normal"):
                if kind == "integer":
                    g = torch.randint(-4, 5, (n, w), generator=gen, device="cuda")
                else:
                    g = torch.randn((n, w), generator=gen, device="cuda")
                g = g.to(torch.bfloat16)
                what = f"edge {name} W={w} {kind} grads"
                if entry == "k3":
                    diff, share = _check_segments(ss, seg * 3 + 5, g, m_pad, what,
                                                  kind == "integer", verbose=False)
                else:
                    gsum = ss.sorted_segment_sum_by_seg(seg, g, m_pad)
                    plain = ss.sorted_segment_by_seg_reference(seg, g, m_pad)
                    if kind == "integer" and not torch.equal(gsum, plain):
                        fail(f"{phase} {what}: exact sums differ from the plain version's")
                    diff = _max_diff(gsum, plain)
                    share = _check_sums(phase, gsum, seg, g, count, what, verbose=False)
                    del gsum, plain
                err, worst = max(err, diff), max(worst, share)
            del g
        print(f"{phase} edge {name}: n={n} count={count} m_pad={m_pad}, W=128/640/2048: "
              f"integer grads bit-equal to the plain version, normal grads within the limit "
              f"(worst {worst:.3f} of it)", flush=True)
        torch.cuda.empty_cache()
    return err


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
    err = _check_segments(ss, sid, grads, m_pad, "criteo_kaggle B=65536 big fields")[0]
    uids, gsum, count = ss.sorted_segment_sum_compact(sid, grads, m_pad)
    again = ss.sorted_segment_sum_compact(sid, grads, m_pad)
    if not (torch.equal(uids, again[0]) and torch.equal(gsum, again[1])):
        fail("parity_segment criteo_kaggle B=65536: two calls differ")
    del grads, again

    wide = torch.randint(0, 2**31 - 1, (100_000,), generator=gen, device="cuda",
                         dtype=torch.int32)
    wide[:5000] = 2**31 - 2
    wide[5000:6000] = 1 << 24
    wide[6000:7000] = (1 << 16) + 1
    wide_sid = torch.sort(wide).values
    wide_g = torch.randn((wide_sid.numel(), 128), generator=gen, device="cuda")
    _check_segments(ss, wide_sid, wide_g, padded_entries(wide_sid.numel(), 512),
                    "ids up to 2^31-2")
    err = max(err, _segment_edges("k3"))
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


def _apply(su, route: str, mode: str, table, state: dict, uids, gsum):
    """One update of table and state, in place: kernels 4-5 ("k4"), kernel
    7 at nb=1 over the same uids and sums ("k7") or the plain version
    ("plain"); lr 0.05, eps 1e-8, Adam's b1 0.9, b2 0.999 at step 3."""
    lr, eps, b1, b2, t = 0.05, 1e-8, 0.9, 0.999, 3
    if route == "plain":
        extra = su._adam_extra(b1, b2, t) if mode == "rowwise_adam" else ()
        su.streamed_apply_reference(table, state, uids, gsum, su._hyper(lr, eps, extra), mode)
    elif mode == "rowwise_adam":
        if route == "k4":
            su.streamed_rowwise_adam_apply(table, state["m"], state["v"], uids, gsum, lr, eps,
                                           b1, b2, t)
        else:
            su.bucketed_rowwise_adam_apply(table, state["m"], state["v"], uids[None],
                                           gsum[None], lr, eps, b1, b2, t)
    elif route == "k4":
        su.streamed_rowwise_apply(table, state.get("accum"), uids, gsum, lr, eps)
    else:
        su.bucketed_rowwise_apply(table, state.get("accum"), uids[None], gsum[None], lr, eps)


def _apply_state(mode: str, v: int, w: int, seed: int) -> dict:
    """The optimizer state of a (v, w) table, drawn from seed."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    if mode == "adagrad":
        return {"accum": torch.rand((v, 1), generator=gen, device="cuda") + 0.1}
    if mode == "rowwise_adam":
        return {"m": torch.randn((v, w), generator=gen, device="cuda") * 0.01,
                "v": torch.rand((v, 1), generator=gen, device="cuda") * 1e-4}
    return {}


def _k4_equals_k7(su, mode: str, base, uids, gsum, what: str):
    """Kernels 4-5 and kernel 7 at nb=1 from the same table and state on
    the same uids and sums: bit-equal results, one launch each; where they
    part, the first differing element is printed before the run fails."""
    import torch

    v, w = base.shape
    t4, t7 = base.clone(), base.clone()
    s4, s7 = _apply_state(mode, v, w, 9), _apply_state(mode, v, w, 9)
    k4 = su.streamed_rowwise_adam_apply if mode == "rowwise_adam" else su.streamed_rowwise_apply
    k7 = su.bucketed_rowwise_adam_apply if mode == "rowwise_adam" else su.bucketed_rowwise_apply
    n4, n7 = k4.launches, k7.launches
    _apply(su, "k4", mode, t4, s4, uids, gsum)
    _apply(su, "k7", mode, t7, s7, uids, gsum)
    if k4.launches - n4 != 1 or k7.launches - n7 != 1:
        fail(f"parity_apply {what}: kernel 4 or kernel 7 not launched once")
    for name, a, b in [("table", t4, t7)] + [(k, s4[k], s7[k]) for k in s4]:
        if not torch.equal(a, b):
            diff = (a != b).reshape(a.shape[0], -1)
            row = int(diff.any(dim=1).nonzero()[0])
            col = int(diff[row].nonzero()[0])
            fail(f"parity_apply {what}: kernel 4 and kernel 7 at nb=1 part in {name}: "
                 f"{int(diff.any(dim=1).sum())} rows, first at ({row}, {col}): "
                 f"{a[row, col].item()!r} against {b[row, col].item()!r}")
    del t4, t7, s4, s7


def _apply_edges(su) -> float:
    """Kernels 4-5 at the edges of their live range and on each route, f32
    and bf16 (nearest) tables: against the plain version (1e-6; one bf16
    ulp, plus 4 f32 ulps of the operands where the step cancels the value)
    with rows outside the uids bit-equal, bit-equal to kernel 7 at
    nb=1 where it takes the width, one launch each. NaN in every sentinel
    slot's sums: they are never read. Returns the largest f32 error."""
    import numpy as np
    import torch

    rng = np.random.default_rng(10)
    cases = []  # (what, v, w, live rows, slots)
    for live, slots in ((0, 1024), (4096, 4096), (13, 8192), (4101, 8192)):
        cases.append((f"{live} live of {slots} slots", 50_000, 640, live, slots))
    for w in (384, 1024, 2560):
        cases.append((f"W={w} route {su.streamed_route(w, 'cuda')}", 100_000, w, 6000, 8192))
    worst = 0.0
    for what, v, w, live, slots in cases:
        rows = np.sort(rng.choice(np.arange(1, v - 1), size=max(live - 2, 0), replace=False))
        rows = np.unique(np.concatenate([[0, v - 1], rows]))[:live]
        uids = torch.full((slots,), v, dtype=torch.int32, device="cuda")
        uids[:live] = torch.from_numpy(rows.astype(np.int32)).cuda()
        gen = torch.Generator(device="cuda").manual_seed(11)
        gsum = (torch.randn((slots, w), generator=gen, device="cuda") * 0.01).to(torch.bfloat16)
        gsum[live:] = float("nan")
        touched = torch.zeros((v,), dtype=torch.bool, device="cuda")
        touched[uids[:live].long()] = True
        base = torch.randn((v, w), generator=gen, device="cuda") * 0.01
        for dtype in (torch.float32, torch.bfloat16):
            b = base.to(dtype)
            for mode in ("sgd", "adagrad", "rowwise_adam"):
                name = f"{what} {mode} {str(dtype).removeprefix('torch.')}"
                tk, tr = b.clone(), b.clone()
                sk, sr = _apply_state(mode, v, w, 12), _apply_state(mode, v, w, 12)
                k4 = (su.streamed_rowwise_adam_apply if mode == "rowwise_adam"
                      else su.streamed_rowwise_apply)
                n0 = k4.launches
                _apply(su, "k4", mode, tk, sk, uids, gsum)
                _apply(su, "plain", mode, tr, sr, uids, gsum)
                if k4.launches - n0 != 1:
                    fail(f"parity_apply edge {name}: kernel 4 not launched once")
                bf16 = dtype == torch.bfloat16
                err = _compare_tables(tk, tr, b, touched, False, f"edge {name}")
                if bf16:
                    # one bf16 ulp, plus 4 f32 ulps of the operands where the
                    # step cancels the value: the two round the step apart in f32
                    lim = _bf16_ulp(tr) + 2.0**-22 * (b.float().abs() + tr.float().abs())
                    err = ((tk.float() - tr.float()).abs() / lim).max().item()
                base_s = _apply_state(mode, v, w, 12)
                for k in sk:
                    err = max(err, _compare_tables(sk[k], sr[k], base_s[k], touched, False,
                                                   f"edge {name} {k}"))
                if err > (1 if bf16 else 1e-6) or not torch.isfinite(tk.float()).all():
                    fail(f"parity_apply edge {name}: {err:.3e} from the plain version")
                if not bf16:
                    worst = max(worst, err)
                if su.bucketed_kernel_takes(w, "cuda"):
                    _k4_equals_k7(su, mode, b, uids, gsum, f"edge {name}")
                del tk, tr, sk, sr, base_s
        print(f"parity_apply edge {what} (V={v}, W={w}): sgd, adagrad, rowwise_adam on f32 "
              f"and bf16 tables against the plain version (f32 max_abs_err so far "
              f"{worst:.3e}, limit 1e-6; bf16 within its limit), untouched rows bit-equal, "
              + ("bit-equal to kernel 7 at nb=1" if su.bucketed_kernel_takes(w, "cuda")
                 else "past kernel 7's width"), flush=True)
        del base, gsum, uids, touched
        torch.cuda.empty_cache()
    return worst


def phase_parity_apply(seg_out) -> dict:
    """Kernels 4 and 5 against the plain apply on the full table, against
    kernel 7 at nb=1, at their edges and on both routes."""
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
    del tk, tr, ts, exact

    # kernels 4-5 against kernel 7 at nb=1 on the batch's uids and sums
    for dtype in (torch.bfloat16, torch.float32):
        b = b16 if dtype == torch.bfloat16 else b16.float()
        for mode in ("sgd", "adagrad", "rowwise_adam"):
            _k4_equals_k7(su, mode, b, uids_s, gsum,
                          f"{mode} {str(dtype).removeprefix('torch.')} full table")
        del b
        torch.cuda.empty_cache()
    print("parity_apply: kernels 4-5 bit-equal to kernel 7 at nb=1 (table and state) in sgd, "
          "adagrad and rowwise_adam on f32 and bf16 (nearest) tables", flush=True)
    del b16
    torch.cuda.empty_cache()
    apart = [w for w in range(-64, 8193, 32)
             if su.streamed_route(w) != su.streamed_route(w, "cuda")]
    print(f"parity_apply: streamed_route's CPU rule against the library at widths -64..8192 "
          f"by 32: {len(apart)} apart {apart[:4]}", flush=True)
    if apart:
        fail("parity_apply: the route rule's CPU copy differs from the library's")
    errs["edges"] = _apply_edges(su)
    return errs


def _run_cfg(overrides: dict, name: str = "criteo_kaggle"):
    """A named config (criteo_kaggle) with dotted overrides, as the command
    line takes them."""
    from cffm_tpu_torch.cli import _apply_override
    from cffm_tpu_torch.config import get_config

    cfg = get_config(name)
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
    """The launch-counted wrappers of kernels 3-7 and the scatter route's."""
    return (ss.sorted_segment_sum_compact, ss.sorted_segment_sum_by_seg,
            ss.scatter_segment_sum, su.streamed_rowwise_apply,
            su.streamed_rowwise_adam_apply, su.scatter_rowwise_apply,
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
        # the small-field prefix's update: one scatter_rowwise_apply a step
        "adagrad_f32": (3, {}, {"cross_conv1_lin_fm2": 3 + 2, "cross_conv1_bwd": 3,
                                "sorted_segment_sum_compact": 3,
                                "streamed_rowwise_apply": 3, "scatter_rowwise_apply": 3}),
        "adagrad_bf16_table": (2, {"model.table_dtype": "bfloat16"},
                               {"cross_conv1_lin_fm2": 2 + 2, "cross_conv1_bwd": 2,
                                "sorted_segment_sum_compact": 2,
                                "streamed_rowwise_apply": 2, "scatter_rowwise_apply": 2}),
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


# criteo_full's run through train.run: its steps and the loss bar
FULL_STEPS = 60


def phase_train_full() -> dict:
    """criteo_full at its widths on one card through train.run: a
    26,000,832 x 640 bf16 table with stochastic rounding, B=32768, the
    scatter sparse update (852k big-field ids are under 8% of the rows)
    through its kernels (the live rows' sums, kernel 4's apply),
    FULL_STEPS steps and 2 eval batches, launch counts and the dither's
    draws set to 0 before and read after. Every dither is drawn on the
    card (two a step: the touched rows and the prefix), and the last
    logged loss and the eval logloss lie below ln 2."""
    import torch

    from cffm_tpu_torch import train
    from cffm_tpu_torch.ops import rounding

    steps, ev = FULL_STEPS, 2
    cfg = _run_cfg({"data.num_train_steps": steps, "data.eval_batches": ev, "log_every": 10},
                   "criteo_full")
    m = cfg.model
    logs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    draws = dict(rounding.DRAWS)
    t0 = time.perf_counter()
    result = train.run(cfg, device="cuda", log_fn=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    drawn = {k: rounding.DRAWS[k] - draws.get(k, 0) for k in rounding.DRAWS}
    recs = [json.loads(x) for x in logs if '"loss"' in x]
    losses = [(r["step"], r["loss"], round(r["examples_per_s"])) for r in recs]
    # scatter_rowwise_apply twice a step: the big fields' live rows and the
    # small-field prefix
    want = {"cross_conv1_lin_fm2": steps + ev, "cross_conv1_bwd": steps,
            "scatter_segment_sum": steps, "scatter_rowwise_apply": 2 * steps}
    launched = {k: v for k, v in counts.items() if v}
    print(f"train_full criteo_full: {m.total_vocab} x {m.table_width} {m.table_dtype} table "
          f"({m.total_vocab * m.table_width * 2 / 1e9:.2f} GB), rounding "
          f"{cfg.optim.table_rounding}, B={cfg.data.batch_size}, {steps} steps: (step, loss, "
          f"ex/s) {losses}, eval {json.dumps(result)}, launches {launched}, dither draws "
          f"{drawn}, wall {wall:.1f}s incl. data, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    if not all(math.isfinite(x) for _, x, _ in losses) or not math.isfinite(result["logloss"]):
        fail("train_full: loss not finite")
    if any(n != want.get(k, 0) for k, n in counts.items()):
        fail(f"train_full: want launches {want}, got {launched}")
    if drawn.get("cpu", 0) or drawn.get("cuda", 0) != 2 * steps:
        fail(f"train_full: want {2 * steps} dithers drawn on the card and none on the "
             f"host, got {drawn}")
    if not (losses and losses[-1][1] < math.log(2) and result["logloss"] < math.log(2)):
        fail(f"train_full: the loss did not fall below ln 2 = {math.log(2)}: {losses}, "
             f"eval logloss {result['logloss']}")
    return {"losses": losses, "eval": result, "launches": launched, "draws": drawn,
            "steps": steps}


def phase_scatter() -> dict:
    """The scatter route's kernels (`ops/sorted_segment.scatter_segment_sum`,
    `ops/streamed_update.scatter_rowwise_apply`): check_onchip_parity's
    check_scatter_update (its largest gaps kept), then each timed at
    full-train-zipf's shapes
    (851,968 bf16 grads of 640 lanes, 26 fields of zipf ids into a
    26,000,832-row bf16 table rounded stochastically, adagrad) beside the
    eager chain they replaced (`rowwise._segment_sums`, the slice and
    `streamed_update.eager_rowwise_apply`), its sums and its apply apart,
    and their
    bounds."""
    import numpy as np
    import torch

    from cffm_tpu_torch.config import OptimizerConfig
    from cffm_tpu_torch.ops import sorted_segment as ss
    from cffm_tpu_torch.ops import streamed_update as su
    from cffm_tpu_torch.optim import rowwise
    from cffm_tpu_torch.scripts import check_onchip_parity as cop

    errs = {}
    if not cop.check_scatter_update("cuda", errs):
        fail("scatter: the scatter route's kernels disagree with the eager route")
    b, buckets, w = *cop.SCATTER_CASES["cuda"], cop.SCATTER_W
    v = cop.SCATTER_PREFIX + cop.SCATTER_FIELDS * buckets
    ids = torch.from_numpy(cop._scatter_ids(b, buckets, np.random.default_rng(13))).cuda()
    big = ids.numel()
    gen = torch.Generator(device="cuda").manual_seed(8)
    grads = (1e-3 * torch.randn((big, w), generator=gen, device="cuda")).to(torch.bfloat16)
    table = torch.empty((v, w), dtype=torch.bfloat16, device="cuda")
    for r in range(0, v, 1 << 22):
        table[r:r + (1 << 22)] = (0.01 * torch.randn((min(1 << 22, v - r), w), generator=gen,
                                                    device="cuda")).to(torch.bfloat16)
    opt = OptimizerConfig(sparse_optimizer="adagrad", sparse_lr=0.05,
                          table_rounding="stochastic")
    accum = rowwise.rowwise_init(table, opt)["accum"]
    order, seg, uids, bounds = rowwise.scatter_plan(ids, v, big + 1)
    lo, n = bounds()
    live = uids[lo:lo + n]
    s = ss.scatter_segment_sum(order, seg, grads, lo, n)
    key = torch.Generator().manual_seed(1)
    lr = torch.tensor(0.05)

    def sums():
        ss.scatter_segment_sum(order, seg, grads, lo, n)

    def apply():
        su.scatter_rowwise_apply(table, {"accum": accum}, live, s, opt, lr, key)

    def eager_sums():
        return rowwise._segment_sums(grads, order, seg, uids.shape[0])[lo:lo + n]

    def eager_apply():
        su.eager_rowwise_apply(table, {"accum": accum}, live.long(), s, opt, lr, key)

    def eager():
        su.eager_rowwise_apply(table, {"accum": accum}, live.long(), eager_sums(), opt, lr, key)

    reps = 20
    out = {"live_rows": n, "ids": big, **errs,
           "sums": {"ms": cuda_ms(sums, reps), "plain_ms": cuda_ms(eager_sums, reps),
                    **_bound(big * w * 2 + big * 12 + n * w * 4, big * w, "float32")},
           "apply": {"ms": cuda_ms(apply, reps), "plain_ms": cuda_ms(eager_apply, reps),
                     **_bound(n * (4 + w * 4 + w * 2 * 2 + 8), n * w * 6, "float32")},
           "eager_chain_ms": cuda_ms(eager, reps)}
    for part in ("sums", "apply"):
        out[part]["library_ms"] = out[part]["plain_ms"]
        out[part]["share_of_bound"] = out[part]["bound_ms"] / out[part]["ms"]
    out["kernels_ms"] = out["sums"]["ms"] + out["apply"]["ms"]
    print(f"scatter at full-train-zipf's shapes ({big} ids, {n} live rows, W={w}, "
          f"{v} x {w} bf16 table, stochastic, adagrad): {json.dumps(out)}", flush=True)
    return out


# the learn check's bars: eval AUC of each run, and the f32 and bf16 runs' gap
LEARN_MIN_AUC = 0.60
LEARN_MAX_AUC_GAP = 0.005
# every logged train loss and the eval logloss sit this far below ln 2, the
# loss at the start (the init's logits are near 0; the loss reaches its floor
# before the first log at step 50)
LEARN_LOSS_DROP = 0.01


def phase_learn() -> dict:
    """The flagship learn check: criteo_kaggle through the training CLI
    (cli.main, in process) at 300 steps of B=8192 with an f32 and with a
    bf16 table; returns each run's losses, eval and launch counts."""
    import contextlib
    import io

    import torch

    from cffm_tpu_torch import cli
    from cffm_tpu_torch.scripts.run_pending_experiments import LEARN

    out = {}
    for name, extra in (("f32_table", []), ("bf16_table", ["model.table_dtype=bfloat16"])):
        argv = list(LEARN) + extra
        buf = io.StringIO()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        recs = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
        losses = [(r["step"], r["loss"]) for r in recs if "loss" in r]
        ev = [r["eval"] for r in recs if "eval" in r and "step" not in r]
        launched = {k: v for k, v in counts.items() if v}
        print(f"learn {name}: python -m cffm_tpu_torch.train {' '.join(argv)} -> rc {rc} in "
              f"{wall:.1f}s", flush=True)
        print(f"learn {name}: loss by step {losses}", flush=True)
        print(f"learn {name}: eval {json.dumps(ev[-1] if ev else None)}", flush=True)
        print(f"learn {name}: launches {launched}", flush=True)
        if rc != 0 or not ev or len(losses) != 6:
            fail(f"learn {name}: rc {rc}, {len(losses)} logged losses, eval {ev}")
        if not (counts["cross_conv1_lin_fm2"] and counts["cross_conv1_bwd"]):
            fail(f"learn {name}: kernels 1 and 2 did not both launch ({launched})")
        worst = max([x for _, x in losses] + [ev[-1]["logloss"]])
        if not worst <= math.log(2) - LEARN_LOSS_DROP:
            fail(f"learn {name}: the loss did not fall clearly from ln 2 = {math.log(2)}: "
                 f"losses {losses}, eval logloss {ev[-1]['logloss']}")
        if not ev[-1]["auc"] > LEARN_MIN_AUC:
            fail(f"learn {name}: eval AUC {ev[-1]['auc']} not above {LEARN_MIN_AUC}")
        out[name] = {"losses": losses, "eval": ev[-1], "launches": launched, "wall_s": wall}
        torch.cuda.empty_cache()
    gap = abs(out["f32_table"]["eval"]["auc"] - out["bf16_table"]["eval"]["auc"])
    print(f"learn: eval AUC f32 table {out['f32_table']['eval']['auc']}, bf16 table "
          f"{out['bf16_table']['eval']['auc']}, gap {gap}", flush=True)
    if not gap < LEARN_MAX_AUC_GAP:
        fail(f"learn: the f32 and bf16 tables' AUCs lie {gap} apart "
             f"(limit {LEARN_MAX_AUC_GAP})")
    return out


def _unequal_leaves(a, b) -> list:
    """Paths of the leaves of two TrainStates that are not bit-equal, or
    not on the same device in the same dtype."""
    import torch

    from cffm_tpu_torch.checkpoint import state_leaves

    la, lb = state_leaves(a), state_leaves(b)
    if la.keys() != lb.keys():
        return sorted(la.keys() ^ lb.keys())
    bad = []
    for k, x in la.items():
        y = lb[k]
        if isinstance(x, torch.Tensor):
            same = (x.dtype, x.device, x.shape) == (y.dtype, y.device, y.shape)
            if not (same and torch.equal(x, y)):
                bad.append(k)
        elif x != y:
            bad.append(k)
    return bad


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _ckpt_round_trip(cfg, tmp: str) -> dict:
    """Two train steps from seed 0, a save, a restore into a state drawn
    from seed 1: every leaf bit-equal, then one further step from each
    with loss and table bit-equal."""
    import os

    import torch

    from cffm_tpu_torch import train
    from cffm_tpu_torch.checkpoint import CheckpointManager
    from cffm_tpu_torch.data.loader import make_dataset

    dev = torch.device("cuda")
    fn = train.default_interaction_fn(cfg)
    ds = make_dataset(cfg, prefetch=0)
    batches = [train.batch_to_device(next(ds), dev) for _ in range(3)]
    state = train.create_state(cfg, torch.Generator(device=dev).manual_seed(0))
    for b in batches[:2]:
        state, _ = train.train_step(state, *b, cfg, fn)
    mgr = CheckpointManager(os.path.join(tmp, "round_trip"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(2, state, cfg, wait=True)
    save_s = time.perf_counter() - t0
    nbytes = _dir_bytes(os.path.join(tmp, "round_trip", "2"))
    template = train.create_state(cfg, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, meta = mgr.restore(template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del template
    out = {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
           "save_gb_s": nbytes / save_s / 1e9, "restore_gb_s": nbytes / restore_s / 1e9}
    print(f"checkpoint: round trip {json.dumps(out)} meta {json.dumps(meta)}", flush=True)
    bad = _unequal_leaves(restored, state)
    if bad or restored.step != 2:
        fail(f"checkpoint: restored leaves not bit-equal to the saved state: {bad}")
    state, m_a = train.train_step(state, *batches[2], cfg, fn)
    restored, m_b = train.train_step(restored, *batches[2], cfg, fn)
    same_table = torch.equal(state.params["embed"]["table"], restored.params["embed"]["table"])
    print(f"checkpoint: further step loss {m_a['loss'].item()!r} (saved) "
          f"{m_b['loss'].item()!r} (restored), tables bit-equal {same_table}", flush=True)
    if not torch.equal(m_a["loss"], m_b["loss"]) or not same_table:
        fail("checkpoint: the step after the restore differs from the step after the save")
    return out


def phase_checkpoint() -> dict:
    """criteo_kaggle at full width (B=65536, f32 table, adagrad): save and
    restore round trip, a preempted train.run resumed against two
    uninterrupted controls, score from the checkpoint through score.main,
    export from it through export.main and the artifact run on the card."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    import torch

    from cffm_tpu_torch import export as export_lib
    from cffm_tpu_torch import metrics, train
    from cffm_tpu_torch import score as score_lib
    from cffm_tpu_torch.data.loader import make_dataset
    from cffm_tpu_torch.models.cffm import forward
    from cffm_tpu_torch.ops import interaction_conv as ic
    from cffm_tpu_torch.utils.preemption import PreemptionGuard

    base = {"data.batch_size": 65536, "data.eval_batches": 2, "log_every": 1}
    cfg = _run_cfg({**base, "data.num_train_steps": 3})
    m = cfg.model
    # the table, adagrad's per-row accum, and under 1 MB of dense state
    state_bytes = m.total_vocab * (m.table_width + 1) * 4
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        print(f"checkpoint: {free / 1e9:.1f} GB free in {tmp}, a checkpoint "
              f"{state_bytes / 1e9:.2f} GB", flush=True)
        if free < 3 * state_bytes + (1 << 30):
            fail(f"checkpoint: {free / 1e9:.1f} GB free in {tmp}, three checkpoints "
                 f"need {3 * state_bytes / 1e9:.1f} GB")
        out["round_trip"] = _ckpt_round_trip(cfg, tmp)
        torch.cuda.empty_cache()

        # preemption and resume against two uninterrupted controls
        run_dir = os.path.join(tmp, "run")
        ckpt_cfg = dataclasses.replace(cfg, checkpoint_dir=run_dir)

        def counted_run(name, c, steps, guard, log=lambda s: None):
            want = {"cross_conv1_lin_fm2": steps + 2, "cross_conv1_bwd": steps,
                    "sorted_segment_sum_compact": steps, "streamed_rowwise_apply": steps,
                    "scatter_rowwise_apply": steps}
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            result = train.run(c, device="cuda", log_fn=log, preemption_guard=guard)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in _counts().items() if v}
            print(f"checkpoint: {name} {json.dumps(result)} launches {counts} "
                  f"wall {wall:.1f}s", flush=True)
            if counts != want:
                fail(f"checkpoint: {name}: want launches {want}, got {counts}")
            torch.cuda.empty_cache()
            return result

        controls = [counted_run(f"control {i}", cfg, 3, PreemptionGuard(install=False))
                    for i in range(2)]
        guard = PreemptionGuard(install=False)
        logs = []

        def log(line):
            logs.append(line)
            if '"step": 2,' in line:
                guard.request()

        first = counted_run("preempted", ckpt_cfg, 2, guard, log)
        if first.get("preempted_at_step") != 2:
            fail(f"checkpoint: want preempted_at_step 2, got {first}")
        logs.clear()
        resumed = counted_run("resumed", ckpt_cfg, 1, PreemptionGuard(install=False),
                              logs.append)
        if not any('"resumed_from_step": 2' in line for line in logs):
            fail(f"checkpoint: the second run did not resume from step 2: {logs[:2]}")
        keys = ("auc", "logloss", "final_train_loss")
        spread = {k: abs(controls[0][k] - controls[1][k]) for k in keys}
        if any(spread.values()):
            print(f"checkpoint: the two controls differ by {json.dumps(spread)}", flush=True)
        apart = {k: abs(resumed[k] - controls[0][k]) for k in keys}
        print(f"checkpoint: resumed - control {json.dumps(apart)} "
              f"(the controls' spread {json.dumps(spread)})", flush=True)
        if any(apart[k] > spread[k] for k in keys):
            fail(f"checkpoint: the resumed run ends {apart} from the control, "
                 f"more than the controls' own spread {spread}")
        out.update(controls=controls, resumed=resumed, spread=spread)

        # score from the checkpoint through the command line, in process
        argv = ["--config=criteo_kaggle", f"--checkpoint_dir={run_dir}", "--num_batches=8"]
        buf = io.StringIO()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = score_lib.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in _counts().items() if v}
        lines = [json.loads(x) for x in buf.getvalue().splitlines()]
        got = lines[-1]["score"]
        print(f"checkpoint: score.main {argv[1:]} -> {lines}, launches {counts}, "
              f"wall {wall:.1f}s incl. restore ({got['count'] / wall:.1f} ex/s from disk)",
              flush=True)
        if rc != 0 or counts != {"cross_conv1_lin_fm2": 8} or lines[0].get("step") != 3:
            fail(f"checkpoint: score from disk: rc {rc}, launches {counts}, {lines[0]}")
        score_cfg = dataclasses.replace(_run_cfg({}), checkpoint_dir=run_dir)
        params = score_lib.restore_params(score_cfg, torch.device("cuda"), log_fn=lambda s: None)
        want = score_lib.score(score_cfg, params, num_batches=8, device="cuda",
                               log_fn=lambda s: None)
        if got != want:
            fail(f"checkpoint: score from disk {got} != score of the restored params {want}")
        out["score"] = {"result": got, "wall_s": wall, "ex_s": got["count"] / wall}

        # export from the checkpoint; the artifact on the card
        art = os.path.join(tmp, "model.cffm")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = export_lib.main(["--config=criteo_kaggle", f"--out={art}",
                                  f"--checkpoint_dir={run_dir}",
                                  "--model.compute_dtype=float32"])
        line = json.loads(buf.getvalue().splitlines()[-1])
        meta, _ = export_lib.load_artifact(art)
        print(f"checkpoint: export.main -> {line}, artifact {os.path.getsize(art)} bytes, "
              f"meta {meta}", flush=True)
        if rc != 0 or line["step"] != 3:
            fail(f"checkpoint: export: rc {rc}, {line}")
        f32 = dataclasses.replace(score_cfg, model=dataclasses.replace(
            score_cfg.model, compute_dtype="float32"))
        fn = export_lib.load_scoring_fn(art)
        eager = export_lib.scoring_fn(f32)
        cal = metrics.calibration_offset(f32.data)
        errs = {}
        for b in (4096, 1000, 1):
            c = dataclasses.replace(f32, data=dataclasses.replace(f32.data, batch_size=b))
            ids, dense, _ = train.batch_to_device(next(make_dataset(c, split="val", prefetch=0)),
                                                  torch.device("cuda"))
            with torch.inference_mode():
                got_p = fn(params, ids, dense)
                want_p = eager(params, ids, dense)
                kern = torch.sigmoid(forward(params, ids, dense, f32.model,
                                             interaction_fn=ic.make_interaction_fn()) + cal)
            errs[b] = {"vs_eager": (got_p - want_p).abs().max().item(),
                       "vs_kernel_route": (got_p - kern).abs().max().item()}
            print(f"checkpoint: artifact at B={b}: shape {tuple(got_p.shape)}, "
                  f"max_abs_err vs eager scoring_fn {errs[b]['vs_eager']:.3e} (1e-6), "
                  f"vs score's kernel route {errs[b]['vs_kernel_route']:.3e} (1e-4)", flush=True)
            torch.testing.assert_close(got_p, want_p, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(got_p, kern, rtol=1e-4, atol=1e-4)
        out["export"] = {"artifact_bytes": os.path.getsize(art), "errs": errs}
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

    # kernels 4 and 5 on the full f32 table, touched rows only, kernel 7 at
    # nb=1 on the same uids and sums beside kernel 4
    from cffm_tpu_torch.scripts.bench_apply import apply_bytes, apply_inputs

    v = mcfg.total_vocab
    table = torch.randn((v, w), generator=gen, device="cuda") * 0.01
    accum = torch.full((v, 1), 0.1, device="cuda")
    ms = cuda_ms(lambda: su.streamed_rowwise_apply(table, accum, uids_s, gsum, 1e-9, 1e-8), 20)
    k7_ms = cuda_ms(lambda: su.bucketed_rowwise_apply(table, accum, uids_s[None], gsum[None],
                                                      1e-9, 1e-8), 20)
    sgd_ms = cuda_ms(lambda: su.streamed_rowwise_apply(table, None, uids_s, gsum, 1e-9, 1e-8),
                     20)
    hyper = su._hyper(1e-9, 1e-8)
    plain_ms = cuda_ms(lambda: su.streamed_apply_reference(
        table, {"accum": accum}, uids_s, gsum, hyper, "adagrad"), 3)
    rows = uids_s[:cnt].long()
    sgd_delta = gsum[:cnt].float() * -1e-9
    library_ms = cuda_ms(lambda: table.index_add_(0, rows, sgd_delta), 5)
    out["streamed_apply"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                             "sgd_ms": sgd_ms, "kernel7_nb1_ms": k7_ms,
                             **_bound(apply_bytes(m_pad, cnt, w, 4, "adagrad"), cnt * w * 6,
                                      "float32"),
                             "touched_rows": cnt}
    mom = torch.zeros((v, w), device="cuda")
    vv = torch.zeros((v, 1), device="cuda")
    ms = cuda_ms(lambda: su.streamed_rowwise_adam_apply(table, mom, vv, uids_s, gsum, 1e-9,
                                                        1e-8, 0.9, 0.999, 1), 20)
    ahyper = su._hyper(1e-9, 1e-8, su._adam_extra(0.9, 0.999, 1))
    plain_ms = cuda_ms(lambda: su.streamed_apply_reference(
        table, {"m": mom, "v": vv}, uids_s, gsum, ahyper, "rowwise_adam"), 3)
    out["streamed_apply_rowwise_adam"] = {
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        **_bound(apply_bytes(m_pad, cnt, w, 4, "rowwise_adam"), cnt * w * 10, "float32"),
        "touched_rows": cnt}
    del table, accum, mom, vv, gsum, uids, uids_s, rows, sgd_delta
    torch.cuda.empty_cache()

    # kernel 4 at the bench twin's shape: bench.py's uniform ids, a bf16
    # table with stochastic rounding, adagrad
    x = apply_inputs("bench")
    bcnt = x["rows"]
    table = (torch.randn((v, w), generator=gen, device="cuda") * 0.01).to(torch.bfloat16)
    accum = torch.full((v, 1), 0.1, device="cuda")
    ms = cuda_ms(lambda: su.streamed_rowwise_apply(table, accum, x["uids"], x["gsum"], 1e-9,
                                                   1e-8, sr_seed=1234), 20)
    plain_ms = cuda_ms(lambda: su.streamed_apply_reference(
        table, {"accum": accum}, x["uids"], x["gsum"], hyper, "adagrad", sr_seed=1234), 2,
        warmup=1)
    rows = x["uids"][:bcnt].long()
    sgd_delta = (x["gsum"][:bcnt].float() * -1e-9).to(torch.bfloat16)
    library_ms = cuda_ms(lambda: table.index_add_(0, rows, sgd_delta), 5)
    out["streamed_apply_bench"] = {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        **_bound(apply_bytes(x["uids"].numel(), bcnt, w, 2, "adagrad"), bcnt * w * 6,
                 "float32"),
        "touched_rows": bcnt}
    del table, accum, x, rows, sgd_delta
    torch.cuda.empty_cache()
    for name, r in out.items():
        print(f"time {name} B={r.get('batch', b)}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bytes'] / 1e9:.3f} GB, {r['ops'] / 1e9:.2f} GOP)"
              + (f", touched rows {r['touched_rows']}" if "touched_rows" in r else "")
              + (f", sgd kernel {r['sgd_ms']:.4f} ms" if "sgd_ms" in r else "")
              + (f", kernel 7 at nb=1 {r['kernel7_nb1_ms']:.4f} ms"
                 if "kernel7_nb1_ms" in r else ""),
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
    grid = [(d, k, c1, cross) for d in (8, 16, 32) for k in (1, 3, 4, 5, 7, 9, 11, 13)
            for c1 in (32, 64, 72, 96, 128, 136, 256) for cross in ("field_aware", "hadamard")]
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
    # backward at 6 m-tiles; f32: the CUDA-core one), C1=136 (the CUDA-core
    # backward in two channel slices), then k=9 in bf16 and k=11 (the
    # CUDA-core forward's run-time-k instantiation; the backward in two tap
    # slices). The C1=136 and k=11 cases draw from their own generator, so
    # that the earlier cases keep the inputs they were first checked with.
    gen = torch.Generator(device="cuda").manual_seed(22)
    gen_new = torch.Generator(device="cuda").manual_seed(23)
    b = 4096
    for case, dtype, k, c1 in (("c1_128", "bfloat16", 3, 128), ("c1_128_f32", "float32", 3, 128),
                               ("c1_136", "bfloat16", 3, 136), ("c1_136_f32", "float32", 3, 136),
                               ("k9_fm2", "bfloat16", 9, 64), ("k11_fm2", "bfloat16", 11, 64),
                               ("k11_fm2_f32", "float32", 11, 64)):
        cfg = dataclasses.replace(_criteo_model(dtype), conv_channels=(c1, 64), conv_kernel=k)
        dt = getattr(torch, dtype)
        g = gen if case in ("c1_128", "c1_128_f32", "k9_fm2") else gen_new
        (es, eb), w1 = _inputs(cfg, b, dt, g, fm_split=cfg.small_field_prefix)
        gy = torch.randn((b, c1, cfg.embed_dim), generator=g, device="cuda").to(dt)
        glin = torch.randn((b,), generator=g, device="cuda")
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
        fwd_ms = cuda_ms(lambda: ic.cross_conv1_lin_fm2(es, eb, w1, cfg), 5)
        both_ms = cuda_ms(lambda: _grad_rows(ic, cfg, "fm2", es, eb, w1, gy, glin), 3)
        routes[f"{case}_ms"] = {"forward": fwd_ms, "forward_backward": both_ms}
        print(f"time caps {case} B={b}: forward {fwd_ms:.4f} ms, forward and backward "
              f"{both_ms:.4f} ms", flush=True)
        del es, eb, rows, drows, drows_ref
        torch.cuda.empty_cache()

    # 3. C1=128 hadamard (sliced, movielens) at k=3 and k=7: the CUDA-core
    # backward's dE sum, in two channel slices. dE is held at the ulp limit
    # (sweep_bwd_seeds.de_limit_ratio) on the first draw and on
    # HADAMARD_SEEDS more, the first draw at rtol=atol=2e-2 too
    from cffm_tpu_torch.scripts import sweep_bwd_seeds as sweep

    for k in (3, 7):
        cfg = sweep.model("hadamard", k, 128)
        draws = [("first draw", gen if k == 3 else gen_new)] + [
            (f"seed {s}", torch.Generator(device="cuda").manual_seed(s)) for s in HADAMARD_SEEDS]
        for i, (which, g) in enumerate(draws):
            case = f"c1_128_hadamard_k{k}" + ("" if i == 0 else f"_s{i - 1}")
            emb, w1, gy = sweep.draw(cfg, b, g)
            _reset_counts()
            r = sweep.backward(cfg, emb, w1, gy)
            routes[case] = _routes(_counts())
            m = sweep.report(r)
            print(f"parity_caps k={k} C1=128 sliced hadamard bfloat16 B={b} {which}: route "
                  f"{routes[case]}; dE max_abs_err={m['de_err']:.3e}, {m['outside_2e-2']} "
                  f"elements outside rtol=atol=2e-2, {m['ulp_ratio']:.3f} of the ulp limit "
                  f"(one bf16 ulp of dE plus two of dE taken from |E|, |W|, |gY|)", flush=True)
            torch.testing.assert_close(r["y"].float(), r["y_ref"].float(), rtol=2e-2, atol=2e-2)
            if i == 0:
                torch.testing.assert_close(r["de"].float(), r["de_ref"].float(), rtol=2e-2,
                                           atol=2e-2)
            if m["ulp_ratio"] > 1:
                fail(f"parity_caps: {case} dE beyond its ulp limit")
            _check_dw(r["dw"], r["dw_ref"], f"caps k={k} C1=128 sliced hadamard bfloat16 B={b} "
                      f"{which}")
            if routes[case] != {"cross_conv1": 1, "cross_conv1_bwd": 1}:
                fail(f"parity_caps: {case} took {routes[case]}")
            del emb, w1, gy, r

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
    routes["k11"] = _parity_k11_tail(gen_new, b)
    return routes


# ReLU masks and max-pool picks that may fall the other way between the
# card's f32 route and the plain route in float64 at k=11, B=4096, two
# layers of 64 channels (3 in the first card run)
K11_MAX_FLIPS = 8


def _parity_k11_tail(gen, b: int) -> dict:
    """k=11 layer 1 (kernels 1 and 2, run-time k) and the conv tail,
    forward and backward in f32, against the plain route in float64. Where
    a value sits within f32 rounding of 0 (a ReLU mask) or of its pool
    window's other value (a pick), the two routes may decide apart and send
    the gradient to other elements. So: at most K11_MAX_FLIPS decisions
    apart; the output and dE within 1e-4 of their largest value at every
    example with no decision apart (the reference on its own decisions);
    and every output and gradient within 1e-4 with the reference taking
    the card's decisions at those few positions. Returns the route."""
    import torch

    from cffm_tpu_torch.ops import interaction_conv as ic
    from cffm_tpu_torch.ops.cross import build_cross_map, conv1d_same

    cfg = dataclasses.replace(_criteo_model("float32"), conv_kernel=11)
    emb, w1 = _inputs(cfg, b, torch.float32, gen)
    layers = [{"w": w1, "b": torch.randn((64,), generator=gen, device="cuda")},
              {"w": torch.randn((64, 64, 11), generator=gen, device="cuda") * 0.04,
               "b": torch.randn((64,), generator=gen, device="cuda")}]

    def tail(x, lays, decided=None):
        """Bias, ReLU and max pool of layer 1, then layer 2 (conv1d SAME,
        bias, ReLU, pool), as conv_tail_reference; with the ReLU masks and pool
        picks given (decided) or recorded."""
        picks = []
        for i, lay in enumerate(lays):
            if i:
                x = conv1d_same(x, lay["w"])
            x = x + lay["b"][None, :, None]
            mask = x > 0 if decided is None else decided[i][0]
            x = x * mask
            n = x.shape[-1] // cfg.conv_pool
            xr = x[..., :n * cfg.conv_pool].reshape(*x.shape[:-1], n, cfg.conv_pool)
            idx = xr.argmax(-1, keepdim=True) if decided is None else decided[i][1]
            x = xr.gather(-1, idx).squeeze(-1)
            picks.append((mask, idx))
        return x.reshape(x.shape[0], -1), picks

    def fwd_bwd(first, e, lays, gout, decided=None):
        e = e.detach().requires_grad_()
        lays = [{n: t.detach().requires_grad_() for n, t in lay.items()} for lay in lays]
        out, picks = tail(first(e, lays[0]["w"]), lays, decided)
        grads = torch.autograd.grad(out, [e] + [t for lay in lays for t in lay.values()], gout)
        return out.detach(), grads, picks

    def plain_first(e, w):
        return conv1d_same(build_cross_map(e, cfg), w.to(e.dtype))

    def rel(a, r):
        return (a.double() - r).abs().max().item() / max(r.abs().max().item(), 1e-30)

    gout = torch.randn((b, 64 * cfg.embed_dim // cfg.conv_pool ** 2), generator=gen,
                       device="cuda")
    _reset_counts()
    out, grads, picks = fwd_bwd(lambda e, w: ic.cross_conv1(e, w, cfg), emb, layers, gout)
    torch.cuda.synchronize()
    route = _routes(_counts())
    f64 = [{n: t.double() for n, t in lay.items()} for lay in layers]
    out_o, grads_o, picks_o = fwd_bwd(plain_first, emb.double(), f64, gout.double())
    apart = torch.zeros(b, dtype=torch.bool, device="cuda")
    flips = 0
    for p, q in zip(picks, picks_o):
        for mine, theirs in zip(p, q):
            diff = (mine != theirs).reshape(b, -1)
            flips += int(diff.sum())
            apart |= diff.any(1)
    keep = ~apart
    own = [rel(out[keep], out_o[keep]), rel(grads[0][keep], grads_o[0][keep])]
    out_d, grads_d, _ = fwd_bwd(plain_first, emb.double(), f64, gout.double(), picks)
    errs = [rel(a, r) for a, r in zip((out,) + grads, (out_d,) + grads_d)]
    print(f"parity_caps k=11 sliced field_aware float32 B={b}: route {route}; {flips} masks or "
          f"picks apart (at most {K11_MAX_FLIPS}) in {int(apart.sum())} examples; against the "
          f"plain route in float64 on its own decisions, out and dE max err / max|ref| at the "
          f"other examples {max(own):.3e} (1e-4; {own[0]:.1e}, {own[1]:.1e}); with the card's "
          f"decisions at those positions, out, dE, dW1, db1, dW2, db2 {max(errs):.3e} (1e-4; "
          f"{', '.join(f'{e:.1e}' for e in errs)})", flush=True)
    if route != {"cross_conv1": 1, "cross_conv1_bwd": 1}:
        fail(f"parity_caps: k=11 took {route}, not kernels 1 and 2")
    if flips > K11_MAX_FLIPS:
        fail(f"parity_caps: k=11 decides {flips} masks or picks apart from float64")
    if max(own) > 1e-4 or max(errs) > 1e-4:
        fail("parity_caps: k=11 on the card disagrees with the float64 plain route")
    return route


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
        if not torch.equal(gsum, ss.sorted_segment_sum_by_seg(seg, grads, m_pad)):
            fail(f"parity_segment_by_seg T={t} rank 0: two calls differ")
        plain = ss.sorted_segment_by_seg_reference(seg, grads, m_pad)
        e = (gsum.float() - plain.float()).abs().max().item()
        _check_sums("parity_segment_by_seg", gsum, seg, grads, count,
                    f"T={t} rank 0: n={n} count={count} m_pad={m_pad} (kernel vs plain "
                    f"max_abs_err={e:.3e}; two calls bit-equal):")
        err = max(err, e)
        del grads, gsum, plain
        torch.cuda.empty_cache()
    return max(err, _segment_edges("k6"))


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


def _grid_of_one(mesh):
    """The (host, chip) grid of the group of one: H = C = 1, both sub-meshes
    the group itself."""
    from cffm_tpu_torch.parallel.mesh import make_mesh_2d

    return make_mesh_2d(1, 1, device=mesh.device)


def _engine(cfg, mesh, engine: str, fn, seed: int):
    """(state drawn from seed, train step, eval step) of one sharded engine
    ("flat", "hier" or "2d") on the group of mesh."""
    import torch

    from cffm_tpu_torch.parallel import dcn_mesh
    from cffm_tpu_torch.parallel import sharded_train as st

    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    if engine == "flat":
        return (st.create_sharded_state(cfg, gen, mesh), st.make_sharded_train_step(cfg, mesh, fn),
                st.make_sharded_eval_step(cfg, mesh, fn))
    grid = _grid_of_one(mesh)
    if engine == "hier":
        return (st.create_sharded_state(cfg, gen, mesh),
                st.make_sharded_train_step_hier(cfg, grid, fn),
                st.make_sharded_eval_step_hier(cfg, grid, fn))
    return (dcn_mesh.create_sharded_state_2d(cfg, gen, grid),
            dcn_mesh.make_sharded_train_step_2d(cfg, grid, fn),
            dcn_mesh.make_sharded_eval_step_2d(cfg, grid, fn))


def _sharded_run(cfg, mesh, steps: int, eval_batches: int, seed: int = 0,
                 engine: str = "flat"):
    """`_engine`'s state, `steps` train steps and `eval_batches` eval
    batches, with the batches staged first; returns (losses, overflows,
    eval, eval overflow, wall seconds, train step) and the launch counts of
    that run."""
    import torch

    from cffm_tpu_torch import metrics, train
    from cffm_tpu_torch.data.loader import make_dataset

    dev = mesh.device
    state, step, ev = _engine(cfg, mesh, engine, train.default_interaction_fn(cfg), seed)
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
    return (losses, overflows, result, eval_ovf, wall, step), _counts()


def phase_train_sharded(mesh) -> dict:
    """criteo_kaggle with the row-sharded table at full width, B=65536,
    through make_sharded_train_step on an NCCL group of one: three runs with
    launch counts, then one adagrad step against the single-device step."""
    import torch

    from cffm_tpu_torch import train
    from cffm_tpu_torch.parallel.sharded_train import (create_sharded_state,
                                                       make_sharded_train_step)

    k = {"fm2": "cross_conv1_lin_fm2", "fm": "cross_conv1_lin_fm", "flat": "cross_conv1_lin",
         "bwd": "cross_conv1_bwd", "k6": "sorted_segment_sum_by_seg",
         "k7": "bucketed_rowwise_apply", "k7adam": "bucketed_rowwise_adam_apply",
         "prefix": "scatter_rowwise_apply"}
    ev = 2
    runs = {
        # the small-field prefix's update: one scatter_rowwise_apply a step
        "adagrad_f32": (3, {}, {k["fm2"]: 3, k["bwd"]: 3, k["k6"]: 3, k["k7"]: 3,
                                k["prefix"]: 3, k["flat"]: ev}),
        "adagrad_bf16_table": (2, {"model.table_dtype": "bfloat16"},
                               {k["fm2"]: 2, k["bwd"]: 2, k["k6"]: 2, k["k7"]: 2,
                                k["prefix"]: 2, k["flat"]: ev}),
        # no hybrid for rowwise_adam: the fm route trains, eval takes the flat entry
        "rowwise_adam": (2, {"optim.sparse_optimizer": "rowwise_adam"},
                         {k["fm"]: 2, k["bwd"]: 2, k["k6"]: 2, k["k7adam"]: 2, k["flat"]: ev}),
    }
    out = {}
    for name, (steps, extra, want) in runs.items():
        cfg = _sharded_cfg(extra)
        (losses, ovfs, result, eval_ovf, wall, _), counts = _sharded_run(cfg, mesh, steps, ev)
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
    _steps_agree(cfg, create_sharded_state(cfg, torch.Generator(device="cuda").manual_seed(5),
                                           mesh),
                 make_sharded_train_step(cfg, mesh, fn), _single_step(cfg, fn),
                 "train_sharded step vs single-device criteo_kaggle adagrad B=65536",
                 ("sharded", "single"))
    return out


def _single_step(cfg, fn):
    """train.train_step as a (state, ids, dense, labels) step."""
    from cffm_tpu_torch import train

    return lambda state, ids, dense, labels: train.train_step(state, ids, dense, labels, cfg,
                                                              fn)


def _steps_agree(cfg, state, step_a, step_b, what: str, names=("a", "b")):
    """One step of step_a from state and one of step_b from a copy of it,
    on one train batch of cfg: the losses within rtol 1e-5, the table rows
    step_b moved within 1e-2 of its largest move and the other rows
    bit-equal, the accumulator within 1e-6 on the moved rows and equal
    elsewhere, the dense params within 1e-5. Prints one line; fails the run
    when they disagree."""
    import torch

    from cffm_tpu_torch import train
    from cffm_tpu_torch.data.loader import make_dataset

    other = train.TrainState(state.step, _tree_clone(state.params),
                             _tree_clone(state.dense_opt_state),
                             _tree_clone(state.sparse_opt_state))
    table0 = state.params["embed"]["table"].clone()
    ids, dense, labels = train.batch_to_device(next(make_dataset(cfg, prefetch=0)),
                                               torch.device("cuda"))
    a, m_a = step_a(state, ids, dense, labels)
    b, m_b = step_b(other, ids, dense, labels)
    l_a, l_b = float(m_a["loss"]), float(m_b["loss"])
    t_a, t_b = a.params["embed"]["table"], b.params["embed"]["table"]
    moved = (t_b != table0).any(dim=1)
    delta = max((t_b[sl] - table0[sl]).abs().max().item()
                for sl in (slice(r, r + (1 << 18)) for r in range(0, t_b.shape[0], 1 << 18)))
    terr, untouched = _rows_apart(t_b, t_a, moved)
    aerr, aequal = _rows_apart(b.sparse_opt_state["embed"]["accum"],
                               a.sparse_opt_state["embed"]["accum"], moved)
    dense_err = max((x - y).abs().max().item() for x, y in zip(
        train.tree_leaves(train.split_dense_params(b.params)),
        train.tree_leaves(train.split_dense_params(a.params))))
    na, nb = names
    print(f"{what}: loss {na} {l_a} {nb} {l_b} (relative err {abs(l_a - l_b) / abs(l_b):.2e}, "
          f"rtol 1e-5); {int(moved.sum())} moved rows, max |delta| {delta:.3e}, table "
          f"max_abs_err {terr:.2e} (atol 1e-2*max|delta|), other rows bit-equal {untouched}; "
          f"accum max_abs_err {aerr:.2e} (atol 1e-6), equal elsewhere {aequal}; dense params "
          f"max_abs_err {dense_err:.2e} (atol 1e-5)", flush=True)
    if (abs(l_a - l_b) > 1e-5 * abs(l_b) or terr > 1e-2 * delta or not untouched
            or aerr > 1e-6 or not aequal or dense_err > 1e-5):
        fail(f"{what}: the {na} step and the {nb} step disagree")


def _gather_natural(x, mesh, shards: int, v: int):
    """The natural-order table of the first `shards` ranks' (Vs, n) shards
    x, on rank 0 (None elsewhere), and whether each later rank's shard
    equals the one of its rank % shards (the replicas of the 2D engine)."""
    import torch
    import torch.distributed as dist

    from cffm_tpu_torch.parallel import sharded_embedding as se

    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous())
    same = all(torch.equal(p, parts[i % shards]) for i, p in enumerate(parts))
    out = se.from_mod_sharded(torch.cat(parts[:shards]), shards, v) if mesh.rank == 0 else None
    return out, same


def _held(want: dict, got: dict, table0, losses_want, losses_got, dense_want, dense_got,
          dense0) -> dict:
    """The checks of sharded_multi, got against want (natural tables and
    accumulators, losses, dense leaves from dense0): the losses within rtol
    1e-5 then 1e-4, the dense step within 1e-3 relative L2, the moved table
    rows within 1e-2 of the largest move and the others bit-equal, the
    accumulator within 1e-6 there and equal elsewhere."""
    moved = (want["table"] != table0).any(dim=1)
    delta = (want["table"] - table0).abs().max().item()
    terr, untouched = _rows_apart(want["table"], got["table"], moved)
    aerr, aequal = _rows_apart(want["accum"], got["accum"], moved)
    pairs = list(zip(dense_want, dense_got, dense0))
    dense_rel = (math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b, _ in pairs))
                 / math.sqrt(sum(float(((a - c) ** 2).sum()) for a, _, c in pairs)))
    lerr = [abs(a - b) / abs(b) for a, b in zip(losses_got, losses_want)]
    ok = (lerr[0] <= 1e-5 and lerr[1] <= 1e-4 and dense_rel <= 1e-3
          and terr <= 1e-2 * delta and untouched and aerr <= 1e-6 and aequal)
    return {"ok": ok, "loss_relative_err": lerr, "dense_step_relative_l2": dense_rel,
            "moved_rows": int(moved.sum()), "max_delta": delta, "table_max_abs_err": terr,
            "untouched_equal": untouched, "accum_max_abs_err": aerr,
            "accum_untouched_equal": aequal}


def _multi_rank(rank: int, world: int, port: int, out_dir: str):
    """One rank of sharded_multi: two sharded adagrad steps on this rank's
    block of two B=65536 batches; rank 0 then runs the single-device step
    on the whole batches from the same state and compares. With 4 ranks,
    as 2 hosts of 2 cards, also the hier step from the same shards against
    the flat step, the 2D step (tables over 2 cards, replicated on the 2
    hosts) against the single-device step, and the hier routing's overflow
    of each stage at multihost's own caps (B=32768)."""
    import torch
    import torch.distributed as dist

    from cffm_tpu_torch import train
    from cffm_tpu_torch.data.loader import make_dataset
    from cffm_tpu_torch.models import cffm as model_lib
    from cffm_tpu_torch.parallel import dcn_mesh
    from cffm_tpu_torch.parallel import sharded_embedding as se
    from cffm_tpu_torch.parallel.mesh import close_mesh, make_mesh, make_mesh_2d
    from cffm_tpu_torch.parallel.sharded_train import (exchange_ids, make_sharded_train_step,
                                                       make_sharded_train_step_hier,
                                                       step_route)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)
    mesh = make_mesh(init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                     backend="nccl", device=dev)
    grid = world == 4
    try:
        # f32 compute, as step_vs_cpu: in bf16 the ranks' partial dense grads
        # round apart from the whole batch's, which Adam magnifies
        cfg = _sharded_cfg({"model.compute_dtype": "float32"})
        fn = train.default_interaction_fn(cfg)
        v = cfg.model.total_vocab
        # the same natural-layout state on every rank, from one seed
        full = train.create_state(cfg, torch.Generator(device=dev).manual_seed(3))

        def sharded_state(t, i):
            """Shard i of t of full: its tables and accumulator rows."""
            def shard(x):
                storage = se.to_mod_sharded(x, t)
                vs = storage.shape[0] // t
                return storage[i * vs:(i + 1) * vs].clone()

            params = {k: _tree_clone(x) for k, x in full.params.items() if k != "embed"}
            params["embed"] = {"table": shard(full.params["embed"]["table"])}
            return train.TrainState(0, params, _tree_clone(full.dense_opt_state),
                                    {"embed": {"accum": shard(
                                        full.sparse_opt_state["embed"]["accum"])}})

        state = sharded_state(world, rank)
        hstate = sharded_state(world, rank) if grid else None
        dstate = sharded_state(2, rank % 2) if grid else None
        dense0 = [x.clone() for x in train.tree_leaves(train.split_dense_params(full.params))]
        table0 = full.params["embed"]["table"].clone() if rank == 0 else None
        if rank != 0:
            del full
        data = make_dataset(cfg, prefetch=0)
        batches = [train.batch_to_device(next(data), dev) for _ in range(2)]
        b = cfg.data.batch_size // world

        def run(step, state, shards=world):
            losses = []
            for ids, dense, labels in batches:
                blk = slice(rank * b, (rank + 1) * b)
                state, m = step(state, ids[blk], dense[blk], labels[blk])
                losses.append(float(m["loss"]))
            nat = {}
            same = True
            for name, x in (("table", state.params["embed"]["table"]),
                            ("accum", state.sparse_opt_state["embed"]["accum"])):
                nat[name], eq = _gather_natural(x, mesh, shards, v)
                same &= eq
            dleaves = train.tree_leaves(train.split_dense_params(state.params))
            return losses, nat, same, dleaves

        legs = {"flat": run(make_sharded_train_step(cfg, mesh, fn), state)}
        del state
        overflow = None
        if grid:
            mesh2d = make_mesh_2d(2, 2, device=dev)
            legs["hier"] = run(make_sharded_train_step_hier(cfg, mesh2d, fn), hstate)
            del hstate
            legs["2d"] = run(dcn_mesh.make_sharded_train_step_2d(cfg, mesh2d, fn), dstate, 2)
            del dstate
            # the hier routing of multihost's B=32768 at its own caps on this
            # grid: this rank's block routed by the step's router as the step
            # routes it (no table needed)
            mh = _run_cfg(MULTIHOST, "multihost")
            mh_fn = train.default_interaction_fn(mh)
            ids = torch.from_numpy(next(make_dataset(mh, rank, world, prefetch=0))["ids"])
            params = model_lib.init_params(mh.model, torch.Generator(device=dev).manual_seed(0),
                                           skip_tables=True)
            router = make_sharded_train_step_hier(mh, mesh2d, mh_fn).router
            router.build(*exchange_ids(ids.to(dev), step_route(params, mh, router, mh_fn),
                                       mh))
            s1, s2 = _stage_overflows(router, mesh.group)
            overflow = {"stage1": s1, "stage2": s2, "cap1": router.cap1, "cap2": router.cap2,
                        "cap_rows": mh.sharding.cap_rows,
                        "cap_rows_host": mh.sharding.cap_rows_host,
                        "ids_per_rank": int(ids.numel())}
        if rank == 0:
            single, single_losses = full, []
            for ids, dense, labels in batches:
                single, m = train.train_step(single, ids, dense, labels, cfg, fn)
                single_losses.append(float(m["loss"]))
            want = {"table": single.params["embed"]["table"],
                    "accum": single.sparse_opt_state["embed"]["accum"]}
            dense_single = train.tree_leaves(train.split_dense_params(single.params))
            res = {"world": world}
            for name, (losses, nat, same, dleaves) in legs.items():
                # hier is held to the flat step, the others to the single-device step
                ref = legs["flat"] if name == "hier" else (single_losses, want, True, dense_single)
                r = _held(ref[1], nat, table0, ref[0], losses, ref[3], dleaves, dense0)
                r.update(losses=losses, losses_ref=ref[0], replicas_equal=same)
                r["ok"] &= same
                res[name] = r
            res["ok"] = all(r["ok"] for k, r in res.items() if k in legs)
            res["multihost_overflow"] = overflow
            with open(f"{out_dir}/multi.json", "w") as f:
                json.dump(res, f)
        dist.barrier()
    finally:
        close_mesh(mesh)


def phase_sharded_multi():
    """The sharded step on min(cards, 4) NCCL ranks against the
    single-device step, when the machine has more than one card; with 4,
    the hier and 2D legs too (`_multi_rank`)."""
    import os

    import torch
    import torch.multiprocessing as mp

    from cffm_tpu_torch.parallel.mesh import free_port

    n = torch.cuda.device_count()
    if n < 2:
        print(f"sharded_multi: not run: {n} CUDA card visible, and the multi-rank NCCL step "
              f"needs at least 2 (on a machine with more cards this phase spawns "
              f"min(cards, 4) ranks); its hier and 2D legs (2 hosts of 2 cards) need 4",
              flush=True)
        return None
    world = min(n, 4)
    if world != 4:
        print(f"sharded_multi: the hier and 2D legs not run: they need 4 ranks (2 hosts of 2 "
              f"cards), {world} here", flush=True)
    out_dir = os.path.join("build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    mp.spawn(_multi_rank, args=(world, free_port(), out_dir), nprocs=world, join=True)
    with open(os.path.join(out_dir, "multi.json")) as f:
        res = json.load(f)
    print(f"sharded_multi: criteo_kaggle adagrad f32 B=65536 on {world} NCCL ranks, 2 steps of "
          f"the flat and (4 ranks as 2x2) 2D steps vs the single-device step, of the hier step "
          f"vs the flat step; multihost's stage overflows at its caps (B=32768): "
          f"{json.dumps(res)} (rtol 1e-5 then 1e-4 on the losses, 1e-3 "
          f"on the dense step's relative L2, 1e-2*max|delta| on the moved table rows, 1e-6 "
          f"on the accumulator; other rows bit-equal); {time.perf_counter() - t0:.1f}s",
          flush=True)
    if not res["ok"]:
        fail("sharded_multi: a multi-rank step and its reference disagree")
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
    state = create_sharded_state(cfg, torch.Generator(device="cuda").manual_seed(0), mesh)
    step = make_sharded_train_step(cfg, mesh, fn)
    batch = train.batch_to_device(next(make_dataset(cfg, prefetch=0)), torch.device("cuda"))
    torch.cuda.reset_peak_memory_stats()
    out["sharded_step_ms_65536"] = step_ms = _step_ms(step, state, batch)
    print(f"time sharded train step criteo_kaggle B=65536 T={mesh.world} bf16 compute, f32 "
          f"table, adagrad (zipf ids, staged batch): {step_ms:.3f} ms = "
          f"{65536 / step_ms * 1e3:.1f} ex/s; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    out["profile"] = _profile(lambda: step(state, *batch), "sharded step B=65536")
    return out


# ---------------------------------------------------------------------------
# The hierarchical and intra-host engines
# ---------------------------------------------------------------------------

# multihost at full width on one card, as configured: the auto gate's 8%
# rule leaves its 26M-row table to the scatter path at B=32768 (852,864
# touched rows; in the JAX package as here), so kernel 7 runs only with
# the apply forced on (MULTIHOST_K7), the check of kernel 7 on this path
MULTIHOST = {"data.batch_size": 32768}
MULTIHOST_K7 = {**MULTIHOST, "optim.streamed_update": "on"}


def _stage_overflows(router, group) -> list:
    """The (stage 1, stage 2) distinct ids that a HierRouter's last routing
    dropped, summed over group."""
    import torch.distributed as dist

    o = router.stage_overflow.float()
    dist.all_reduce(o, group=group)
    return [int(x) for x in o]


def phase_train_hier(mesh) -> dict:
    """multihost at full width through the hierarchical step on the NCCL
    group of one (H = C = 1: both stages' all-to-alls are copies, the two
    sorts and the two kernel-6 sums are real), as configured and with the
    kernel-7 apply forced on: 2 steps and 2 eval batches each, launch
    counts set to 0 before and read after; then one criteo_kaggle adagrad
    step (f32 table, B=65536) against the flat step from the same state and
    batch."""
    import torch

    from cffm_tpu_torch import train

    steps, ev = 2, 2
    # the small-field prefix's update: one scatter_rowwise_apply a step
    base = {"cross_conv1_lin_fm2": steps, "cross_conv1_bwd": steps,
            "sorted_segment_sum_by_seg": 2 * steps, "cross_conv1_lin": ev,
            "scatter_rowwise_apply": steps}
    out = {}
    # as configured kernel 7's gate refuses: the flattened update takes the
    # scatter route's kernels
    scatter = {"scatter_segment_sum": steps, "scatter_rowwise_apply": 2 * steps}
    for name, extra, want in (("auto", MULTIHOST, {**base, **scatter}),
                              ("k7_on", MULTIHOST_K7, {**base, "bucketed_rowwise_apply": steps})):
        cfg = _run_cfg(extra, "multihost")
        torch.cuda.reset_peak_memory_stats()
        (losses, ovfs, result, eval_ovf, wall, step), counts = _sharded_run(
            cfg, mesh, steps, ev, engine="hier")
        stages = _stage_overflows(step.router, mesh.group)
        v, w, tdt = cfg.model.total_vocab, cfg.model.table_width, cfg.model.table_dtype
        print(f"train_hier multihost streamed_update={cfg.optim.streamed_update}: {v} x {w} "
              f"{tdt} table ({v * w * getattr(torch, tdt).itemsize / 1e9:.2f} GB), adagrad, stochastic rounding, B=32768, H=C=1, caps "
              f"{step.router.cap1}/{step.router.cap2} (cap_rows {cfg.sharding.cap_rows}/"
              f"{cfg.sharding.cap_rows_host} ignored at one shard), {steps} steps, losses "
              f"{losses}, overflow {ovfs} (stage 1 {stages[0]}, stage 2 {stages[1]} as the "
              f"last step routed), eval {json.dumps(result)} (eval overflow {eval_ovf}), "
              f"launches { {k: v for k, v in counts.items() if v} }, wall {wall:.2f}s, peak "
              f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        if not all(math.isfinite(x) for x in losses + [result["auc"], result["logloss"]]):
            fail(f"train_hier multihost {name}: loss or AUC not finite")
        if any(ovfs) or eval_ovf or any(stages):
            fail(f"train_hier multihost {name}: ids overflowed at one shard")
        if any(n != want.get(k, 0) for k, n in counts.items()):
            fail(f"train_hier multihost {name}: want launches {want}, got {counts}")
        out[name] = {"counts": counts, "overflow": stages, "losses": losses}
        del step
        torch.cuda.empty_cache()

    cfg = _sharded_cfg()
    fn = train.default_interaction_fn(cfg)
    state, hier, _ = _engine(cfg, mesh, "hier", fn, 7)
    _steps_agree(cfg, state, hier, _engine(cfg, mesh, "flat", fn, 7)[1],
                 "train_hier step vs flat step criteo_kaggle adagrad B=65536", ("hier", "flat"))
    return out


def phase_train_2d(mesh) -> dict:
    """criteo_kaggle with table_axis="intra_host" at full width on the NCCL
    group of one (H = C = 1), B=65536, f32 table, adagrad: 2 steps and one
    eval batch, launch counts set to 0 before and read after (kernels 1, 2
    and 6 once a step, no kernel 3, 4, 5 or 7: the dense apply replaces
    them); then one step against the single-device train_step."""
    import torch

    from cffm_tpu_torch import train

    steps, ev = 2, 1
    cfg = _sharded_cfg({"sharding.table_axis": "intra_host"})
    torch.cuda.reset_peak_memory_stats()
    (losses, ovfs, result, eval_ovf, wall, _), counts = _sharded_run(cfg, mesh, steps, ev,
                                                                  engine="2d")
    want = {"cross_conv1_lin_fm": steps, "cross_conv1_bwd": steps,
            "sorted_segment_sum_by_seg": steps, "cross_conv1_lin": ev}
    print(f"train_2d criteo_kaggle intra_host: B=65536, H=C=1, {steps} steps, losses {losses}, "
          f"overflow {ovfs}, eval {json.dumps(result)} (eval overflow {eval_ovf}), launches "
          f"{ {k: v for k, v in counts.items() if v} }, wall {wall:.2f}s, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    if not all(math.isfinite(x) for x in losses + [result["auc"], result["logloss"]]):
        fail("train_2d: loss or AUC not finite")
    if any(ovfs) or eval_ovf:
        fail("train_2d: ids overflowed the capacity")
    if any(n != want.get(k, 0) for k, n in counts.items()):
        fail(f"train_2d: want launches {want}, got {counts}")
    torch.cuda.empty_cache()

    fn = train.default_interaction_fn(cfg)
    state, step, _ = _engine(cfg, mesh, "2d", fn, 5)
    _steps_agree(cfg, state, step, _single_step(cfg, fn),
                 "train_2d step vs single-device criteo_kaggle adagrad B=65536", ("2d", "single"))
    return {"counts": counts, "losses": losses}


def _step_ms(step, state, batch, reps: int = 3) -> float:
    """Host-clock ms per step over reps after a warm step, ending in a
    synchronize (the step updates state in place)."""
    import torch

    step(state, *batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(state, *batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_time_hier(mesh) -> dict:
    """The hierarchical step end to end (multihost B=32768 as configured
    beside the kernel-7 apply forced on, in turns auto, on, on, auto, and
    the profile of the configured one; criteo_kaggle B=65536 beside the flat step, in turns flat, hier, hier,
    flat), its profile, kernel 6 at the stage-2 input shape (held against
    its plain version and the exact sums; kernel, plain version, index_add_
    yardstick, bound), and the intra-host step end to end."""
    import torch

    from cffm_tpu_torch import train
    from cffm_tpu_torch.data.loader import make_dataset
    from cffm_tpu_torch.ops import sorted_segment as ss
    from cffm_tpu_torch.parallel.sharded_embedding import EB
    from cffm_tpu_torch.parallel.sharded_train import (exchange_ids,
                                                       make_sharded_train_step_hier,
                                                       step_route)

    out, dev = {}, mesh.device
    grid = _grid_of_one(mesh)

    def batch_of(cfg):
        return train.batch_to_device(next(make_dataset(cfg, prefetch=0)), dev)

    def turns(steps, state, batch, order):
        times = {k: [] for k in steps}
        for name in order:
            times[name].append(_step_ms(steps[name], state, batch))
        return times, {k: sum(v) / len(v) for k, v in times.items()}

    # multihost: one state for both applies (the same layout, updated in place)
    cfg = _run_cfg(MULTIHOST, "multihost")
    fn = train.default_interaction_fn(cfg)
    state, auto, _ = _engine(cfg, mesh, "hier", fn, 0)
    on = make_sharded_train_step_hier(_run_cfg(MULTIHOST_K7, "multihost"), grid, fn)
    batch = batch_of(cfg)
    times, mean = turns({"auto": auto, "on": on}, state, batch, ("auto", "on", "on", "auto"))
    out["hier_multihost_turns_ms"] = times
    out["hier_multihost_ms_32768"] = mean["auto"]
    out["hier_multihost_k7_ms_32768"] = mean["on"]
    print(f"time hier step multihost B=32768 H=C=1 (bf16 table, stochastic rounding, zipf "
          f"ids, staged batch) in turns auto, on, on, auto: as configured (streamed_update "
          f"auto: the scatter apply) {times['auto']} ms, mean {mean['auto']:.3f} ms = "
          f"{32768 / mean['auto'] * 1e3:.1f} ex/s; kernel 7 forced on {times['on']} ms, mean "
          f"{mean['on']:.3f} ms = {32768 / mean['on'] * 1e3:.1f} ex/s", flush=True)
    out["hier_multihost_profile"] = _profile(lambda: auto(state, *batch),
                                             "hier step multihost as configured B=32768")
    del state, auto, on
    torch.cuda.empty_cache()

    # flat and hier share the state: the same layout, both update it in place
    cfg = _sharded_cfg()
    fn = train.default_interaction_fn(cfg)
    state, flat, _ = _engine(cfg, mesh, "flat", fn, 0)
    hier = make_sharded_train_step_hier(cfg, grid, fn)
    batch = batch_of(cfg)
    times, mean = turns({"flat": flat, "hier": hier}, state, batch,
                        ("flat", "hier", "hier", "flat"))
    out.update({f"{k}_step_ms_65536": v for k, v in mean.items()})
    out["turns_ms"] = times
    print(f"time criteo_kaggle B=65536 T=1 (bf16 compute, f32 table, adagrad, zipf ids, staged "
          f"batch) in turns flat, hier, hier, flat: flat {times['flat']} ms, hier "
          f"{times['hier']} ms; mean flat {mean['flat']:.3f} ms = "
          f"{65536 / mean['flat'] * 1e3:.1f} ex/s, hier {mean['hier']:.3f} ms = "
          f"{65536 / mean['hier'] * 1e3:.1f} ex/s", flush=True)
    out["profile"] = _profile(lambda: hier(state, *batch), "hier step B=65536")

    # kernel 6 at the stage-2 input shape: the gateway's (C * cap1, W) slots,
    # routed by the step's own router as the step routes them
    router = hier.router
    hr = router.build(*exchange_ids(batch[0], step_route(state.params, cfg, router, fn), cfg))
    seg, w = hr.r2.seg, cfg.model.table_width
    n, count = seg.numel(), int(seg[-1]) + 1
    m = min(n, router.host_unique)
    m_pad = -(-m // EB) * EB + -(-router.cap2 // EB) * EB
    gen = torch.Generator(device="cuda").manual_seed(11)
    grads = (torch.randn((n, w), generator=gen, device="cuda") * 0.01).to(torch.bfloat16)
    gsum = ss.sorted_segment_sum_by_seg(seg, grads, m_pad)
    if not torch.equal(gsum, ss.sorted_segment_sum_by_seg(seg, grads, m_pad)):
        fail("time_hier k6_stage2: two calls differ")
    plain = ss.sorted_segment_by_seg_reference(seg, grads, m_pad)
    err = (gsum.float() - plain.float()).abs().max().item()
    _check_sums("time_hier k6_stage2", gsum, seg, grads, count,
                f"criteo_kaggle B=65536 H=C=1: n={n} count={count} m_pad={m_pad} (kernel vs "
                f"plain max_abs_err={err:.3e}; two calls bit-equal):")
    del gsum, plain
    ms = cuda_ms(lambda: ss.sorted_segment_sum_by_seg(seg, grads, m_pad), 5)
    plain_ms = cuda_ms(lambda: ss.sorted_segment_by_seg_reference(seg, grads, m_pad), 3)
    seg_l, grads_f = seg.long(), grads.float()
    acc = torch.zeros((m_pad, w), dtype=torch.float32, device="cuda")
    library_ms = cuda_ms(lambda: acc.index_add_(0, seg_l, grads_f), 5)
    valid = int((hr.r1.recv_ids < hr.r1.sentinel).sum())
    out["k6_stage2"] = r = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                            "max_abs_err": err,
                            **_bound(n * 4 + n * w * 2 + m_pad * w * 2, n * w),
                            "n": n, "valid": valid, "count": count, "m_pad": m_pad}
    print(f"time k6_stage2 criteo_kaggle B=65536 H=C=1: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}: {r['bytes'] / 1e9:.3f} GB, {r['ops'] / 1e9:.2f} GOP), n {n} "
          f"(stage-1 slots, {valid} of them live), count {count}, m_pad {m_pad}",
          flush=True)
    del state, flat, hier, router, grads, grads_f, acc, seg_l, hr, seg
    torch.cuda.empty_cache()

    cfg = _sharded_cfg({"sharding.table_axis": "intra_host"})
    state, step, _ = _engine(cfg, mesh, "2d", fn, 0)
    torch.cuda.reset_peak_memory_stats()
    out["2d_step_ms_65536"] = ms = _step_ms(step, state, batch)
    print(f"time intra_host step criteo_kaggle B=65536 H=C=1 (f32 table, adagrad; the dense "
          f"apply over the whole shard): {ms:.3f} ms = {65536 / ms * 1e3:.1f} ex/s; peak "
          f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    out["2d_profile"] = _profile(lambda: step(state, *batch), "intra_host step B=65536")
    return out


def _profile(one, what: str, reps: int = 2, top: int = 16) -> dict:
    """torch.profiler over reps calls of one(): the device's busy ms against
    the wall ms per call, and the top kernels by device time, printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    print(f"profile {what}: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall per step "
          f"(idle share {1 - busy_ms / wall_ms:.3f}, profiler on)", flush=True)
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        ms = e.self_device_time_total / 1e3 / reps
        print(f"profile   {ms:8.3f} ms {ms / busy_ms:6.1%} x{e.count // reps} "
              f"{e.key[:90]}", flush=True)
    return {"busy_ms": busy_ms, "wall_ms": wall_ms}


# ---------------------------------------------------------------------------
# The measurement entry points: kernels 8a and 9, the bench and the scripts
# ---------------------------------------------------------------------------


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


# kernel 8a's cases after the C1=72 one: (batch, dtype, k, C1, route),
# every wgmma instantiation among them, and narrower layers that run
# there with zero channels added (C1 = 8, 16, 48); the last is the timed one
V1_CASES = ((512, "float32", 3, 64, "CUDA cores"), (1, "bfloat16", 3, 64, "wgmma"),
            (7, "bfloat16", 3, 64, "wgmma"), (131, "bfloat16", 3, 64, "wgmma"),
            (131, "bfloat16", 1, 64, "wgmma"), (131, "bfloat16", 1, 32, "wgmma"),
            (131, "bfloat16", 3, 32, "wgmma"), (131, "bfloat16", 5, 32, "wgmma"),
            (131, "bfloat16", 7, 32, "wgmma"), (131, "bfloat16", 3, 48, "wgmma"),
            (131, "bfloat16", 7, 16, "wgmma"), (131, "bfloat16", 1, 8, "wgmma"),
            (131, "bfloat16", 5, 64, "CUDA cores"), (4096, "bfloat16", 3, 64, "wgmma"),
            (512, "float32", 9, 64, "CUDA cores"), (512, "bfloat16", 9, 64, "CUDA cores"),
            (65536, "bfloat16", 3, 64, "wgmma"))


def phase_parity_bwd_v1() -> dict:
    """Kernel 8a (bwd_v1) against its plain version and against kernel 2
    (bwd_v0) at V1_CASES, criteo_kaggle shapes, each on the route it names;
    then kernel 8a, row 8b (bwd_v2, kernel 2 in the variants' layout),
    their plain versions, library yardstick and bound at B=65536."""
    import torch
    import torch.nn.functional as F

    from cffm_tpu_torch.ops import bwd_variants as bv
    from cffm_tpu_torch.ops import interaction_conv as ic
    from cffm_tpu_torch.ops.cross import build_cross_map
    from cffm_tpu_torch.scripts.bench_bwd_variants import make_inputs
    from cffm_tpu_torch.scripts.sweep_bwd_seeds import de_limit_ratio

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
    lib = bv._library()
    for b, name, k, c1, route in V1_CASES:
        dtype = getattr(torch, name)
        cfg = dataclasses.replace(_criteo_model(name), conv_kernel=k, conv_channels=(c1, 64))
        x = make_inputs(cfg, b, "cuda", dtype)
        glin = x["glin"]
        e = x["emb3"]
        wgmma = lib.cffm_cross_conv1_bwd_v1_wgmma(
            int(dtype == torch.bfloat16), e.data_ptr(), e.data_ptr(), e.stride(0), e.stride(1),
            cfg.num_fields, cfg.embed_dim, k, bv.v1_channels(c1), cfg.row_width,
            cfg.table_width)
        print(f"parity_bwd_v1 criteo_kaggle {name} k={k} C1={c1} B={b}: kernel 8a on "
              f"{'wgmma' if wgmma else 'CUDA cores'}", flush=True)
        if (route == "wgmma") != bool(wgmma):
            fail(f"parity_bwd_v1 k={k} C1={c1} {name} B={b}: kernel 8a not on {route}")
        de1, dw1 = _variant_grads(bv, cfg, x, "v1")
        de_ref, dw_ref = bv.bwd_v1_reference(x["emb3"], x["wr"], x["g"], glin, cfg)
        de_ref, dw_ref = de_ref.transpose(0, 1), dw_ref[:, :cfg.num_pairs].permute(2, 1, 0)
        what = f"criteo_kaggle {name} k={k} C1={c1} B={b}"
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
            r_ref, r_k2 = de_limit_ratio(de1, de_ref, de_abs), de_limit_ratio(de1, de0, de_abs)
            r_v2 = de_limit_ratio(de2, de_ref, de_abs)
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


# ragged shapes of the probe, (bt, p, kc, steps, d): M and N not multiples
# of the kernel's tiles
PROBE_RAGGED = {"lane": (64, 700, 200, 7, 3), "sub": (64, 700, 200, 7, 3),
                "rhs": (100, 300, 48, 5, 2)}


def phase_parity_dot_probe() -> dict:
    """Kernel 9's three modes against the plain version at the probe's
    shapes (BT=128, P=744, KC=192, D=16, 512 steps) and at a ragged shape;
    its grid against the CPU rule (dot_probe.schedule); kernel, plain
    version, torch.matmul yardstick (one product, scaled to the call's
    MACs), bound, TMAC/s and the MN-major modes' time against lane's."""
    import torch

    from cffm_tpu_torch.ops import dot_probe as dp
    from cffm_tpu_torch.scripts.probe_dot_orient import BT, D, KC, P, STEPS, make_operands

    out = {"max_abs_err": 0.0}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(31)
    for mode in dp.MODES:
        for bt, p, kc, steps, d in ((BT, P, KC, STEPS, D), PROBE_RAGGED[mode]):
            want = dp.schedule(mode, bt, p, kc, steps, sms)
            lib = dp.library_schedule(mode, bt, p, kc, steps, sms)
            if lib != ((want["nw"], want["mtiles"], want["ntiles"], want["splits"]), want["smem"]):
                fail(f"parity_dot_probe {mode}: the library's grid {lib} is not the CPU rule's")
            if (bt, p, kc) == (BT, P, KC):
                a, b = make_operands(mode, "cuda")
            else:
                a_shape, b_shape, _ = dp.operand_shapes(mode, bt, p, kc)
                a = torch.randn(a_shape, generator=gen, device="cuda").to(torch.bfloat16)
                b = torch.randn(b_shape, generator=gen, device="cuda").to(torch.bfloat16)
            got = dp.dot_probe(a, b, mode, steps, d)
            ref = dp.dot_probe_reference(a, b, mode, steps, d)
            scale = ref.abs().max().item()
            err = (got - ref).abs().max().item()
            print(f"parity_dot_probe {mode} BT={bt} P={p} KC={kc} steps={steps} D={d}: grid "
                  f"{want['mtiles']}x{want['ntiles']} tiles of 64x{want['nw']} x "
                  f"{want['splits']} step splits; max_abs_err={err:.3e} (rtol=1e-5, "
                  f"atol=1e-5*max|out|={1e-5 * scale:.3e})", flush=True)
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * scale)
            out["max_abs_err"] = max(out["max_abs_err"], err)
        a, b = make_operands(mode, "cuda")
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
    lane = out["lane"]["ms"]
    print(f"parity_dot_probe MN-major against K-major (time / lane's): sub (both operands "
          f"MN-major) {out['sub']['ms'] / lane:.4f}, rhs (B MN-major, N-tile 248) "
          f"{out['rhs']['ms'] / lane:.4f}", flush=True)
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
    ("bench_apply", "cffm_tpu_torch.scripts.bench_apply", [],
     ("streamed_rowwise_apply", "streamed_rowwise_adam_apply", "bucketed_rowwise_apply")),
    ("profile_step_full", "cffm_tpu_torch.scripts.profile_step", ["full"],
     ("cross_conv1_lin_fm2", "cross_conv1_bwd", "sorted_segment_sum_compact",
      "streamed_rowwise_apply")),
    ("trace_step", "cffm_tpu_torch.scripts.trace_step", [],
     ("cross_conv1_lin_fm2", "cross_conv1_bwd")),
    # the hier stages' occupancy at multihost's batch on 1, 2x2 and 2x8 cards
    ("measure_id_stats", "cffm_tpu_torch.scripts.measure_id_stats",
     ["--config=multihost", "--batch=32768", "--steps=2", "--topologies=1x1,2x2,2x8"], ()),
    ("bench_scaling", "cffm_tpu_torch.scripts.bench_scaling", ["--hier=1x1", "--n=5"],
     ("cross_conv1_lin_fm2", "cross_conv1_bwd", "sorted_segment_sum_by_seg",
      "bucketed_rowwise_apply")),
    # kernels 1-4 held on their own cases; it must print ONCHIP PARITY: OK
    ("check_onchip_parity", "cffm_tpu_torch.scripts.check_onchip_parity", [],
     ("cross_conv1_lin", "cross_conv1_lin_fm", "cross_conv1_bwd",
      "sorted_segment_sum_compact", "streamed_rowwise_apply")),
    ("profile_sparse", "cffm_tpu_torch.scripts.profile_sparse", ["update,segkernel,apply"],
     ("sorted_segment_sum_compact", "streamed_rowwise_apply")),
    ("profile_sharded_step", "cffm_tpu_torch.scripts.profile_sharded_step", [],
     ("cross_conv1_lin_fm2", "cross_conv1_bwd", "sorted_segment_sum_by_seg",
      "bucketed_rowwise_apply")),
    ("trace_sharded", "cffm_tpu_torch.scripts.trace_sharded", [],
     ("cross_conv1_lin_fm2", "cross_conv1_bwd", "sorted_segment_sum_by_seg",
      "bucketed_rowwise_apply")),
    ("probe_gather", "cffm_tpu_torch.scripts.probe_gather", [], ()),
    ("probe_h2d", "cffm_tpu_torch.scripts.probe_h2d", [], ()),
    # one experiment in a subprocess of its own, through the runner
    ("run_pending_experiments", "cffm_tpu_torch.scripts.run_pending_experiments",
     ["--only=probe_gather"], ()),
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
        if module.endswith("check_onchip_parity") and lines[-1] != "ONCHIP PARITY: OK":
            fail(f"tools {name}: ended with {lines[-1]!r}")
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


DATA_BATCH = 65536
# the data phase's bench lines: (name, argv); staged beside the two file feeds
DATA_FEEDS = (("staged", ["--feed=staged"]), ("reader", ["--feed=reader"]),
              ("prehashed", ["--feed=prehashed"]))


def _hold_streams(want, got, what: str) -> int:
    """Two batch streams ((ids, dense | None, labels) numpy tuples) bit for
    bit; returns the rows compared."""
    import numpy as np

    rows = 0
    for i, (a, b) in enumerate(zip(want, got, strict=True)):
        for x, y in zip(a, b):
            if (x is None) != (y is None) or (x is not None and not (
                    x.dtype == y.dtype and np.array_equal(x, y))):
                fail(f"data {what}: batch {i} differs")
        rows += len(a[0])
    return rows


def _h2d(batch: dict, device, reps: int = 20) -> dict:
    """Bytes of one host batch and the ms of its copy from pinned memory to
    the card (non_blocking, CUDA events)."""
    import torch

    from cffm_tpu_torch.data.wire import host_tensor

    host = [host_tensor(v).pin_memory() for v in batch.values() if v is not None]
    nbytes = sum(t.numel() * t.element_size() for t in host)
    ms = cuda_ms(lambda: [t.to(device, non_blocking=True) for t in host], reps)
    return {"bytes": nbytes, "ms": ms, "gb_s": nbytes / ms / 1e6}


def _host_ms(fn, reps: int = 5) -> float:
    """Host-clock ms per call of a host function, after one warm call."""
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def phase_data() -> dict:
    """The data layer on the card's machine (criteo_kaggle, B=65536): the
    native parser built, native-mt against native against Python batches
    bit for bit (Criteo TSV and Avazu CSV written from a seed), the host
    reader's rows/s at 1, 2, 4 and 8 threads (scripts.bench_input), train.run
    on the TSV at full width for 3 steps with a full-pass eval, once with
    device_prefetch and once with a synchronous copy in its place (loss,
    eval and every state leaf bit-equal; kernels 1-4 launched; the native-mt
    route parsed the chunks), the staged, reader and prehashed bench feeds
    in one call, and the H2D bytes and ms of a raw and a packed batch (and
    the host ms of the pack)."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from cffm_tpu_torch import bench, train
    from cffm_tpu_torch.config import get_config
    from cffm_tpu_torch.data import loader, native, readers
    from cffm_tpu_torch.data import wire as wire_lib
    from cffm_tpu_torch.scripts import bench_input

    b = DATA_BATCH
    out = {}
    t0 = time.perf_counter()
    if not native.available():
        fail("data: the native parser is unavailable (no g++)")
    print(f"data: native parser {native.lib_path().name} ready in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    mcfg = get_config("criteo_kaggle").model
    acfg = get_config("avazu").model
    with tempfile.TemporaryDirectory() as d:
        tsv, csv = os.path.join(d, "criteo.tsv"), os.path.join(d, "avazu.csv")
        t0 = time.perf_counter()
        bench_input._write_criteo(tsv, 13 * b)
        bench_input._write_avazu(csv, 2 * b)
        print(f"data: wrote {os.path.getsize(tsv):,} B of Criteo TSV and "
              f"{os.path.getsize(csv):,} B of Avazu CSV in {time.perf_counter() - t0:.1f}s",
              flush=True)

        # the three routes, bit for bit (no split: every route sees every row)
        for name, path, cfg_m, fns, n in (
                ("criteo", tsv, mcfg, (readers.criteo_batches_native_mt,
                                       readers.criteo_batches_native,
                                       readers.criteo_batches), 3),
                ("avazu", csv, acfg, (readers.avazu_batches_native_mt,
                                      readers.avazu_batches_native,
                                      readers.avazu_batches), 2)):
            streams, secs = [], []
            for fn in fns:
                t = time.perf_counter()
                it = fn(path, cfg_m, b, repeat=False)
                streams.append([next(it) for _ in range(n)])
                secs.append(time.perf_counter() - t)
                it.close()
            rows = _hold_streams(streams[0], streams[1], f"{name} native-mt vs native")
            _hold_streams(streams[0], streams[2], f"{name} native-mt vs Python")
            print(f"data {name}: native-mt, native and Python readers bit-equal over {rows} "
                  f"rows ({n} batches of {b}); host ms per batch "
                  f"{', '.join(f'{x * 1e3 / n:.1f}' for x in secs)}", flush=True)
            out[f"{name}_reader_ms_per_batch"] = dict(zip(("native_mt", "native", "python"),
                                                          (x * 1e3 / n for x in secs)))

        # host reader rows/s by thread count, and the pre-hashed read
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bench_input.main([f"--rows={13 * b}", "--threads=1,2,4,8", f"--batch={b}"])
        lines = [json.loads(x) for x in buf.getvalue().splitlines()]
        for rec in lines:
            print(f"data bench_input: {json.dumps(rec)}", flush=True)
        if rc != 0:
            fail(f"data: bench_input exit code {rc}")
        out["rows_per_s"] = {r["threads"]: r["value"] for r in lines
                             if r["metric"] == "input_rows_per_s"}
        out["prehashed_rows_per_s"] = next(r["value"] for r in lines
                                           if r["metric"] == "input_rows_per_s_prehashed")

        # train.run on the file at full width, with and without the prefetch
        cfg = _run_cfg({"data.batch_size": b, "data.num_train_steps": 3,
                        "data.eval_batches": 0, "data.path": tsv, "log_every": 1})
        if readers.reader_route(cfg.data.reader_threads) != "native_mt":
            fail("data: the run would not take the native-mt route")
        val_rows = [len(x["labels"]) for x in loader.make_dataset(
            cfg, prefetch=0, split="val", repeat=False)]
        if not val_rows or val_rows[-1] == b:
            fail(f"data: want a val split ending in a partial batch, got {val_rows}")

        def sync_copies(batches, device, depth=2):
            for x in batches:
                yield train.batch_to_device(x, device)

        runs = {}
        for name in ("prefetch", "no_prefetch"):
            states, logs, chunks = [], [], [0]
            make_state, parse = train.create_state, readers._parse_criteo_chunk
            prefetch = loader.device_prefetch

            def capture(*a, **k):
                states.append(make_state(*a, **k))
                return states[-1]

            def counted(*a, **k):
                chunks[0] += 1
                return parse(*a, **k)

            train.create_state, readers._parse_criteo_chunk = capture, counted
            if name == "no_prefetch":
                loader.device_prefetch = sync_copies
            try:
                torch.cuda.synchronize()
                _reset_counts()
                t = time.perf_counter()
                result = train.run(cfg, device="cuda", log_fn=logs.append)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                counts = _counts()
            finally:
                train.create_state, readers._parse_criteo_chunk = make_state, parse
                loader.device_prefetch = prefetch
            losses = [json.loads(x)["loss"] for x in logs if '"loss"' in x]
            launched = {k: v for k, v in counts.items() if v}
            print(f"data train.run {name}: B={b} 3 steps on the TSV, losses {losses}, "
                  f"full-pass eval {json.dumps(result)} over {sum(val_rows)} rows in "
                  f"{len(val_rows)} batches, launches {launched}, native-mt chunks parsed "
                  f"{chunks[0]}, wall {wall:.1f}s", flush=True)
            want = {"cross_conv1_lin_fm2": 3 + len(val_rows), "cross_conv1_bwd": 3,
                    "sorted_segment_sum_compact": 3, "streamed_rowwise_apply": 3,
                    "scatter_rowwise_apply": 3}
            if launched != want:
                fail(f"data train.run {name}: want launches {want}, got {launched}")
            if not chunks[0]:
                fail(f"data train.run {name}: the native-mt reader parsed no chunk")
            if result["count"] != sum(val_rows):
                fail(f"data train.run {name}: eval count {result['count']}, want "
                     f"{sum(val_rows)}")
            if not all(math.isfinite(x) for x in losses + [result["auc"], result["logloss"]]):
                fail(f"data train.run {name}: loss or AUC not finite")
            runs[name] = (losses, result, states[0])
            out[f"train_run_{name}"] = {"losses": losses, "eval": result, "wall_s": wall,
                                        "launches": launched}
        (l_on, r_on, s_on), (l_off, r_off, s_off) = runs["prefetch"], runs["no_prefetch"]
        bad = _unequal_leaves(s_on, s_off)
        if l_on != l_off or r_on != r_off or bad:
            fail(f"data: prefetch on and off differ: losses {l_on} vs {l_off}, eval "
                 f"{r_on} vs {r_off}, leaves {bad[:5]}")
        print("data: train.run with device_prefetch equals train.run without it bit for "
              "bit (losses, full-pass eval, every state leaf)", flush=True)
        del runs, s_on, s_off
        torch.cuda.empty_cache()

        # H2D of one batch, raw against packed, and the packed batch's unpack
        raw = next(loader.make_dataset(cfg, prefetch=0))
        packed = loader.make_dataset(dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, wire_format="packed")), prefetch=0)
        packed = next(packed)["wire"]
        spec = wire_lib.spec_for_model(cfg.model)
        dev = {k: wire_lib.host_tensor(v).cuda() for k, v in packed.items()}
        ids, _, labels = wire_lib.unpack(dev, spec)
        if not torch.equal(ids.cpu() + train.wire_offsets(cfg.model, "cpu"),
                           torch.from_numpy(raw["ids"])):
            fail("data: the packed batch does not unpack to the raw batch's ids")
        local = [np.asarray(raw["ids"]) - train.wire_offsets(cfg.model, "cpu").numpy(),
                 raw["dense"], raw["labels"]]
        out["h2d"] = {"raw": _h2d(raw, "cuda"), "packed": _h2d(packed, "cuda"),
                      "unpack_ms": cuda_ms(lambda: wire_lib.unpack(dev, spec), 20),
                      "pack_host_ms": _host_ms(lambda: wire_lib.pack(*local, spec))}
        h = out["h2d"]
        print(f"data h2d per batch of {b}: raw {h['raw']['bytes']:,} B in "
              f"{h['raw']['ms']:.4f} ms ({h['raw']['gb_s']:.2f} GB/s), packed "
              f"{h['packed']['bytes']:,} B in {h['packed']['ms']:.4f} ms "
              f"({h['packed']['gb_s']:.2f} GB/s) + unpack {h['unpack_ms']:.4f} ms on the card; "
              f"the pack takes {h['pack_host_ms']:.2f} ms of one host core", flush=True)

    # the bench's staged and file feeds in one call
    feeds = {}
    for name, argv in DATA_FEEDS:
        buf = io.StringIO()
        torch.cuda.synchronize()
        _reset_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(argv)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _counts().items() if v}
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"data bench {name}: {json.dumps(rec)} rc {rc} in "
              f"{time.perf_counter() - t:.1f}s, launches {counts}", flush=True)
        if rc != 0 or not rec["value"] > 0 or "error" in rec:
            fail(f"data bench {name}: {rec}")
        for k in ("cross_conv1_lin_fm2", "cross_conv1_bwd", "sorted_segment_sum_compact",
                  "streamed_rowwise_apply"):
            if not counts.get(k):
                fail(f"data bench {name}: kernel {k} never launched ({counts})")
        feeds[name] = rec["value"]
        torch.cuda.empty_cache()
    out["feeds"] = feeds
    step_ms = b / feeds["staged"] * 1e3
    host_ms = b / out["rows_per_s"][4] * 1e3
    print(f"data: host ms per batch of {b} (native-mt, 4 threads) {host_ms:.2f} beside the "
          f"staged train step's {step_ms:.2f} ms; ex/s staged {feeds['staged']:.1f}, reader "
          f"{feeds['reader']:.1f}, prehashed {feeds['prehashed']:.1f}", flush=True)
    out.update(host_ms_per_batch=host_ms, staged_step_ms=step_ms)
    return out


def _zipf_batch(b: int):
    """criteo_kaggle's train config at batch b and one batch of the
    benchmark's zipf traffic: global int32 ids (b, F), dense, labels (numpy)."""
    import pathlib

    import numpy as np

    from benchmark import traffic
    from cffm_tpu_torch.config import get_config

    cfg = get_config("criteo_kaggle")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=b))
    path = pathlib.Path(__file__).resolve().parent / "benchmark" / "traffic" / "train_zipf.json"
    law = json.loads(path.read_text())["ids"]
    world = traffic.PlantedCTR(cfg.model.vocab_sizes, cfg.model.num_dense, 4000000901, law)
    ids, dense, labels = world.batch(traffic.rng(4000000901, 1), b)
    ids = ids + traffic.field_offsets(cfg.model.vocab_sizes)[None, :].astype(np.int32)
    return cfg, ids, dense, labels


def _lookup_bytes(table, ids, bounds, out_dtype) -> float:
    """The lookup's least bytes: each output row written once, each distinct
    table row it reads and each id read once."""
    import torch

    fs = len(bounds) - 1
    b, f = ids.shape
    small = ids.t()[:fs].long()
    edges = torch.tensor(bounds, device=ids.device)[:, None]
    valid = small[(small >= edges[:-1]) & (small < edges[1:])]
    big = ids.t()[fs:].long().clamp(0, table.shape[0] - 1)
    distinct = torch.unique(torch.cat([valid, big.reshape(-1)])).numel()
    w = table.shape[1]
    return (f * b * w * out_dtype.itemsize + distinct * w * table.element_size()
            + ids.numel() * ids.element_size())


def phase_lookup() -> dict:
    """The lookup kernel against its plain version, its launches in the
    train step and the forward, and its time beside the plain version's,
    the old chain's and its bound (f32 table, bf16 out, as the cells run)."""
    import torch

    from cffm_tpu_torch import train
    from cffm_tpu_torch.models import cffm as model_lib
    from cffm_tpu_torch.ops import embed_lookup as el

    b = 65536
    cfg, ids_np, dense_np, labels_np = _zipf_batch(b)
    mcfg = cfg.model
    bounds = model_lib.prefix_bounds(mcfg)
    ids = torch.from_numpy(ids_np).cuda()
    wide = torch.zeros((b, 2 * mcfg.num_fields), dtype=torch.int32, device="cuda")
    wide[:, ::2] = ids
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32 = 0.01 * torch.randn((mcfg.total_vocab, mcfg.table_width), generator=gen,
                             device="cuda")
    for tname, table in (("f32", f32), ("bf16", f32.to(torch.bfloat16))):
        for iname, i in (("int32", ids), ("int64", ids.long()), ("strided", wide[:, ::2])):
            before = el.lookup_fm.launches
            got = el.lookup_fm(table, i, bounds, torch.bfloat16)
            want = el.lookup_fm_reference(table, i, bounds, torch.bfloat16)
            torch.cuda.synchronize()
            if el.lookup_fm.launches != before + 1:
                fail(f"lookup {tname} {iname}: the kernel did not launch")
            for g, w in zip(got, want):
                if not torch.equal(g.view(torch.int16), w.view(torch.int16)):
                    fail(f"lookup {tname} {iname}: not bit-equal to the plain version")
            del got, want
    print("lookup: bit-equal to the plain version (f32 and bf16 tables; int32, int64 and "
          "strided ids)", flush=True)
    del wide
    torch.cuda.empty_cache()

    def old_chain():
        ids_fm = ids.t()
        fs = len(bounds) - 1
        vocab = torch.as_tensor(mcfg.vocab_sizes[:fs], device=ids.device)
        offs = torch.cumsum(vocab, 0) - vocab
        local = ids_fm[:fs] - offs[:, None].to(ids.dtype)
        valid = (local >= 0) & (local < vocab[:, None])
        rows = el.take_rows(f32[: bounds[-1]], ids_fm[:fs]).to(torch.bfloat16)
        small = torch.where(valid[..., None], rows, torch.zeros((), dtype=torch.bfloat16,
                                                                device=ids.device))
        return small, el.take_rows(f32, ids_fm[fs:]).to(torch.bfloat16)

    out = {"bytes": _lookup_bytes(f32, ids, bounds, torch.bfloat16)}
    out.update(_bound(out["bytes"], 0.0))
    out["ms"] = cuda_ms(lambda: el.lookup_fm(f32, ids, bounds, torch.bfloat16), 20)
    out["plain_ms"] = cuda_ms(lambda: el.lookup_fm_reference(f32, ids, bounds,
                                                             torch.bfloat16), 10)
    out["library_ms"] = cuda_ms(old_chain, 10)
    torch.cuda.empty_cache()

    # one launch a train step and one a forward, at the cells' shapes
    del f32
    torch.cuda.empty_cache()
    fn = train.default_interaction_fn(cfg)
    state = train.create_state(cfg, torch.Generator(device="cuda").manual_seed(0))
    dense, labels = torch.from_numpy(dense_np).cuda(), torch.from_numpy(labels_np).cuda()
    launches = {}
    for name in ("train_step", "forward"):
        before = el.lookup_fm.launches
        if name == "train_step":
            state, _ = train.train_step(state, ids, dense, labels, cfg, fn)
        else:
            with torch.no_grad():
                model_lib.forward(state.params, ids, dense, mcfg, interaction_fn=fn)
        torch.cuda.synchronize()
        launches[name] = el.lookup_fm.launches - before
        if launches[name] != 1:
            fail(f"lookup: {launches[name]} launches in one {name}, want 1")
    out["launches"] = launches
    print(f"lookup: B={b} F={mcfg.num_fields} W={mcfg.table_width} f32 -> bf16: kernel "
          f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f}, old chain "
          f"{out['library_ms']:.4f}, bound "
          f"{out['bound_ms']:.4f} ({out['bytes'] / 1e9:.3f} GB) = "
          f"{100 * out['bound_ms'] / out['ms']:.1f}% of it; launches {launches}", flush=True)
    return out


# the conv tail kernel's batches: the cells', a ragged tile past them, and
# small batches with a ragged last tile
TAIL_BATCHES = (65536, 65537, 1000, 17, 1)


def _tail_layers(c1: int, c2: int, gen, dtype, onehot: bool):
    """Layer 1's bias and conv 2's weights and bias, drawn: w2 He-scaled, or
    one-hot (each output channel reads one tap of one input channel), the
    biases at 0.1 scale."""
    import torch

    if onehot:
        w2 = torch.zeros((c2, c1, 3), device="cuda")
        pick = torch.randint(0, c1 * 3, (c2,), generator=gen, device="cuda")
        w2.view(c2, -1)[torch.arange(c2, device="cuda"), pick] = 1.0
    else:
        w2 = torch.randn((c2, c1, 3), generator=gen, device="cuda") * math.sqrt(2.0 / (3 * c1))
    b1 = 0.1 * torch.randn((c1,), generator=gen, device="cuda")
    b2 = 0.1 * torch.randn((c2,), generator=gen, device="cuda")
    return [{"b": b1.to(dtype)}, {"w": w2.to(dtype), "b": b2.to(dtype)}]


def tail_limit(y, layers, cfg):
    """The largest |kernel - plain version| a conv-tail feature may show
    when the two differ only in the order of conv 2's f32 sum: one bf16 ulp
    for each of conv 2's rounding and its bias add's, at the larger of the
    two magnitudes, doubled for a neighbour in the next binade, plus both
    f32 sums' worst error, 2 n 2^-24 sum|w p| over conv 2's n = 3 C1 terms;
    ReLU and the pool's max pass a difference on no larger (B, C2 * 4).
    Needs TF32 off."""
    import torch

    from cffm_tpu_torch.ops.cross import conv1d_same, max_pool_valid

    b1, w2, b2 = layers[0]["b"], layers[1]["w"], layers[1]["b"]
    p1 = max_pool_valid(torch.relu(y + b1.to(y.dtype)[None, :, None]), 2)
    wb = w2.to(y.dtype)
    s = conv1d_same(p1, wb)
    r = s + b2.to(y.dtype)[None, :, None]
    mag = conv1d_same(p1.float().abs(), wb.float().abs())
    n = w2.shape[1] * w2.shape[2]
    lim = (2 * _bf16_ulp(torch.maximum(s.float().abs(), r.float().abs()))
           + 2 * n * 2.0**-24 * mag)
    return max_pool_valid(lim, 2).reshape(y.shape[0], -1)


def grad_close(got, want) -> bool:
    """A gradient that is an f32 sum rounded to bf16 once, against the same
    sum taken in another order: a neighbouring bf16 value (one ulp of the
    larger magnitude), with 1e-5 of the tensor's largest magnitude for a sum
    that cancels below the f32 sums' own error."""
    import torch

    a, b = got.float(), want.float()
    lim = _bf16_ulp(torch.maximum(a.abs(), b.abs())) + 1e-5 * float(b.abs().max())
    return (got.dtype == want.dtype and got.shape == want.shape
            and bool(((a - b).abs() <= lim).all()))


def grid_tail_case(b: int, c1: int, c2: int, gen, dtype):
    """y, g and the tail's layers with values on coarse grids (y, g, b1, b2
    in eighths, w2 in sixteenths), so that conv 2 and its input gradient
    sum exactly in f32 in any order: the pools' winners and gy do not
    depend on the order, and many windows tie."""
    import torch

    def grid(shape, lo, hi, den):
        return torch.randint(lo, hi + 1, shape, generator=gen, device="cuda").float() / den

    y = grid((b, c1, 16), -8, 8, 8).to(torch.bfloat16)
    g = grid((b, c2 * 4), -8, 8, 8).to(torch.bfloat16)
    layers = [{"b": grid((c1,), -4, 4, 8).to(dtype)},
              {"w": grid((c2, c1, 3), -4, 4, 16).to(dtype), "b": grid((c2,), -4, 4, 8).to(dtype)}]
    return y, g, layers


def eager_tail_grads(y, g, layers, cfg):
    """(features, (gy, dw2, db1, db2)) by autograd through the eager tail."""
    import torch

    from cffm_tpu_torch.ops import interaction_conv as ic

    leaves = [y.clone().requires_grad_(), layers[1]["w"].clone().requires_grad_(),
              layers[0]["b"].clone().requires_grad_(), layers[1]["b"].clone().requires_grad_()]
    y_, w2, b1, b2 = leaves
    out = ic.conv_tail_reference(y_, [{"b": b1}, {"w": w2, "b": b2}], cfg)
    return out.detach(), torch.autograd.grad(out, leaves, g)


def _conv_tail_bwd_checks(gen) -> dict:
    """The backward kernel against its plain version and eager autograd at
    both channel widths, every TAIL_BATCHES batch, f32 and bf16 weights."""
    import torch

    from cffm_tpu_torch.ops import interaction_conv as ic

    worst_gap = dict.fromkeys(("gy", "dw2", "db1", "db2"), 0.0)
    beyond_ulp, checked = 0, 0
    for mcfg in (_criteo_model("bfloat16"), _movielens_model("field_aware", "bfloat16")):
        c1, c2 = mcfg.conv_channels
        for b in TAIL_BATCHES:
            for dtype in (torch.float32, torch.bfloat16):
                y = torch.randn((b, c1, 16), generator=gen, device="cuda").to(torch.bfloat16)
                g = torch.randn((b, c2 * 4), generator=gen, device="cuda").to(torch.bfloat16)
                cases = {"one-hot": (y, g, _tail_layers(c1, c2, gen, dtype, True)),
                         "grid": grid_tail_case(b, c1, c2, gen, dtype),
                         "drawn": (y, g, _tail_layers(c1, c2, gen, dtype, False))}
                for kind, (y, g, layers) in cases.items():
                    what = f"conv_tail_bwd ({c1}, {c2}) B={b} {dtype} {kind}"
                    before = ic.conv_tail_bwd.launches
                    got = ic.conv_tail_bwd(y, g, layers, mcfg)
                    again = ic.conv_tail_bwd(y, g, layers, mcfg)
                    want = ic.conv_tail_bwd_reference(y, g, layers, mcfg)
                    torch.cuda.synchronize()
                    if ic.conv_tail_bwd.launches != before + 2:
                        fail(f"{what}: the kernel did not launch once a call")
                    if not all(torch.equal(a.view(torch.uint8), x.view(torch.uint8))
                               for a, x in zip(got, again)):
                        fail(f"{what}: two calls differ")
                    if kind != "drawn":
                        if not all(grad_close(a, x) for a, x in zip(got[1:], want[1:])):
                            fail(f"{what}: a weight or bias gradient beyond grad_close")
                        if not torch.equal(got[0], want[0]):
                            fail(f"{what}: gy not equal to the plain version's")
                        if kind == "grid":  # the Function against eager autograd
                            feats, eager = eager_tail_grads(y, g, layers, mcfg)
                            leaves = [t.clone().requires_grad_() for t in
                                      (y, layers[1]["w"], layers[0]["b"], layers[1]["b"])]
                            out = ic.conv_tail_with_grad(
                                leaves[0], [{"b": leaves[2]}, {"w": leaves[1], "b": leaves[3]}],
                                mcfg)
                            out.backward(g)
                            if not (torch.equal(out.detach(), feats)
                                    and torch.equal(leaves[0].grad, eager[0])
                                    and all(grad_close(t.grad, x)
                                            for t, x in zip(leaves[1:], eager[1:]))):
                                fail(f"{what}: the Function differs from eager autograd")
                        continue
                    for part, a, x in zip(("gy", "dw2", "db1", "db2"), got, want):
                        diff = a.float() - x.float()
                        gap = float(diff.norm() / x.float().norm().clamp_min(1e-30))
                        worst_gap[part] = max(worst_gap[part], gap)
                        if gap > 1e-2:
                            fail(f"{what}: {part}'s norm gap {gap:.3e} from the plain version")
                    diff = (got[0].float() - want[0].float()).abs()
                    beyond_ulp += int((diff > _bf16_ulp(want[0])).sum())
                    checked += want[0].numel()
    gaps = ", ".join(f"{k} {v:.3e}" for k, v in worst_gap.items())
    print(f"conv_tail_bwd: one-hot and grid weights: gy equal to the plain version, the "
          f"Function equal to eager autograd (gy) and within grad_close (weights, biases); "
          f"drawn weights: norm gaps at most {gaps}; {beyond_ulp} of {checked} gy elements "
          f"more than one bf16 ulp apart; two calls bit-equal", flush=True)
    return {"bwd_drawn_norm_gap": worst_gap, "bwd_drawn_gy_beyond_one_ulp": beyond_ulp,
            "bwd_checked": checked}


def phase_conv_tail() -> dict:
    """The conv tail's kernels against their plain versions at both channel
    widths, their launches in a forward and a train step, and their times
    beside the plain versions' and their bounds at B=65536."""
    import torch

    from cffm_tpu_torch import train
    from cffm_tpu_torch.models import cffm as model_lib
    from cffm_tpu_torch.ops import interaction_conv as ic

    gen = torch.Generator(device="cuda").manual_seed(21)
    worst, beyond_ulp, checked = 0.0, 0, 0
    for mcfg in (_criteo_model("bfloat16"), _movielens_model("field_aware", "bfloat16")):
        c1, c2 = mcfg.conv_channels
        for b in TAIL_BATCHES:
            y = torch.randn((b, c1, 16), generator=gen, device="cuda").to(torch.bfloat16)
            for dtype in (torch.float32, torch.bfloat16):
                for onehot in (True, False):
                    layers = _tail_layers(c1, c2, gen, dtype, onehot)
                    before = ic.conv_tail.launches
                    got = ic.conv_tail(y, layers, mcfg)
                    want = ic.conv_tail_reference(y, layers, mcfg)
                    torch.cuda.synchronize()
                    what = f"conv_tail ({c1}, {c2}) B={b} {dtype} {'one-hot' if onehot else 'drawn'}"
                    if ic.conv_tail.launches != before + 1:
                        fail(f"{what}: the kernel did not launch once")
                    if got.shape != want.shape or got.dtype != want.dtype:
                        fail(f"{what}: {tuple(got.shape)} {got.dtype}, want "
                             f"{tuple(want.shape)} {want.dtype}")
                    if onehot:
                        if not torch.equal(got, want):
                            fail(f"{what}: not equal to the plain version where every sum is exact")
                        continue
                    diff = (got.float() - want.float()).abs()
                    ratio = (diff / tail_limit(y, layers, mcfg)).max().item()
                    worst = max(worst, ratio)
                    beyond_ulp += int((diff > _bf16_ulp(want)).sum())
                    checked += want.numel()
                    if ratio > 1.0:
                        fail(f"{what}: {ratio:.3f} of tail_limit from the plain version")
    print(f"conv_tail: one-hot weights equal to the plain version (layer 1 bit for bit); drawn "
          f"weights at most {worst:.3f} of tail_limit, {beyond_ulp} of {checked} features more "
          f"than one bf16 ulp apart", flush=True)

    b = 65536
    mcfg = _criteo_model("bfloat16")
    c1, c2 = mcfg.conv_channels
    y = torch.randn((b, c1, 16), generator=gen, device="cuda").to(torch.bfloat16)
    layers = _tail_layers(c1, c2, gen, torch.float32, False)
    nbytes = (y.numel() * 2 + b * c2 * 4 * 2
              + sum(t.numel() * 4 for lay in layers for t in lay.values()))
    out = {"max_limit_share": worst, "beyond_one_ulp": beyond_ulp, "checked": checked}
    out.update(_bound(nbytes, 2.0 * b * c2 * c1 * 3 * 8))
    out["ms"] = cuda_ms(lambda: ic.conv_tail(y, layers, mcfg), 50)
    out["plain_ms"] = cuda_ms(lambda: ic.conv_tail_reference(y, layers, mcfg), 20)
    out["library_ms"] = out["plain_ms"]  # the eager chain is the plain version

    # the backward: y and g read once, gy written once; conv 2 again, its
    # input gradient and its weight gradient
    out.update(_conv_tail_bwd_checks(gen))
    g = torch.randn((b, c2 * 4), generator=gen, device="cuda").to(torch.bfloat16)
    bwd = _bound(2 * y.numel() * 2 + g.numel() * 2
                 + 2 * sum(t.numel() * 4 for lay in layers for t in lay.values()),
                 3 * 2.0 * b * c2 * c1 * 3 * 8)
    bwd["ms"] = cuda_ms(lambda: ic.conv_tail_bwd(y, g, layers, mcfg), 50)
    bwd["plain_ms"] = cuda_ms(lambda: ic.conv_tail_bwd_reference(y, g, layers, mcfg), 10)
    leaves = [y.clone().requires_grad_()] + [t.clone().requires_grad_() for t in
                                             (layers[1]["w"], layers[0]["b"], layers[1]["b"])]
    params = [{"b": leaves[2]}, {"w": leaves[1], "b": leaves[3]}]

    def both_ways(fn):
        torch.autograd.grad(fn(leaves[0], params, mcfg), leaves, g)

    # the eager chain forward and back, as a train step ran it, and the
    # Function forward and back, as a train step runs it now
    bwd["eager_fwd_bwd_ms"] = cuda_ms(lambda: both_ways(ic.conv_tail_reference), 20)
    bwd["fused_fwd_bwd_ms"] = cuda_ms(lambda: both_ways(ic.conv_tail_with_grad), 50)
    bwd["library_ms"] = bwd["eager_fwd_bwd_ms"]
    out["bwd"] = bwd
    del y, g, leaves, params
    torch.cuda.empty_cache()

    # a train step launches the forward and the backward once each, a
    # forward without a gradient the forward once
    cfg, ids_np, dense_np, labels_np = _zipf_batch(b)
    fn = train.default_interaction_fn(cfg)
    state = train.create_state(cfg, torch.Generator(device="cuda").manual_seed(0))
    ids, dense, labels = (torch.from_numpy(x).cuda() for x in (ids_np, dense_np, labels_np))
    launches = {}
    for name in ("train_step", "forward"):
        before = (ic.conv_tail.launches, ic.conv_tail_bwd.launches)
        if name == "train_step":
            state, _ = train.train_step(state, ids, dense, labels, cfg, fn)
        else:
            with torch.inference_mode():
                model_lib.forward(state.params, ids, dense, cfg.model, interaction_fn=fn)
        torch.cuda.synchronize()
        launches[name] = (ic.conv_tail.launches - before[0], ic.conv_tail_bwd.launches - before[1])
    if launches != {"train_step": (1, 1), "forward": (1, 0)}:
        fail(f"conv_tail: (forward, backward) launches {launches}, want (1, 1) in a train "
             f"step and (1, 0) a forward")
    out["launches"] = launches
    print(f"conv_tail: B={b} ({c1}, {c2}) bf16: kernel {out['ms']:.4f} ms, plain (the eager "
          f"chain) {out['plain_ms']:.4f}, bound {out['bound_ms']:.4f} "
          f"({nbytes / 1e6:.1f} MB) = {100 * out['bound_ms'] / out['ms']:.1f}% of it; "
          f"(forward, backward) launches {launches}", flush=True)
    print(f"conv_tail_bwd: B={b} ({c1}, {c2}) bf16, f32 weights: kernel {bwd['ms']:.4f} ms, "
          f"plain {bwd['plain_ms']:.4f}, bound {bwd['bound_ms']:.4f} "
          f"({bwd['bytes'] / 1e6:.1f} MB) = {100 * bwd['bound_ms'] / bwd['ms']:.1f}% of it; "
          f"forward and back: eager chain {bwd['eager_fwd_bwd_ms']:.4f} ms, the two kernels "
          f"{bwd['fused_fwd_bwd_ms']:.4f}", flush=True)
    return out


PHASES = ("parity", "parity_bwd", "parity_caps", "parity_segment", "parity_apply", "serve",
          "time", "train", "learn", "checkpoint", "step_vs_cpu", "time_train",
          "parity_segment_by_seg", "parity_bucketed", "train_sharded", "sharded_multi",
          "time_sharded", "train_hier", "train_2d", "time_hier", "parity_bwd_v1",
          "parity_dot_probe", "tools", "data", "lookup", "conv_tail", "train_full",
          "scatter")
# the phases that run on the NCCL group of one
GROUP_PHASES = ("train_sharded", "time_sharded", "train_hier", "train_2d", "time_hier")


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
    phase("learn", phase_learn)
    phase("checkpoint", phase_checkpoint)
    phase("step_vs_cpu", phase_step_vs_cpu)
    ttimes = phase("time_train", phase_time_train)
    sharded_phases = {"parity_segment_by_seg", "parity_bucketed", "time_sharded"}
    ids_np = _real_batch(65536)[1]["ids"] if set(phases) & sharded_phases else None
    k6_err = phase("parity_segment_by_seg", phase_parity_segment_by_seg, ids_np)
    k7_err = phase("parity_bucketed", phase_parity_bucketed, ids_np)
    strained = phase("train_sharded", phase_train_sharded, mesh)
    phase("sharded_multi", phase_sharded_multi)
    stimes = phase("time_sharded", phase_time_sharded, mesh, ids_np)
    htrained = phase("train_hier", phase_train_hier, mesh)
    trained_2d = phase("train_2d", phase_train_2d, mesh)
    htimes = phase("time_hier", phase_time_hier, mesh)
    v1 = phase("parity_bwd_v1", phase_parity_bwd_v1)
    probe = phase("parity_dot_probe", phase_parity_dot_probe)
    tools = phase("tools", phase_tools)
    phase("data", phase_data)
    lookup = phase("lookup", phase_lookup)
    tail = phase("conv_tail", phase_conv_tail)
    full = phase("train_full", phase_train_full)
    scatter = phase("scatter", phase_scatter)

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
        # kernel 4: sgd, kernel 7 at nb=1 beside it, and the bench twin's shape
        apply = ttimes["streamed_apply"]
        records[3].update(sgd_ms=apply["sgd_ms"], kernel7_nb1_ms=apply["kernel7_nb1_ms"],
                          touched_rows=apply["touched_rows"],
                          at_bench_shape={k: ttimes["streamed_apply_bench"][k]
                                          for k in keys + ("touched_rows",)})
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
        # kernel 6 twice a hier step (the second on the stage-2 sums), once a
        # 2D step; kernel 7 once a hier step with the apply forced on (none
        # as multihost is configured) and never in 2D
        k6, k7 = records[-2], records[-1]
        hauto, hon = htrained["auto"]["counts"], htrained["k7_on"]["counts"]
        k6["hier_launches_per_step"] = hauto["sorted_segment_sum_by_seg"] / 2
        k6["2d_launches_per_step"] = trained_2d["counts"]["sorted_segment_sum_by_seg"] / 2
        k6["at_hier_stage2"] = {k: htimes["k6_stage2"][k]
                                for k in keys + ("max_abs_err", "n", "m_pad")}
        k7["hier_launches_per_step"] = hauto["bucketed_rowwise_apply"] / 2
        k7["hier_k7_on_launches_per_step"] = hon["bucketed_rowwise_apply"] / 2
        k7["2d_launches_per_step"] = trained_2d["counts"]["bucketed_rowwise_apply"] / 2
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
        records.append({
            "name": "embed_lookup_fm", "route": "cuda",
            "source": "cffm_tpu_torch/ops/csrc/embed_lookup.cu", "replaces": None,
            "launches": lookup["launches"], "max_abs_err": 0.0,
            **{k: lookup[k] for k in keys}, "batch": 65536})
        records.append({
            "name": "conv_tail", "route": "cuda",
            "source": "cffm_tpu_torch/ops/csrc/conv_tail.cu", "replaces": None,
            "launches": tail["launches"], "max_limit_share": tail["max_limit_share"],
            **{k: tail[k] for k in keys}, "batch": 65536,
            "bwd": {k: tail["bwd"][k] for k in keys + ("eager_fwd_bwd_ms", "fused_fwd_bwd_ms")},
            "bwd_drawn_norm_gap": tail["bwd_drawn_norm_gap"]})
        # launches from train_full's counted run of criteo_full
        for name, fn, part, src in (
                ("scatter_segment_sum", "scatter_segment_sum", "sums", "sorted_segment"),
                ("scatter_apply", "scatter_rowwise_apply", "apply", "streamed_update")):
            launches = full["launches"].get(fn, 0)
            records.append({
                "name": name, "route": "cuda", "source": f"cffm_tpu_torch/ops/csrc/{src}.cu",
                "replaces": None, "launches": launches,
                "launches_per_step": launches / full["steps"],
                "max_abs_err": scatter[f"{part}_max_abs_err"],
                **{k: scatter[part][k] for k in keys}, "batch": 32768,
                "live_rows": scatter["live_rows"]})
        print(json.dumps({"kernels": records}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
     rtol=atol=1e-4 and bf16 at rtol=atol=2e-2, lin at 1e-5;
  4. parity_bwd: the same entries' backward (kernel 2, through autograd)
     against the plain backward: dE f32 rtol=atol=1e-4, bf16 2e-2; dW
     rtol=1e-4 with atol 1e-4 of max|dW|; pad lanes and diagonal blocks of
     dE exact zeros, the fused column exactly glin; dW bit-equal in two runs;
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
  8. time the forward kernel, its plain version and torch's conv1d on an
     already built cross map (CUDA events) at B=4096 and B=65536, hold the
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
     at the B=65536 training shapes, hold kernel 2 against its plain
     version there (the phase-4 checks), and time the train step end to
     end with a torch.profiler breakdown.

Prints one JSON line of kernel records, then the card line, and ends
with {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate
# and arithmetic rates by operand type, for the bound of each kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
KERNEL_SOURCES = ["cross_conv1_fwd", "cross_conv1_bwd", "sorted_segment",
                  "streamed_update"]


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    return fm2_err


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
        m = build_cross_map(rows[..., : mcfg.row_width].reshape(
            b, mcfg.num_fields, mcfg.num_fields, mcfg.embed_dim), mcfg)
        w_b = w1.to(torch.bfloat16)
        k = mcfg.conv_kernel
        library_ms = cuda_ms(lambda: F.conv1d(m, w_b, padding=k // 2), reps)
        c1 = w1.shape[0]
        nbytes = ((es.numel() + eb.numel()) * es.element_size()
                  + w1.numel() * w1.element_size()
                  + b * c1 * mcfg.embed_dim * 2 + b * 4)
        ops = 2 * b * c1 * mcfg.embed_dim * mcfg.num_pairs * k
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
        out[b] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": max(t_bytes, t_ops),
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                  "bytes": nbytes, "flops": ops}
        print(f"time B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"conv1d on built M (excludes M's build) {library_ms:.4f} ms, "
              f"bound {max(t_bytes, t_ops):.4f} ms ({out[b]['bound_by']}: "
              f"{nbytes / 1e9:.3f} GB, {ops / 1e9:.1f} GFLOP)", flush=True)
        del es, eb, rows, m
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


def phase_parity_bwd() -> float:
    """Kernel 2 through every entry against the plain backward; returns the
    fm2 bf16 dE error."""
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
    return fm2_err


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
    # the exact sums (f64 of the bf16 grads) against the kernel's bf16 result,
    # which is its f32 sum rounded to nearest: half a bf16 ulp, plus the f32
    # sum's own error, for which 4 * 2^-24 * sqrt(len * sum g^2) (len times
    # the segment's RMS) stands ~30x above the spread of sequential f32 sums
    # of random signs and far below one entry of a hot segment. An exact sum
    # halfway between two bf16 values (a tie) sits at 1.000 of its limit.
    c = int(count)
    if (gsum[c:] != 0).any():
        fail(f"parity_segment {what}: empty slots hold nonzero rows")
    sl = seg.long()
    g64 = grads.to(torch.bfloat16).double()
    exact = torch.zeros((c, grads.shape[1]), dtype=torch.float64,
                        device=sid.device).index_add_(0, sl, g64)
    sumsq = torch.zeros_like(exact).index_add_(0, sl, g64 * g64)
    del g64
    runs = torch.zeros((c,), dtype=torch.float64, device=sid.device).index_add_(
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
    print(f"parity_segment {what}: n={sid.numel()} count={int(count)} m_pad={m_pad} "
          f"longest segment {int(runs[hot])} entries, max id {int(sid.max())}: uids "
          f"and count exact, gsum max_abs_err={err.max().item():.3e} against the exact "
          f"sums, {bad} entries beyond half a bf16 ulp + the f32 term (f32 term on the "
          f"longest segment at most {f32_term[hot].max().item():.3e}; worst entry at "
          f"{ratio.max().item():.3f} of its limit: kernel {got[row, col].item():.6e}, "
          f"exact {exact[row, col].item():.6e}, segment of {int(runs[row])})", flush=True)
    if bad:
        fail(f"parity_segment {what}: gsum beyond half a bf16 ulp + the f32 term")
    return (gsum.float() - gsum_ref.float()).abs().max().item()


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


def _compare_tables(a, b, base, touched, atol_ulps: bool, what: str):
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
        fail(f"parity_apply {what}: {moved} untouched rows changed")
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
    for fn in (ss.sorted_segment_sum_compact, su.streamed_rowwise_apply,
               su.streamed_rowwise_adam_apply):
        out[fn.__name__] = fn.launches
    return out


def _reset_counts():
    from cffm_tpu_torch.ops import interaction_conv as ic
    from cffm_tpu_torch.ops import sorted_segment as ss
    from cffm_tpu_torch.ops import streamed_update as su

    ic.reset_launches()
    for fn in (ss.sorted_segment_sum_compact, su.streamed_rowwise_apply,
               su.streamed_rowwise_adam_apply):
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

    # kernel 2: fm2 backward
    (es, eb), w1 = _inputs(mcfg, b, torch.bfloat16, gen, fm_split=fs)
    c1 = w1.shape[0]
    gy = torch.randn((b, c1, d), generator=gen, device="cuda").to(torch.bfloat16)
    glin = torch.randn((b,), generator=gen, device="cuda")
    des, deb = torch.empty_like(es), torch.empty_like(eb)

    def kernel2():
        return ic.cross_conv1_bwd(ic._descriptors("fm2", mcfg, (es, eb)),
                                  ic._descriptors("fm2", mcfg, (des, deb)), w1, gy, glin,
                                  mcfg, w)

    ms = cuda_ms(kernel2, 5)
    plain_ms = cuda_ms(lambda: ic._rows_bwd_reference(
        torch.cat([es, eb]).transpose(0, 1), w1, gy, glin, mcfg), 2, warmup=1)
    rows = torch.cat([es, eb]).transpose(0, 1)
    dw = kernel2()
    drows_ref, dw_ref = ic._rows_bwd_reference(rows, w1, gy, glin, mcfg)
    bwd_err = _check_rows_grad(torch.cat([des, deb]).transpose(0, 1), drows_ref, dw, dw_ref,
                               glin, mcfg, f"criteo_kaggle fm2 bfloat16 B={b}")
    del drows_ref, dw_ref
    m = build_cross_map(rows[..., : mcfg.row_width].reshape(b, f, f, d), mcfg)
    wb = w1.to(torch.bfloat16)
    library_ms = cuda_ms(lambda: (torch.nn.grad.conv1d_weight(m, wb.shape, gy, padding=k // 2),
                                  F.conv_transpose1d(gy, wb, padding=k // 2)), 5)
    del rows, m
    nbytes = (2 * (es.numel() + eb.numel()) * 2 + gy.numel() * 2 + b * 4
              + w1.numel() * 2 + w1.numel() * 4)
    ops = 2 * (2 * b * d * mcfg.num_pairs * k * c1)
    out["cross_conv1_bwd"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                              "max_abs_err": bwd_err, **_bound(nbytes, ops)}
    del es, eb, des, deb, gy, glin
    torch.cuda.empty_cache()

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
        print(f"time {name} B={b}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
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


PHASES = ("parity", "parity_bwd", "parity_segment", "parity_apply", "serve", "time",
          "train", "step_vs_cpu", "time_train")


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

    fm2_err = phase("parity", phase_parity)
    bwd_err = phase("parity_bwd", phase_parity_bwd)
    seg = phase("parity_segment", phase_parity_segment)
    apply_errs = phase("parity_apply", phase_parity_apply, seg[1]) if seg else None
    seg = seg[0] if seg else None
    served = phase("serve", phase_serve)
    times = phase("time", phase_time, *served[1:]) if served else None
    trained = phase("train", phase_train)
    phase("step_vs_cpu", phase_step_vs_cpu)
    ttimes = phase("time_train", phase_time_train)

    if set(phases) == set(PHASES):
        t = times[4096]
        fwd = {
            "name": "cross_conv1_fwd", "route": "cuda",
            "source": "cffm_tpu_torch/ops/csrc/cross_conv1_fwd.cu",
            "replaces": "cffm_tpu/ops/interaction_conv.py:132",
            "launches": served[0], "max_abs_err": max(fm2_err, times["max_abs_err_65536"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "at_batch_65536": {k: times[65536][k] for k in
                               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
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
        print(json.dumps({"kernels": records}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

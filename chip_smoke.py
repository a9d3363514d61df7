#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Needs one CUDA card and nvcc; exits
nonzero without them, or when any phase fails. Phases, in order:

  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ops/csrc (one nvcc each, in parallel);
  3. hold each kernel entry against its plain PyTorch version on the
     card: criteo_kaggle shapes at B=4096 for the split field-major,
     field-major and flat full-rows entries, movielens shapes for the
     sliced field-aware and hadamard entries; f32 (TF32 off) at
     rtol=atol=1e-4 and bf16 at rtol=atol=2e-2, lin at 1e-5;
  4. serve criteo_kaggle at full width through cffm_tpu_torch.score:
     the 2.6M x 640 f32 table on the card, random params from a fixed
     generator, 8 val batches of 4096; check finite metrics, the count,
     one kernel launch per batch, and the kernel route's logits against
     the reference route's in f32 on one batch;
  5. time the kernel, its plain version and torch's conv1d on an already
     built cross map (CUDA events) at B=4096 and B=65536, and forward
     end to end at B=65536.

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
KERNEL_SOURCES = ["cross_conv1_fwd"]


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


def _movielens_model(cross: str, dtype: str):
    from cffm_tpu_torch.config import get_config

    return dataclasses.replace(get_config("movielens").model, cross=cross,
                               compute_dtype=dtype)


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
        for cross in ("field_aware", "hadamard"):
            mcfg = _movielens_model(cross, name)
            emb, w1 = _inputs(mcfg, 4096, dtype, gen)
            y = ic.cross_conv1(emb, w1, mcfg)
            y_ref = ic.cross_conv1_reference(emb, w1, mcfg)
            err = (y.float() - y_ref.float()).abs().max().item()
            print(f"parity movielens sliced {cross} {name} B=4096: y max_abs_err="
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
    criteo_kaggle fm2 shapes), and forward end to end at 65536."""
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


def main() -> int:
    import torch

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

    fm2_err = phase_parity()
    launches, params, cfg = phase_serve()
    times = phase_time(params, cfg)

    t = times[4096]
    record = {
        "name": "cross_conv1_fwd", "route": "cuda",
        "source": "cffm_tpu_torch/ops/csrc/cross_conv1_fwd.cu",
        "replaces": "cffm_tpu/ops/interaction_conv.py:132",
        "launches": launches, "max_abs_err": fm2_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "at_batch_65536": {k: times[65536][k] for k in
                           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "forward_ms_65536": times["forward_ms_65536"],
    }
    print(json.dumps({"kernels": [record]}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

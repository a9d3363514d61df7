"""Micro-bench the fused cross+conv1 kernel on the card: the sliced-rows
entry `ops.interaction_conv.cross_conv1`, forward, then forward+backward
(the gradient of sum(y^2) with respect to the rows and w1).

    python -m cffm_tpu_torch.scripts.bench_kernel [--batch=32768] [--dtype=bfloat16]

The port's counterpart of `scripts/bench_kernel.py`. Its `--bts` (the TPU
kernel's batch tile) has no counterpart: the CUDA kernels take no tile.
Times are CUDA events per call (`utils.timing`).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch


def run(cfg, batch: int, dtype: torch.dtype, device="cuda", n_fwd: int = 20,
        n_bwd: int = 10) -> dict:
    """Seconds per call of the forward and of forward+backward."""
    from cffm_tpu_torch.ops.interaction_conv import cross_conv1
    from cffm_tpu_torch.utils.timing import time_per_call

    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    f, d = cfg.num_fields, cfg.embed_dim
    emb = torch.randn((batch, f, f, d), generator=gen, device=device).to(dtype)
    c1 = cfg.conv_channels[0]
    rng = np.random.default_rng(0)
    w1 = torch.from_numpy(
        0.1 * rng.normal(size=(c1, cfg.num_pairs, cfg.conv_kernel))).float().to(device)

    with torch.no_grad():
        fwd = time_per_call(lambda: cross_conv1(emb, w1, cfg), n=n_fwd, device=device)

    e = emb.detach().requires_grad_()
    w = w1.detach().requires_grad_()

    def fwd_bwd():
        y = cross_conv1(e, w, cfg)
        return torch.autograd.grad((y.float() ** 2).sum(), (e, w))

    both = time_per_call(fwd_bwd, n=n_bwd, device=device)
    de, dw = fwd_bwd()
    if not (math.isfinite(float(de.float().abs().sum())) and math.isfinite(float(dw.abs().sum()))):
        raise RuntimeError("bench_kernel: the gradients are not finite")
    return {"fwd_s": fwd, "fwd_bwd_s": both}


def main(argv=None) -> int:
    from cffm_tpu_torch import get_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    cfg = get_config("criteo_kaggle").model
    r = run(cfg, args.batch, getattr(torch, args.dtype))
    b = args.batch
    print(f"fwd: {r['fwd_s'] * 1e3:.3f} ms  {b / r['fwd_s'] / 1e6:.2f}M ex/s", flush=True)
    print(f"fwd+bwd: {r['fwd_bwd_s'] * 1e3:.3f} ms  {b / r['fwd_bwd_s'] / 1e6:.2f}M ex/s",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

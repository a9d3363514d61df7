"""Time the backward variants of the fused cross+conv1 kernel on the card.

    python -m cffm_tpu_torch.scripts.bench_bwd_variants [--batch=65536] [--check]
        [--k=3] [--c1=64]

The port's counterpart of `scripts/bench_bwd_variants.py`, at criteo_kaggle
shapes: emb3 (39, B, 640), g (B, 1024), glin (B,) (bf16, bf16, f32), w1
from default_rng(0); --k and --c1 set layer 1's width and channels.
Variants (`ops.bwd_variants`):

  v0  the shipped backward: kernel 2 (cross_conv1_bwd.cu)
  v1  per position, products over one tap window of g: kernel 8a
      (cross_conv1_bwd_v1.cu)
  v2  the TPU's one-dot restructure, equal to v0 bit for bit: kernel 2

--check compares each variant's de[:, :256] with v0's at the TPU script's
rtol=atol=1e-2, and dW at its rtol=1e-3 with atol 1e-4 of max|dW| in place
of its absolute 1e-3: dW sums B*d bf16 products per element in f32, and
kernels 2 and 8a sum them in different orders; at B=65536 max|dW| is about
4.8e3, where one f32 ulp is 4.9e-4, and the two sums stand up to 1.8e-2
apart (NVIDIA H100). Times are CUDA events per call (`utils.timing`). The
TPU's `--bts` has no counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

DW_ATOL = 1e-4  # of max|dW|, as chip_smoke.py's dW checks


def make_inputs(cfg, batch: int, device="cuda", dtype=torch.bfloat16) -> dict:
    """emb3 (F, B, W), g (B, C1*d), glin (B,) f32 from seeded generators;
    w1 (C1, P, k) = 0.1 * default_rng(0) normals; wrs (k*C1, P_pad) and
    wr = wrs.T in the rows' dtype."""
    from cffm_tpu_torch.ops import bwd_variants as bv

    device = torch.device(device)
    f, w, d, k = cfg.num_fields, cfg.table_width, cfg.embed_dim, cfg.conv_kernel
    c1 = cfg.conv_channels[0]
    p_pad = bv.round_up(cfg.num_pairs, 8)

    def normal(seed, shape):
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=device)

    rng = np.random.default_rng(0)
    w1 = torch.from_numpy(0.1 * rng.normal(size=(c1, cfg.num_pairs, k))).float().to(device)
    wrs = bv.prep_w_bwd(w1, cfg, p_pad, dtype)
    return {"emb3": normal(0, (f, batch, w)).to(dtype),
            "g": normal(1, (batch, c1 * d)).to(dtype),
            "glin": normal(2, (batch,)), "w1": w1, "wrs": wrs,
            "wr": wrs.t().contiguous()}


def run(cfg, batch: int, device="cuda", check: bool = False, n: int = 10,
        dtype=torch.bfloat16) -> dict:
    """{variant: seconds per call}; with check, every variant is first held
    against v0 (raises on a mismatch)."""
    from cffm_tpu_torch.ops import bwd_variants as bv
    from cffm_tpu_torch.utils.timing import time_per_call

    x = make_inputs(cfg, batch, device, dtype)
    ref = None
    out = {}
    for name, fn in bv.VARIANTS.items():
        args = (x["emb3"], x["wr"] if name == "v1" else x["wrs"], x["g"], x["glin"], cfg)
        if check:
            de, dw = fn(*args)
            if ref is None:
                ref = (de[:, :256].float(), dw, DW_ATOL * dw.abs().max().item())
            else:
                torch.testing.assert_close(de[:, :256].float(), ref[0], rtol=1e-2, atol=1e-2)
                torch.testing.assert_close(dw, ref[1], rtol=1e-3, atol=ref[2])
            del de, dw
        out[name] = time_per_call(fn, *args, n=n, device=device)
    return out


def main(argv=None) -> int:
    from cffm_tpu_torch import get_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--c1", type=int, default=None)
    args = ap.parse_args(argv)
    cfg = get_config("criteo_kaggle").model
    cfg = dataclasses.replace(cfg, conv_kernel=args.k or cfg.conv_kernel,
                              conv_channels=(args.c1 or cfg.conv_channels[0],)
                              + cfg.conv_channels[1:])
    times = run(cfg, args.batch, check=args.check)
    if args.check:
        print(f"check: v1 and v2 match v0 (dE rtol=atol=1e-2, dW rtol=1e-3 and atol "
              f"{DW_ATOL} of max|dW|)", flush=True)
    for name, dt in times.items():
        print(f"{name} k={cfg.conv_kernel} C1={cfg.conv_channels[0]}: {dt * 1e3:.3f} ms  "
              f"{args.batch / dt / 1e6:.2f}M ex/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

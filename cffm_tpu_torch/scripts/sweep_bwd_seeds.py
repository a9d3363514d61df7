"""Hold the sliced entry's backward against its plain version over seeds.

    python -m cffm_tpu_torch.scripts.sweep_bwd_seeds [--cross=hadamard] [--k=3]
        [--c1=128] [--batch=4096] [--seeds=16] [--first-seed=0]

Per seed: movielens-width rows (d=16) in bf16, the layer-1 weight (unit
normals times sqrt(2 / (P*k)), as chip_smoke.py draws them) and the
output gradient, all from one CUDA generator seeded with it; the
backward of `interaction_conv.cross_conv1` through autograd against
`cross_conv1_bwd_reference`. One line per seed: dE's largest error, the
number of elements outside rtol=atol=2e-2, and the largest error over
the ulp limit (de_limit_ratio); dW's error against 1e-4 of max|dW|.

It imports whichever `cffm_tpu_torch` comes first on the path, so it
also checks another checkout's kernels, e.g. the parent commit's:
`PYTHONPATH=<checkout> python <path of this file>`. Exits nonzero
without a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import torch


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs().clamp(min=1e-30))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def de_limit_ratio(got, ref, de_abs) -> float:
    """max |got - ref| / limit with limit = one bf16 ulp of |ref| (the
    product's own rounding) plus two bf16 ulps of de_abs, the same backward
    taken from |E|, |W| and |g|: dM is summed in f32 in another order and
    rounded to bf16, so one dM may round to the bf16 neighbour of the plain
    version's; where dE's sum over dM times the partner nearly cancels,
    that ulp of dM stands out against dE but not against de_abs. In slices
    of the leading axis, to bound the f32 temporaries."""
    worst = 0.0
    for s in range(0, got.shape[0], 4096):
        g, r = got[s:s + 4096].float(), ref[s:s + 4096].float()
        limit = bf16_ulp(r) + 2 * bf16_ulp(de_abs[s:s + 4096].float())
        worst = max(worst, ((g - r).abs() / limit).max().item())
    return worst


def model(cross: str, k: int, c1: int):
    """movielens' model at d=16 in bf16 with layer 1 of width k and C1
    channels."""
    from cffm_tpu_torch.config import get_config

    cfg = get_config("movielens").model
    return dataclasses.replace(cfg, cross=cross, compute_dtype="bfloat16", embed_dim=16,
                               conv_kernel=k, conv_channels=(c1,) + cfg.conv_channels[1:])


def draw(cfg, batch: int, gen: torch.Generator):
    """(rows, w1, gY) on the generator's device: rows (B, F, F, d) or
    (B, F, d) and gY (B, C1, d) in bf16, w1 (C1, P, k) f32."""
    c1, dev = cfg.conv_channels[0], gen.device
    w1 = torch.randn((c1, cfg.num_pairs, cfg.conv_kernel), generator=gen,
                     device=dev) * math.sqrt(2.0 / (cfg.num_pairs * cfg.conv_kernel))
    shape = ((batch, cfg.num_fields, cfg.num_fields, cfg.embed_dim)
             if cfg.cross == "field_aware" else (batch, cfg.num_fields, cfg.embed_dim))
    emb = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    gy = torch.randn((batch, c1, cfg.embed_dim), generator=gen, device=dev).to(torch.bfloat16)
    return emb, w1, gy


def backward(cfg, emb, w1, gy) -> dict:
    """The kernel route's y, dE and dW, the plain ones, dE taken from |E|,
    |W| and |gY|, and the backward kernel's launches."""
    from cffm_tpu_torch.ops import interaction_conv as ic

    n0 = ic.cross_conv1_bwd.launches
    e, w = emb.detach().requires_grad_(), w1.detach().requires_grad_()
    y = ic.cross_conv1(e, w, cfg)
    de, dw = torch.autograd.grad(y, (e, w), gy)
    de_ref, dw_ref = ic.cross_conv1_bwd_reference(emb, w1, gy, cfg)
    return {"y": y.detach(), "y_ref": ic.cross_conv1_reference(emb, w1, cfg),
            "de": de, "dw": dw, "de_ref": de_ref, "dw_ref": dw_ref,
            "de_abs": ic.cross_conv1_bwd_reference(emb.abs(), w1.abs(), gy.abs(), cfg)[0],
            "launches": ic.cross_conv1_bwd.launches - n0}


def report(r: dict) -> dict:
    """dE's largest error, its elements outside rtol=atol=2e-2 and its
    error over the ulp limit; dW's largest error and 1e-4 of max|dW|."""
    de, ref = r["de"].float(), r["de_ref"].float()
    err = (de - ref).abs()
    return {"de_err": err.max().item(),
            "outside_2e-2": int((err > 2e-2 + 2e-2 * ref.abs()).sum()),
            "ulp_ratio": de_limit_ratio(r["de"], r["de_ref"], r["de_abs"]),
            "dw_err": (r["dw"] - r["dw_ref"]).abs().max().item(),
            "dw_atol": 1e-4 * r["dw_ref"].abs().max().item()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cross", default="hadamard", choices=("hadamard", "field_aware"))
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--c1", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--first-seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_bwd_seeds: no CUDA device", file=sys.stderr)
        return 1
    cfg = model(args.cross, args.k, args.c1)
    what = f"{args.cross} k={args.k} C1={args.c1} bf16 B={args.batch}"
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        r = backward(cfg, *draw(cfg, args.batch, gen))
        m = report(r)
        print(f"sweep_bwd_seeds {what} seed={seed}: dE max_abs_err={m['de_err']:.4e}, "
              f"{m['outside_2e-2']} of {r['de'].numel()} outside rtol=atol=2e-2, "
              f"{m['ulp_ratio']:.3f} of the ulp limit; dW max_abs_err={m['dw_err']:.3e} "
              f"(1e-4 of max|dW| {m['dw_atol']:.3e}); backward launches {r['launches']}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Ablate kernel 2's tensor-core path on the card: where its time goes.

    python -m cffm_tpu_torch.scripts.ablate_bwd [--batch=65536] [--reps=10] [variant ...]

Builds `ops/csrc/cross_conv1_bwd.cu` as it ships and variants of it, each
with one part of the work taken out, so that their results are wrong by
design, and times each through `interaction_conv.cross_conv1_bwd` at
criteo_kaggle's training shapes in bf16 (the split field-major layout),
in the order shipped, variants, shipped. CUDA events per call; one line
per run, then the card. The variants (all by default):

  no_wgmma      neither product is issued
  no_dm         the dM^T product (Gwin read MN-major) is not issued
  no_dw         the dW product (Gwin read K-major) is not issued
  no_e_loads    the producer loads no E (the cross tile and factors are zeros)
  no_de_stores  the consumers write no dE
  no_prefetch   the producer does not prefetch the next tile's rows into L2

Exits nonzero without a CUDA card or nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

SOURCE = "cross_conv1_bwd"

_NO_DM = ("for (int ks = 0; ks < L::kRP / 16; ++ks)", "for (int ks = 0; ks < 0; ++ks)")
_NO_DW = ("for (int ks = 0; ks < kCols / 16; ++ks)", "for (int ks = 0; ks < 0; ++ks)")

# variant -> [(text of the shipped source, its replacement)]
VARIANTS = {
    "no_wgmma": [_NO_DM, _NO_DW],
    "no_dm": [_NO_DM],
    "no_dw": [_NO_DW],
    "no_e_loads": [
        ("          if (pv && b < b_end) {\n            const uint4* ri",
         "          if (false) {\n            const uint4* ri"),
    ],
    "no_de_stores": [
        ("for (int u = ct; u < kPW * kNE * 2; u += 128) {", "for (int u = ct; u < 0; u += 128) {"),
    ],
    "no_prefetch": [
        ("        if (tile + 1 < t_end) {\n#pragma unroll\n          for (int u = 0; u < kEU; ++u)",
         "        if (false) {\n#pragma unroll\n          for (int u = 0; u < kEU; ++u)"),
    ],
}


def variant_source(text: str, name: str) -> str:
    """The shipped source with variant `name`'s replacements; each replaced
    text must occur exactly once."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"ablate_bwd: variant {name} no longer matches the source")
        text = text.replace(old, new)
    return text


def build(names, out_dir: pathlib.Path) -> dict:
    """Compile the shipped source and the named variants, one nvcc each, in
    parallel. Returns {name: loaded library}."""
    from cffm_tpu_torch.ops import _build

    text = (_build._CSRC / f"{SOURCE}.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("shipped",) + tuple(names):
        src = out_dir / f"{name}.cu"
        src.write_text(text if name == "shipped" else variant_source(text, name))
        lib = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                         str(src)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def run(names, batch: int, reps: int) -> list:
    """[(name, ms)] in the order shipped, variants, shipped."""
    import torch

    from cffm_tpu_torch import get_config
    from cffm_tpu_torch.ops import _build
    from cffm_tpu_torch.ops import interaction_conv as ic
    from cffm_tpu_torch.utils.timing import device_time

    libs = build(names, _build._BUILD_DIR / "ablate_bwd")
    cfg = get_config("criteo_kaggle").model
    fs, w, d = cfg.small_field_prefix, cfg.table_width, cfg.embed_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    e = torch.randn((cfg.num_fields, batch, w), generator=gen, device="cuda").to(torch.bfloat16)
    es, eb = e[:fs].contiguous(), e[fs:].contiguous()
    del e
    c1, p, k = cfg.conv_channels[0], cfg.num_pairs, cfg.conv_kernel
    w1 = torch.randn((c1, p, k), generator=gen, device="cuda") * (2.0 / (p * k)) ** 0.5
    gy = torch.randn((batch, c1, d), generator=gen, device="cuda").to(torch.bfloat16)
    glin = torch.randn((batch,), generator=gen, device="cuda")
    des, deb = torch.empty_like(es), torch.empty_like(eb)
    parts = ic._descriptors("fm2", cfg, (es, eb))
    dparts = ic._descriptors("fm2", cfg, (des, deb))
    shipped_load = _build.load
    out = []
    try:
        for name in ("shipped",) + tuple(names) + ("shipped",):
            _build.load = lambda src, _lib=libs[name]: _lib if src == SOURCE else shipped_load(src)
            ms = device_time(lambda: ic.cross_conv1_bwd(parts, dparts, w1, gy, glin, cfg, w),
                             n=reps) * 1e3
            out.append((name, ms))
    finally:
        _build.load = shipped_load
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("variants", nargs="*", help=f"a subset of {sorted(VARIANTS)}")
    args = ap.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    args.variants = args.variants or list(VARIANTS)
    import torch

    if not torch.cuda.is_available():
        print("ablate_bwd: no CUDA device", file=sys.stderr)
        return 1
    from cffm_tpu_torch.bench import card_line

    for name, ms in run(args.variants, args.batch, args.reps):
        print(f"ablate_bwd {name} B={args.batch}: {ms:.4f} ms", flush=True)
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Ablate a kernel on the card: where its time goes.

    python -m cffm_tpu_torch.scripts.ablate_bwd [--kernel=2|8a|4|6] [--batch=65536]
        [--reps=10] [variant ...]

Builds the kernel's source as it ships and variants of it, each with one
part of the work taken out or changed, so that their results may be
wrong by design, and times each at criteo_kaggle's shapes in bf16, in
the order shipped, variants, shipped. CUDA events per call; one line per
run (and shape), then the card. The variants (all of the kernel's by
default):

Kernel 2 (`ops/csrc/cross_conv1_bwd.cu`, the default), timed through
`interaction_conv.cross_conv1_bwd` in the split field-major layout:

  no_wgmma      neither product is issued
  no_dm         the dM^T product (Gwin read MN-major) is not issued
  no_dw         the dW product (Gwin read K-major) is not issued
  no_e_loads    the producer loads no E (the cross tile and factors are zeros)
  no_de_stores  the consumers write no dE
  no_prefetch   the producer does not prefetch the next tile's rows into L2

Kernel 8a (`ops/csrc/cross_conv1_bwd_v1.cu`), timed through
`bwd_variants.bwd_v1` on `bench_bwd_variants`' inputs:

  no_wgmma        neither product is issued
  no_dm           the dM_x products (the window read MN-major) are not issued
  no_dw           the dW products (the window read K-major) are not issued
  no_e_loads      no E is loaded (the factor planes hold zeros)
  no_window       the tap window is not written from g (only its halo zeros)
  no_de_stores    no dE is stored
  no_de_products  dE is not formed at each position (the planes keep E)

Kernel 4 (`ops/csrc/streamed_update.cu`, the touched-row apply), timed
through `streamed_update.streamed_rowwise_apply` (adagrad, a bf16 table
with stochastic rounding) on the bench twin's rows (`bench_apply`'s
bench shape; --batch is not read):

  const_dither     every dither word is 0x80008000 (no Philox call)
  per_pair_dither  one Philox call per column pair (kernel 7's), not per four
  no_prefetch      the next row's loads are issued after this row's stores
  id_per_row       each row's id is read on its own before its loads, not 32 at a time
  rows_in_f32      the rows' gradients are held in f32 registers, not as read (bf16)
  no_division      adagrad multiplies by its denominator instead of dividing

Kernel 6 (`ops/csrc/sorted_segment.cu`, the sorted-segment sum of the
sharded gradient return), timed through
`sorted_segment.sorted_segment_sum_by_seg` at two shapes of criteo_kaggle
at --batch on one card: `t1`, the flat step's segment stream (the batch's
big-field ids sorted), and `stage2`, the hier step's second stage (each
distinct id once, then the stage-1 sentinel slots as one segment):

  no_fill          the empty slots are not zeroed
  no_carry         the chunks' partials are not combined (the passes
                   above the first are not launched)
  no_pass1_stores  the reduction stores no sums and no partials

The same variants apply to the source as it was before the tree (pass
1, a serial pass 2 and the fill), so that another checkout's kernel 6
is ablated with `PYTHONPATH=<checkout> python <path of this file>
--kernel=6`.

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

# kernel 2's variants: name -> [(text of the shipped source, its replacement)]
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

_NO_DM_V1 = ("for (int kr = 0; kr < kR / 16; ++kr)", "for (int kr = 0; kr < 0; ++kr)")
_NO_DW_V1 = ("for (int s = 0; s < K; ++s)\n    wgmma_rs<C1>",
             "for (int s = 0; s < 0; ++s)\n    wgmma_rs<C1>")

# kernel 8a's variants
VARIANTS_V1 = {
    "no_wgmma": [_NO_DM_V1, _NO_DW_V1],
    "no_dm": [_NO_DM_V1],
    "no_dw": [_NO_DW_V1],
    "no_e_loads": [
        ("      if (ij != 0xFFFFu && b < a.batch) {\n        v[it][0][e]",
         "      if (false) {\n        v[it][0][e]"),
    ],
    "no_window": [
        ("      store_window<K, C1>(gw, a, b0, ct);\n", "      (void)b0;\n"),
    ],
    "no_de_stores": [
        ("for (int it = 0; it < kTE && ij != 0xFFFFu; ++it) {",
         "for (int it = 0; it < 0 && ij != 0xFFFFu; ++it) {"),
    ],
    "no_de_products": [
        ("      word(fa, o) = mul2(dm, eb);\n      word(fb, o) = mul2(dm, ea);\n",
         "      (void)dm;\n      (void)ea;\n      (void)eb;\n"),
    ],
}


_K4_LOADS = """    if (next < hi) {
      un = id_of(next);
      load_row(a, un, g + next * a.w2, 0, lane, true, nxt);
    }
"""
_K4_STORES = """    store_row<4>(a, uc, 0, lane, row_step(a, uc, lane, mean, cur.st), 1.f, cur);
"""

# kernel 4's variants
VARIANTS_APPLY = {
    "const_dither": [
        ("if (i % 4 == 0) bits = philox(make_uint4(group, row, 0u, 0u), a.key0, a.key1);",
         "if (i % 4 == 0) bits = make_uint4(0x80008000u, 0x80008000u, 0x80008000u, 0x80008000u);"
         "\n    (void)group;"),
    ],
    "per_pair_dither": [(_K4_STORES, _K4_STORES.replace("store_row<4>", "store_row<1>"))],
    "no_prefetch": [(_K4_LOADS, ""), (_K4_STORES, _K4_STORES + _K4_LOADS)],
    "id_per_row": [("      un = id_of(next);", "      un = a.ids[next];")],
    "rows_in_f32": [("  using Row = RowRegs<T, G, NPL, kM>;",
                     "  using Row = RowRegs<T, float2, NPL, kM>;")],
    "no_division": [("return make_float2((-r.lr) * s.x / r.denom, (-r.lr) * s.y / r.denom);",
                     "return make_float2((-r.lr) * s.x * r.denom, (-r.lr) * s.y * r.denom);")],
}


# kernel 6's variants, on the tree of chunked passes
VARIANTS_SEG = {
    "no_fill": [("  if (m_pad > 0) {\n    const Fill f{",
                 "  if (m_pad < 0) {\n    const Fill f{")],
    "no_carry": [("    if (lv.chunks == 1) break;\n", "    break;\n")],
    "no_pass1_stores": [
        ("    if (s < m_pad) {\n      uint4 o;", "    if (s < m_pad && m_pad < 0) {\n      uint4 o;"),
        ("  float4* q = p + chunk * 2 * a.w8 + 2 * c;\n",
         "  if (a.n >= 0) return;\n  float4* q = p + chunk * 2 * a.w8 + 2 * c;\n"),
    ],
}

# the same on the source before the tree (pass 1, the serial pass 2, fill)
VARIANTS_SEG_SERIAL = {
    "no_fill": [("  if (a.m_pad > 0) fill_kernel<<<", "  if (a.m_pad < 0) fill_kernel<<<")],
    "no_carry": [("    pass2_kernel<<<grid, kThreads, 0, s>>>(a);\n", "")],
    "no_pass1_stores": [
        ("      if (cur_here) {\n        store(a, cur, col, acc);\n      } else {\n"
         "        a.head[static_cast<long long>(chunk) * a.w2 + col] = acc;\n      }",
         "      if (a.m_pad < 0) {\n        store(a, cur, col, acc);\n"
         "        a.head[static_cast<long long>(chunk) * a.w2 + col] = acc;\n      }"),
        ("  if (cur_here) {\n    a.tail[o] = acc;\n  } else {\n    a.head[o] = acc;\n  }",
         "  if (a.m_pad < 0) {\n    a.tail[o] = acc;\n    a.head[o] = acc;\n  }"),
    ],
}


def _kernel2_call(batch: int):
    """Kernel 2's timed call at criteo_kaggle's training shapes."""
    import torch

    from cffm_tpu_torch import get_config
    from cffm_tpu_torch.ops import interaction_conv as ic

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
    return lambda: ic.cross_conv1_bwd(parts, dparts, w1, gy, glin, cfg, w)


def _kernel8a_call(batch: int):
    """Kernel 8a's timed call on bench_bwd_variants' inputs."""
    import torch

    from cffm_tpu_torch import get_config
    from cffm_tpu_torch.ops import bwd_variants as bv
    from cffm_tpu_torch.scripts.bench_bwd_variants import make_inputs

    cfg = get_config("criteo_kaggle").model
    x = make_inputs(cfg, batch, "cuda", torch.bfloat16)
    return lambda: bv.bwd_v1(x["emb3"], x["wr"], x["g"], x["glin"], cfg)


def _kernel4_call(batch: int):
    """Kernel 4's timed call: adagrad on a bf16 table with stochastic
    rounding, on the bench twin's rows (batch is not read)."""
    import torch

    from cffm_tpu_torch.ops import streamed_update as su
    from cffm_tpu_torch.scripts.bench_apply import apply_inputs

    x = apply_inputs("bench")
    gen = torch.Generator(device="cuda").manual_seed(8)
    table = (torch.randn((x["v"], x["w"]), generator=gen, device="cuda") * 0.01).to(
        torch.bfloat16)
    accum = torch.full((x["v"], 1), 0.1, device="cuda")
    return lambda: su.streamed_rowwise_apply(table, accum, x["uids"], x["gsum"], 1e-9, 1e-8,
                                             sr_seed=1234)


def segment_streams(batch: int, device="cuda") -> dict:
    """Kernel 6's inputs at criteo_kaggle B=batch on one card: {"t1": (seg,
    m_pad), "stage2": (seg, m_pad)}. t1 is the flat step's stream, the
    batch's big-field ids sorted (at T=1 each id is its own storage key);
    stage2 the hier step's second stage at H = C = 1: its cap1 stage-1
    slots, each distinct id once and then the sentinel slots, one segment.
    m_pad as the steps size it (`sharded_embedding.grad_return`)."""
    import dataclasses

    import torch

    from cffm_tpu_torch.config import get_config
    from cffm_tpu_torch.data.loader import make_dataset
    from cffm_tpu_torch.optim.rowwise import unique_bound
    from cffm_tpu_torch.ops.sorted_segment import segments
    from cffm_tpu_torch.parallel.hier_embedding import pick_capacities_hier
    from cffm_tpu_torch.parallel.mesh import Mesh
    from cffm_tpu_torch.parallel.sharded_embedding import EB
    from cffm_tpu_torch.parallel.sharded_train import _make_flat_router

    cfg = get_config("criteo_kaggle")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=batch))
    mcfg, fs = cfg.model, cfg.model.small_field_prefix
    ids = torch.from_numpy(next(make_dataset(cfg, prefetch=0))["ids"]).to(device)
    cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(cfg.sharding,
                                                                table_sharded=True))
    seg, count = segments(torch.sort(ids.t()[fs:].reshape(-1)).values)
    live = int(count)

    def pad(m):
        return -(-m // EB) * EB

    n = seg.numel()
    big_unique = unique_bound(mcfg.vocab_sizes[fs:], batch)
    cap = _make_flat_router(cfg, Mesh(None, 0, 1, torch.device(device), False)).capacity
    cap1, cap2 = pick_capacities_hier(
        batch * mcfg.num_fields, 1, 1, cfg.sharding.id_capacity_factor, mcfg.total_vocab,
        unique_bound(mcfg.vocab_sizes, batch), unique_bound(mcfg.vocab_sizes, batch),
        cap_rows=cfg.sharding.cap_rows, cap_rows_host=cfg.sharding.cap_rows_host)
    seg2 = torch.clamp(torch.arange(cap1, device=device, dtype=torch.int32), max=live)
    return {"t1": (seg, pad(min(n, big_unique)) + pad(cap)),
            "stage2": (seg2, pad(min(cap1, big_unique)) + pad(cap2))}


def _kernel6_call(batch: int) -> dict:
    """Kernel 6's timed calls at the t1 and stage2 shapes."""
    import torch

    from cffm_tpu_torch.ops import sorted_segment as ss

    from cffm_tpu_torch.config import get_config

    w = get_config("criteo_kaggle").model.table_width
    gen = torch.Generator(device="cuda").manual_seed(10)
    calls = {}
    for shape, (seg, m_pad) in segment_streams(batch).items():
        g = (torch.randn((seg.numel(), w), generator=gen, device="cuda") * 0.01).to(
            torch.bfloat16)
        print(f"ablate_bwd kernel 6 {shape}: n={seg.numel()} count={int(seg[-1]) + 1} "
              f"m_pad={m_pad}", flush=True)
        calls[shape] = lambda seg=seg, g=g, m_pad=m_pad: ss.sorted_segment_sum_by_seg(
            seg, g, m_pad)
    return calls


# kernel -> (source, variants, the timed call's maker: one call, or
# {shape: call})
KERNELS = {"2": (SOURCE, VARIANTS, _kernel2_call),
           "8a": ("cross_conv1_bwd_v1", VARIANTS_V1, _kernel8a_call),
           "4": ("streamed_update", VARIANTS_APPLY, _kernel4_call),
           "6": ("sorted_segment", VARIANTS_SEG, _kernel6_call)}
# the same variants on a kernel's earlier design, taken where the source
# is another checkout's that has it
EARLIER_VARIANTS = {"6": VARIANTS_SEG_SERIAL}


def variant_source(text: str, name: str, variants=None) -> str:
    """The shipped source with variant `name`'s replacements (from
    `variants`, this script's VARIANTS by default); each replaced text must
    occur exactly once."""
    for old, new in (variants or VARIANTS)[name]:
        if text.count(old) != 1:
            raise ValueError(f"ablate: variant {name} no longer matches the source")
        text = text.replace(old, new)
    return text


def matching_variants(text: str, tables) -> dict:
    """The first of the variant tables whose every replaced text occurs
    exactly once in the source."""
    for table in tables:
        if all(text.count(old) == 1 for reps in table.values() for old, _ in reps):
            return table
    raise ValueError("ablate: no variant table matches the source")


def build(names, out_dir: pathlib.Path, source: str = SOURCE, variants=None,
          earlier=None) -> dict:
    """Compile the shipped `source` and the named variants, one nvcc each,
    in parallel (from `earlier`'s table where `variants`' do not match the
    source). Returns {name: loaded library}."""
    from cffm_tpu_torch.ops import _build

    text = (_build._CSRC / f"{source}.cu").read_text()
    variants = matching_variants(text, (variants or VARIANTS,) + ((earlier,) if earlier else ()))
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("shipped",) + tuple(names):
        src = out_dir / f"{name}.cu"
        src.write_text(text if name == "shipped" else variant_source(text, name, variants))
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


def run(names, batch: int, reps: int, kernel: str = "2") -> list:
    """[(name, shape, ms)] in the order shipped, variants, shipped (shape
    None for a kernel timed at one shape)."""
    from cffm_tpu_torch.ops import _build
    from cffm_tpu_torch.utils.timing import device_time

    source, variants, make_call = KERNELS[kernel]
    libs = build(names, _build._BUILD_DIR / f"ablate_{source}", source, variants,
                 EARLIER_VARIANTS.get(kernel))
    calls = make_call(batch)
    calls = calls if isinstance(calls, dict) else {None: calls}
    shipped_load = _build.load
    out = []
    try:
        for name in ("shipped",) + tuple(names) + ("shipped",):
            _build.load = lambda src, _lib=libs[name]: _lib if src == source else shipped_load(src)
            for shape, call in calls.items():
                out.append((name, shape, device_time(call, n=reps) * 1e3))
    finally:
        _build.load = shipped_load
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="2", choices=sorted(KERNELS))
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("variants", nargs="*", help="a subset of the kernel's variants")
    args = ap.parse_args(argv)
    variants = KERNELS[args.kernel][1]
    unknown = set(args.variants) - set(variants)
    if unknown:
        ap.error(f"unknown variants of kernel {args.kernel}: {sorted(unknown)}")
    args.variants = args.variants or list(variants)
    import torch

    if not torch.cuda.is_available():
        print("ablate_bwd: no CUDA device", file=sys.stderr)
        return 1
    from cffm_tpu_torch.bench import card_line

    for name, shape, ms in run(args.variants, args.batch, args.reps, args.kernel):
        at = f" {shape}" if shape else ""
        print(f"ablate_bwd kernel {args.kernel} {name}{at} B={args.batch}: {ms:.4f} ms",
              flush=True)
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

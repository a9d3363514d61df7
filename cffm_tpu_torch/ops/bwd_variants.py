"""Backward variants of the fused cross + conv1 kernel for the micro-bench.

The port's counterpart of the kernels in `scripts/bench_bwd_variants.py`.
Each variant computes the backward of the field-major full-rows entry with
the fused first-order column (kernel 2's fm+lin launch) from the weights
in its own orientation, and returns it in the script's layout:

  inputs   emb3 (F, B, W) rows, g (B, C1*d) the output gradient, glin (B,)
  outputs  (dE (F, B, W) in the rows' dtype, dW (k, P_pad, C1) f32)

where W = table_width and P_pad = P rounded up to a multiple of 8 (its
last rows are zeros).

  bwd_v0  weights wrs (k*C1, P_pad) from `prep_w_bwd`; launches kernel 2
          (`csrc/cross_conv1_bwd.cu` through `interaction_conv.cross_conv1_bwd`)
  bwd_v1  weights wr (P_pad, k*C1) = wrs.T; launches kernel 8a
          (`csrc/cross_conv1_bwd_v1.cu`): per position x, the products
          over one tap window of g (`bwd_v1_tiles` spells out its
          tensor-core formulation)
  bwd_v2  weights wrs; the TPU's v2 equals the shipped kernel bit for bit
          (tests/test_torch_bwd_variants.py), so it launches kernel 2 too

The weights are taken in the rows' dtype. A wrapper launches its kernel
for CUDA tensors and takes the plain version (`bwd_reference` around
`interaction_conv._rows_bwd_reference`) for CPU tensors; any other device
raises. Each entry counts its kernel launches in its `launches` attribute.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cffm_tpu_torch.config import ModelConfig
from cffm_tpu_torch.ops import _build
from cffm_tpu_torch.ops import interaction_conv as ic
from cffm_tpu_torch.ops.cross import pair_indices

_SOURCE = "cross_conv1_bwd_v1"
# kernel 8a's tensor-core tiles: examples per tile, pairs per chunk
V1_TILE = 16
V1_PAIRS = 64
# the channel counts kernel 8a's tensor-core kernel is built for; a
# narrower layer runs there with zero channels added
V1_CHANNELS = (32, 64)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def prep_w_bwd(w1: torch.Tensor, cfg: ModelConfig, p_pad: int, dtype) -> torch.Tensor:
    """(C1, P, k) -> tap-reversed (k*C1, P_pad): wrs[s*C1 + c, p] =
    w1[c, p, k-1-s], rows P..P_pad-1 zero (the JAX `_prep_w_bwd`)."""
    c1, p, k = w1.shape
    wr = w1.flip(-1).permute(1, 2, 0).to(dtype)               # (P, k, C1)
    wr = F.pad(wr, (0, 0, 0, 0, 0, p_pad - p))
    return wr.reshape(p_pad, k * c1).t().contiguous()


def w1_from_wrs(wrs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The inverse of prep_w_bwd: (k*C1, P_pad) -> (C1, P, k)."""
    k = cfg.conv_kernel
    kc, p_pad = wrs.shape
    return wrs.reshape(k, kc // k, p_pad).flip(0).permute(1, 2, 0)[:, :cfg.num_pairs]


def _dw_layout(dw: torch.Tensor, p_pad: int) -> torch.Tensor:
    """(C1, P, k) -> (k, P_pad, C1), pad rows zero."""
    return F.pad(dw.permute(2, 1, 0), (0, 0, 0, p_pad - dw.shape[1])).contiguous()


def bwd_reference(emb3: torch.Tensor, w1: torch.Tensor, g: torch.Tensor,
                  glin: torch.Tensor, cfg: ModelConfig, p_pad: int):
    """Plain version of every variant: emb3 (F, B, W), w1 (C1, P, k),
    g (B, C1*d), glin (B,). Returns (dE (F, B, W), dW (k, P_pad, C1) f32)."""
    b = emb3.shape[1]
    c1 = w1.shape[0]
    drows, dw = ic._rows_bwd_reference(emb3.transpose(0, 1), w1.to(emb3.dtype),
                                       g.reshape(b, c1, cfg.embed_dim), glin, cfg)
    return drows.transpose(0, 1).contiguous(), _dw_layout(dw, p_pad)


def bwd_v1_reference(emb3, wr, g, glin, cfg: ModelConfig):
    """Plain version of bwd_v1: weights wr (P_pad, k*C1)."""
    return bwd_reference(emb3, w1_from_wrs(wr.t(), cfg), g, glin, cfg, wr.shape[0])


def bwd_v2_reference(emb3, wrs, g, glin, cfg: ModelConfig):
    """Plain version of bwd_v0 and bwd_v2: weights wrs (k*C1, P_pad)."""
    return bwd_reference(emb3, w1_from_wrs(wrs, cfg), g, glin, cfg, wrs.shape[1])


def v1_channels(c1: int) -> int:
    """The channel count kernel 8a's tensor-core kernel would run C1 at:
    the smallest of V1_CHANNELS that holds it, else C1."""
    return next((c for c in V1_CHANNELS if c >= c1), c1)


def v1_pad_channels(wr: torch.Tensor, g: torch.Tensor, k: int, d: int, c1p: int):
    """wr (P_pad, k*C1) and g (B, C1*d) with zero channels up to c1p:
    (P_pad, k*c1p) and (B, c1p*d). The added channels' products are exact
    zeros, so dE keeps its value and dW's first C1 channels are dW."""
    p_pad, kc = wr.shape
    c1 = kc // k
    if c1p == c1:
        return wr, g
    b = g.shape[0]
    wr = F.pad(wr.reshape(p_pad, k, c1), (0, c1p - c1)).reshape(p_pad, k * c1p)
    g = F.pad(g.reshape(b, c1, d), (0, 0, 0, c1p - c1)).reshape(b, c1p * d)
    return wr, g


def v1_window_offset(r, e):
    """Element offset of kernel 8a's tap-window element (row r, example e)
    in a tile's window: 8x8 core matrices (r/8, e/8) at (r/8 * 2 + e/8) *
    64 elements, rows of 8 examples."""
    return ((r // 8) * 2 + e // 8) * 64 + (r % 8) * 8 + e % 8


def v1_window_items(c1: int):
    """Kernel 8a's store_window assignment: (thread, item) -> (channel,
    example pair) for a warpgroup's 128 threads and C1/16 items each, as
    two (128, C1/16) integer tensors."""
    u = torch.arange(128)[:, None] + 128 * torch.arange(c1 // 16)[None, :]
    w, lane = u // 32, u % 32
    return 8 * (w // 2) + lane % 8, 4 * (w % 2) + lane // 8


def v1_window(g: torch.Tensor, k: int, d: int, b0: int) -> torch.Tensor:
    """The tap window of examples b0 .. b0+15 as kernel 8a's store_window
    and halo zeroing write it, flat in v1_window_offset's layout: rows
    q*C1 + c hold g[b, c, q - k//2] for q - k//2 in [0, d) and are zero
    elsewhere, examples past B zero. Shape ((d+k-1) * C1 * V1_TILE,)."""
    b, c1 = g.shape[0], g.shape[1] // d
    gb = g.reshape(b, c1, d)
    out = g.new_zeros(((d + k - 1) * c1 * V1_TILE,))
    c, e2 = (t.reshape(-1) for t in v1_window_items(c1))
    for e in range(2):
        ex = b0 + 2 * e2 + e
        live = ex < b
        for x in range(d):
            r = (x + k // 2) * c1 + c
            out[v1_window_offset(r, 2 * e2 + e)[live]] = gb[ex[live], c[live], x]
    return out


def v1_weight_chunks(wr: torch.Tensor) -> torch.Tensor:
    """wr (P_pad, k*C1) as kernel 8a's tensor-core kernel copies it, one
    chunk of V1_PAIRS pairs at a time: K-major 8x8 core matrices, ordered
    (chunk, pair/8, r/8, pair%8, r%8), pairs past P_pad zero."""
    p_pad, r = wr.shape
    nq = -(-p_pad // V1_PAIRS)
    w = F.pad(wr, (0, 0, 0, nq * V1_PAIRS - p_pad))
    return w.reshape(nq, V1_PAIRS // 8, 8, r // 8, 8).permute(0, 1, 3, 2, 4).contiguous()


def v1_grid(batch: int, sms: int):
    """Kernel 8a's tensor-core grid (the library's wg_grid): (blocks, tiles
    per block, tiles); a block's two warpgroups take alternate tiles."""
    nt = -(-batch // V1_TILE)
    first = min(nt, sms)
    tpb = -(-nt // first) if first else 1
    return (-(-nt // tpb) if nt else 0), tpb, nt


def bwd_v1_tiles(emb3, wr, g, glin, cfg: ModelConfig, sms: int = 132):
    """Kernel 8a's tensor-core formulation in plain torch, its index
    arithmetic spelled out (for tests): each tile's tap window built by
    v1_window and read back through v1_window_offset, each chunk's weights
    unpacked from v1_weight_chunks; per chunk of V1_PAIRS pairs, tile of
    V1_TILE examples and position x, with Gw_x = window rows [x*C1,
    (x+k)*C1),
      dW_all (pairs, k*C1) += M_x Gw_x^T  and  dM_x = wr_chunk Gw_x,
    sums in f32 of operands in the rows' dtype; dM_x rounded, dE = dM times
    the partner factor; dW_all kept per (block, warpgroup) over v1_grid's
    tiles (warpgroups alternate) and the partials summed in that order; dW
    in v1's tap order t = k-1-s. Same signature and outputs as bwd_v1."""
    dt = emb3.dtype
    f, b, wp = emb3.shape
    k, d = cfg.conv_kernel, cfg.embed_dim
    p_pad, kc = wr.shape
    c1, pairs = kc // k, cfg.num_pairs
    rows = (d + k - 1) * c1
    at = v1_window_offset(torch.arange(rows)[:, None], torch.arange(V1_TILE)[None, :])
    chunks = v1_weight_chunks(wr.to(dt))
    wrc = chunks.permute(0, 1, 3, 2, 4).reshape(chunks.shape[0], V1_PAIRS, kc).float()
    blocks, tpb, nt = v1_grid(b, sms)
    pi, pj = (torch.from_numpy(a).long() for a in pair_indices(f))
    de = torch.zeros_like(emb3)
    partials = torch.zeros((2 * blocks, pairs, kc), dtype=torch.float32)
    for q in range(-(-pairs // V1_PAIRS)):
        p = torch.arange(q * V1_PAIRS, min(pairs, (q + 1) * V1_PAIRS))
        i, j = pi[p], pj[p]
        for tile in range(nt):
            row = 2 * (tile // tpb) + (tile - tile // tpb * tpb) % 2
            ex = torch.arange(tile * V1_TILE, min(b, (tile + 1) * V1_TILE))
            n = ex.numel()
            win = v1_window(g.to(dt), k, d, tile * V1_TILE)[at].float()   # (R, 16)
            for x in range(d):
                fa = emb3[i[:, None], ex[None], (d * j + x)[:, None]].float()
                fb = emb3[j[:, None], ex[None], (d * i + x)[:, None]].float()
                m = (fa * fb).to(dt).float()                        # (pairs, n)
                gw = win[x * c1:(x + k) * c1, :n]                   # (k*C1, n)
                partials[row, p] += m @ gw.t()
                dm = (wrc[q, :p.numel()] @ gw).to(dt).float()
                de[i[:, None], ex[None], (d * j + x)[:, None]] = (dm * fb).to(dt)
                de[j[:, None], ex[None], (d * i + x)[:, None]] = (dm * fa).to(dt)
    dw_all = partials[0].clone()
    for r in range(1, 2 * blocks):
        dw_all += partials[r]
    dw = torch.zeros((k, p_pad, c1), dtype=torch.float32)
    for t in range(k):
        dw[t, :pairs] = dw_all[:, (k - 1 - t) * c1:(k - t) * c1]
    de[..., cfg.row_width] = glin.to(dt)[None, :]
    return de, dw


def _check(emb3, w, g, glin, cfg: ModelConfig, v1: bool):
    """The variants' preconditions, raised. Returns (device kind, C1)."""
    if not (cfg.cross == "field_aware" and cfg.fused_linear):
        raise ValueError("the backward variants need a field-aware cross with a "
                         "fused first-order column")
    k = cfg.conv_kernel
    if k % 2 != 1:
        raise ValueError(f"the backward variants take odd k, got {k}")
    f, b, wp = emb3.shape
    if f != cfg.num_fields or wp != cfg.table_width:
        raise ValueError(f"emb3 must be ({cfg.num_fields}, B, {cfg.table_width}), "
                         f"got {tuple(emb3.shape)}")
    if emb3.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"emb3 must be float32 or bfloat16, got {emb3.dtype}")
    p_pad = round_up(cfg.num_pairs, 8)
    kc = w.shape[1 if v1 else 0] if w.dim() == 2 else -1
    want = (p_pad, kc) if v1 else (kc, p_pad)
    if kc < k or kc % k or tuple(w.shape) != want:
        raise ValueError(f"weights must be {'(P_pad, k*C1)' if v1 else '(k*C1, P_pad)'} "
                         f"with P_pad={p_pad}, got {tuple(w.shape)}")
    c1 = kc // k
    if tuple(g.shape) != (b, c1 * cfg.embed_dim) or tuple(glin.shape) != (b,):
        raise ValueError(f"g must be (B, {c1 * cfg.embed_dim}) and glin (B,)")
    kinds = {t.device.type for t in (emb3, w, g, glin)}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"the backward variants take CPU or CUDA tensors on one "
                         f"device kind, got {sorted(kinds)}")
    return kinds.pop(), c1


def _library() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.cffm_cross_conv1_bwd_v1
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i, p, p, ll, ll, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.cffm_cross_conv1_bwd_v1_blocks.argtypes = [i, i]
        lib.cffm_cross_conv1_bwd_v1_blocks.restype = ctypes.c_int
        lib.cffm_cross_conv1_bwd_v1_wgmma.argtypes = [i, p, p, ll, ll, i, i, i, i, i, i]
        lib.cffm_cross_conv1_bwd_v1_wgmma.restype = ctypes.c_int
    return lib


def bwd_v1(emb3: torch.Tensor, wr: torch.Tensor, g: torch.Tensor, glin: torch.Tensor,
           cfg: ModelConfig):
    """The v1 backward from wr (P_pad, k*C1): kernel 8a on CUDA tensors.

    bf16 rows with d=16 and 16-byte aligned rows run on the tensor cores
    (wgmma) at C1 <= 32 with k <= 7 and at 32 < C1 <= 64 with k <= 3,
    brought to 32 or 64 channels by v1_pad_channels, the weights in
    v1_weight_chunks' layout; f32 and every other shape on the CUDA
    cores."""
    kind, c1 = _check(emb3, wr, g, glin, cfg, v1=True)
    if kind == "cpu":
        return bwd_v1_reference(emb3, wr, g, glin, cfg)
    f, b, wp = emb3.shape
    k, p_pad = cfg.conv_kernel, wr.shape[0]
    dt, dev = emb3.dtype, emb3.device
    e = emb3.contiguous()
    w = wr.to(device=dev, dtype=dt).contiguous()
    gg = g.to(device=dev, dtype=dt).contiguous()
    gl = glin.to(device=dev, dtype=torch.float32).contiguous()
    de = torch.empty_like(e)
    lib = _library()
    is_bf16 = int(dt == torch.bfloat16)
    c1k = v1_channels(c1)   # the channels the kernel runs
    wgmma = lib.cffm_cross_conv1_bwd_v1_wgmma(is_bf16, e.data_ptr(), de.data_ptr(), e.stride(0),
                                              e.stride(1), f, cfg.embed_dim, k, c1k,
                                              cfg.row_width, wp)
    if wgmma:
        w, gg = v1_pad_channels(w, gg, k, cfg.embed_dim, c1k)
        w = v1_weight_chunks(w)
        if gg.data_ptr() % 16:
            gg = gg.clone()
    else:
        c1k = c1
    with torch.cuda.device(dev):
        rows = lib.cffm_cross_conv1_bwd_v1_blocks(b, wgmma)
    if rows < 0:
        raise RuntimeError("cross_conv1_bwd_v1: the device's SM count could not be read")
    dwp = torch.empty((rows, k, cfg.num_pairs, c1k), dtype=torch.float32, device=dev)
    dw = torch.empty((k, p_pad, c1k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.cffm_cross_conv1_bwd_v1(
            is_bf16, wgmma, e.data_ptr(), de.data_ptr(), e.stride(0), e.stride(1),
            w.data_ptr(), gg.data_ptr(), gl.data_ptr(), dwp.data_ptr(), dw.data_ptr(), b, f,
            cfg.embed_dim, k, c1k, p_pad, cfg.row_width, wp,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cross_conv1_bwd_v1 kernel launch failed: CUDA error {err}")
    bwd_v1.launches += 1
    return de, (dw if c1k == c1 else dw[..., :c1].contiguous())


def _kernel2(emb3, wrs, g, glin, cfg: ModelConfig):
    """Kernel 2's field-major lin launch, in the script's layout."""
    f, b, wp = emb3.shape
    p_pad = wrs.shape[1]
    e = emb3.contiguous()
    w1 = w1_from_wrs(wrs, cfg)
    gy = g.reshape(b, w1.shape[0], cfg.embed_dim)
    de = torch.empty_like(e)
    dw = ic.cross_conv1_bwd([(e, f, e.stride(0), e.stride(1))],
                            [(de, f, de.stride(0), de.stride(1))],
                            w1, gy, glin, cfg, wp)
    return de, _dw_layout(dw, p_pad)


def bwd_v0(emb3: torch.Tensor, wrs: torch.Tensor, g: torch.Tensor, glin: torch.Tensor,
           cfg: ModelConfig):
    """The shipped backward (JAX `_bwd_pallas(..., glin=glin, fm=True)`)
    from wrs (k*C1, P_pad): kernel 2 on CUDA tensors."""
    kind, _ = _check(emb3, wrs, g, glin, cfg, v1=False)
    if kind == "cpu":
        return bwd_v2_reference(emb3, wrs, g, glin, cfg)
    out = _kernel2(emb3, wrs, g, glin, cfg)
    bwd_v0.launches += 1
    return out


def bwd_v2(emb3: torch.Tensor, wrs: torch.Tensor, g: torch.Tensor, glin: torch.Tensor,
           cfg: ModelConfig):
    """The TPU's v2 (one sublane-contracting dot per gradient) from wrs
    (k*C1, P_pad). It computes what the shipped backward computes, bit for
    bit; on the card it is kernel 2's fm+lin launch."""
    kind, _ = _check(emb3, wrs, g, glin, cfg, v1=False)
    if kind == "cpu":
        return bwd_v2_reference(emb3, wrs, g, glin, cfg)
    out = _kernel2(emb3, wrs, g, glin, cfg)
    bwd_v2.launches += 1
    return out


VARIANTS = {"v0": bwd_v0, "v1": bwd_v1, "v2": bwd_v2}


def reset_launches():
    """Set every variant's launch count to 0."""
    for fn in VARIANTS.values():
        fn.launches = 0


reset_launches()

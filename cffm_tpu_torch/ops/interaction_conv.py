"""Fused pairwise cross + conv layer 1: kernel wrappers, autograd and
plain versions.

The port's counterpart of `cffm_tpu/ops/interaction_conv.py`. The
interaction map M (B, P, d), P = F(F-1)/2, is built on chip and fed
straight into the first, heaviest conv layer (in_channels = P); M never
reaches device memory, forward or backward. The remaining conv layers,
bias, ReLU and pooling run in PyTorch on the small (B, C1, d) activation
(`_conv_tail`).

The forward kernel is `csrc/cross_conv1_fwd.cu`, the backward
`csrc/cross_conv1_bwd.cu`. Four entries keep the contracts of the four
JAX entries:

  cross_conv1          sliced rows (B,F,F,d) | (B,F,d) -> y (B,C1,d)
  cross_conv1_lin      flat full rows (B, F*table_width) -> (y, lin)
  cross_conv1_lin_fm   field-major full rows (F,B,table_width) -> (y, lin)
  cross_conv1_lin_fm2  split field-major rows (Fs,B,W) + (Fb,B,W) -> (y, lin)

where lin[b] = sum_f E[b, f, row_width] in f32 (the fused first-order
column). y is accumulated in f32 and returned in the input dtype; the
cross products are rounded to the input dtype first, as on the TPU.

Each entry is a `torch.autograd.Function`: gradients flow to the rows
(E, or both parts of the fm2 form, in their own layouts) and to `w1`.
The backward follows the JAX kernel: gY is rounded to the input dtype;
dM is accumulated in f32 and rounded to the input dtype; field-aware dE
is dM times the partner row, the product in the input dtype; the
diagonal blocks of dE are exact zeros; glin lands in the fused column of
every field and the other pad lanes are exact zeros; hadamard dE is
summed in f32; dW1 is an f32 sum over the batch.

A wrapper launches the CUDA kernel for a CUDA tensor and takes the plain
PyTorch version (`cross_conv1_reference`, `cross_conv1_bwd_reference`)
for a CPU tensor; any other device raises. Each forward entry counts its
kernel launches in its `launches` attribute, a plain integer, and
`cross_conv1_bwd.launches` counts the backward kernel's. On the card a
shape the kernels are not built for raises before any launch, decided
from shapes (`kernel_takes_width`, `bwd_kernel_takes`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cffm_tpu_torch.config import ModelConfig
from cffm_tpu_torch.ops import _build
from cffm_tpu_torch.ops.cross import (build_cross_map, conv1d_same,
                                      conv_core_reference, max_pool_valid,
                                      pair_indices)

_SOURCE = "cross_conv1_fwd"
_BWD_SOURCE = "cross_conv1_bwd"
# conv widths the kernels are instantiated for (`kernel_takes_width`)
KERNEL_WIDTHS = (1, 3, 5, 7, 9)
# The backward's CUDA-core kernel's limits (csrc/cross_conv1_bwd.cu
# core_takes): channels (two groups of 8 per thread over 32 pairs) and
# dynamic shared memory (the H100's 227 KB less the static pair tables)
BWD_MAX_CHANNELS = 128
BWD_SMEM_MAX = 232448 - 256
_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# Gates: which shapes the kernels take, decided from shapes before a launch
# ---------------------------------------------------------------------------


def kernel_takes_width(k: int) -> bool:
    """Whether the fused kernels are built for conv width k. The model
    sends every odd k to them, as the JAX package sends every odd k to its
    Pallas kernels; on the card an odd k outside KERNEL_WIDTHS raises."""
    return k in KERNEL_WIDTHS


def bwd_kernel_takes(cfg: ModelConfig, c1: int, device=None) -> bool:
    """Whether the backward kernels take layer 1 of C1 channels at the
    config's k, d and cross (the dtype does not matter: the CUDA-core
    kernel stages f32 either way, and the tensor-core kernel takes a subset
    of its shapes). On the card `cross_conv1_bwd` raises for a shape they
    do not take. On a CUDA device the library decides
    (cffm_cross_conv1_bwd_takes); otherwise its rule is evaluated here,
    so that a CPU test sees the same decision (chip_smoke.py checks that
    the two agree)."""
    k, d, had = cfg.conv_kernel, cfg.embed_dim, int(cfg.cross == "hadamard")
    if device is not None and torch.device(device).type == "cuda":
        return bool(_bwd_library().cffm_cross_conv1_bwd_takes(d, k, c1, had))
    c1p = -(-c1 // 8) * 8
    xp = -(-d // 8) * 8 + k - 1
    smem = 4 * (k * c1p * 32 + 8 * xp * c1p + 8 * 32 * xp + (2 + had) * 8 * 32 * d)
    return (kernel_takes_width(k) and d >= 1 and 1 <= c1 <= BWD_MAX_CHANNELS
            and smem <= BWD_SMEM_MAX)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def cross_conv1_reference(emb: torch.Tensor, w1: torch.Tensor, cfg: ModelConfig
                          ) -> torch.Tensor:
    """emb: (B,F,d) or (B,F,F,d). w1: (C1, P, k). Returns (B, C1, d)."""
    m = build_cross_map(emb, cfg)
    return conv1d_same(m, w1.to(m.dtype))


def stacked_weights(w1: torch.Tensor) -> torch.Tensor:
    """The stacked weights A (k*C1, P) of w1 (C1, P, k): A[t*C1 + c] = W1[c, :, t]."""
    c1, p, k = w1.shape
    return w1.permute(2, 0, 1).reshape(k * c1, p)


def stacked_conv1(m: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """The tensor-core forward's formulation in plain torch: Z = A @ M per
    example, then the k row blocks of Z shift-added, y[c, x] = sum_t
    Z[t*C1 + c, x + t - k//2] over the positions inside [0, d). Sums in
    f32, y rounded once to m's dtype. m (B, P, d), w1 (C1, P, k) ->
    y (B, C1, d)."""
    c1, _, k = w1.shape
    b, _, d = m.shape
    lo = (k - 1) // 2
    z = torch.matmul(stacked_weights(w1).to(m.dtype).float(), m.float())
    zp = F.pad(z.reshape(b, k, c1, d), (lo, k - 1 - lo))
    return sum(zp[:, t, :, t:t + d] for t in range(k)).to(m.dtype)


# The tensor-core forward kernel's tiles: pairs per chunk and rows per
# m-tile of the stacked weights
WG_PAIRS = 64
WG_ROWS = 64


def wgmma_weights(w1: torch.Tensor, dtype=None, device=None) -> torch.Tensor:
    """The stacked weights as the tensor-core forward kernel copies them
    into shared memory, one chunk of WG_PAIRS pairs at a time: A zero-padded
    to (MT*64, NQ*64) rows by pairs, then ordered (chunk, k-step of 16
    pairs, 8-row group, pair half, row, 8 pairs), so that each chunk is one
    contiguous block of 8x8 core matrices. Shape (NQ, 4, MT*8, 2, 8, 8)."""
    a = stacked_weights(w1).to(device=device, dtype=dtype)
    r, p = a.shape
    mt, nq = -(-r // WG_ROWS), -(-p // WG_PAIRS)
    a = F.pad(a, (0, nq * WG_PAIRS - p, 0, mt * WG_ROWS - r))
    return a.reshape(mt * 8, 8, nq, WG_PAIRS // 16, 2, 8).permute(2, 3, 0, 4, 1, 5).contiguous()


def bwd_wgmma_weights(w1: torch.Tensor, pairs_per_chunk: int, dtype=None,
                      device=None) -> torch.Tensor:
    """The transposed stacked weights A^T (P, k*C1) as the tensor-core
    backward kernel copies them into shared memory, one chunk of
    `pairs_per_chunk` pairs at a time (the library's
    cffm_cross_conv1_bwd_pair_chunk): A^T zero-padded to (NQ*PC, MT*64)
    pairs by rows, then ordered (chunk, 8-pair group, 8-row group, pair,
    row), so that each chunk is one contiguous block of 8x8 core matrices,
    K-major for the product dM^T = Gwin^T A. Shape (NQ, PC/8, MT*8, 8, 8)."""
    a = stacked_weights(w1).to(device=device, dtype=dtype)
    r, p = a.shape
    pc = pairs_per_chunk
    mt, nq = -(-r // WG_ROWS), -(-p // pc)
    at = F.pad(a.t(), (0, mt * WG_ROWS - r, 0, nq * pc - p))
    return at.reshape(nq, pc // 8, 8, mt * 8, 8).permute(0, 1, 3, 2, 4).contiguous()


def tap_window(g: torch.Tensor, k: int) -> torch.Tensor:
    """The tap window of g (B, C1, d) that the tensor-core backward builds
    per tile: Gwin[t*C1 + c, (b, x)] = g[b, c, x - t + k//2], zero outside
    [0, d). Shape (k*C1, B*d)."""
    b, c1, d = g.shape
    lo = (k - 1) // 2
    gp = F.pad(g, (lo, k - 1 - lo))                   # gp[..., y] = g[..., y - lo]
    taps = [gp[..., 2 * lo - t:2 * lo - t + d] for t in range(k)]
    return torch.stack(taps).permute(0, 2, 1, 3).reshape(k * c1, b * d)


def tap_window_bwd(m: torch.Tensor, w1: torch.Tensor, g: torch.Tensor):
    """The tensor-core backward's formulation in plain torch: with A the
    stacked weights and Gwin the tap window of g, dM^T = Gwin^T A and
    dW_stack = Gwin M^T, both summed in f32 from operands in m's dtype.
    m (B, P, d) the cross map, w1 (C1, P, k), g (B, C1, d). Returns
    (dM (B, P, d) rounded to m's dtype, dW1 (C1, P, k) f32)."""
    c1, p, k = w1.shape
    b, _, d = m.shape
    gw = tap_window(g.to(m.dtype), k).float()                     # (R, B*d)
    a = stacked_weights(w1).to(m.dtype).float()                   # (R, P)
    dm = (gw.t() @ a).reshape(b, d, p).permute(0, 2, 1).to(m.dtype)
    dws = gw @ m.float().permute(0, 2, 1).reshape(b * d, p)       # (R, P)
    return dm, dws.reshape(k, c1, p).permute(1, 2, 0)


def _rows_reference(rows: torch.Tensor, w1: torch.Tensor, cfg: ModelConfig):
    """Plain version of the full-rows entries: rows (B, F, table_width)."""
    b = rows.shape[0]
    f, d = cfg.num_fields, cfg.embed_dim
    emb = rows[..., : cfg.row_width].reshape(b, f, f, d)
    lin = rows[..., cfg.row_width].float().sum(dim=1)
    return cross_conv1_reference(emb, w1, cfg), lin


def cross_conv1_bwd_reference(emb: torch.Tensor, w1: torch.Tensor,
                              gy: torch.Tensor, cfg: ModelConfig):
    """Plain backward of cross_conv1: emb (B,F,F,d) | (B,F,d), gy
    (B, C1, d). Returns (dE in emb's shape and dtype, dW1 (C1, P, k) f32).

    Written out, not autograd of the forward, so that it rounds where the
    kernel does: gY and W1 to emb's dtype, dM summed in f32 then rounded,
    field-aware dE products in emb's dtype, hadamard dE summed in f32."""
    dt = emb.dtype
    b, d = emb.shape[0], cfg.embed_dim
    k = w1.shape[-1]
    lo = (k - 1) // 2
    m = build_cross_map(emb, cfg).float()                  # (B, P, d)
    g = gy.to(dt).float()                                  # (B, C1, d)
    w = w1.to(dt).float()                                  # (C1, P, k)
    # dW[c,p,t] = sum_{b,x} g[b,c,x] M[b,p,x+t-lo]
    mp = F.pad(m, (lo, k - 1 - lo))
    g2 = g.permute(1, 0, 2).reshape(g.shape[1], -1)        # (C1, B*d)
    dw = torch.stack([g2 @ mp[..., t:t + d].permute(0, 2, 1).reshape(-1, m.shape[1])
                      for t in range(k)], dim=-1)          # (C1, P, k)
    # dM[b,p,z] = sum_{c,t} W[c,p,t] g[b,c,z-t+lo]
    gp = F.pad(g, (k - 1 - lo, lo))
    dm = sum(torch.einsum("cp,bcz->bpz", w[:, :, t], gp[..., k - 1 - t:k - 1 - t + d])
             for t in range(k)).to(dt)                     # (B, P, d)
    pi, pj = (torch.from_numpy(a).to(emb.device) for a in pair_indices(cfg.num_fields))
    if cfg.cross == "hadamard":
        acc = torch.zeros(emb.shape, dtype=torch.float32, device=emb.device)
        acc.index_add_(1, pi, dm.float() * emb[:, pj].float())
        acc.index_add_(1, pj, dm.float() * emb[:, pi].float())
        return acc.to(dt), dw
    de = torch.zeros(emb.shape, dtype=dt, device=emb.device)
    de[:, pi, pj] = dm * emb[:, pj, pi]
    de[:, pj, pi] = dm * emb[:, pi, pj]
    return de, dw


def _rows_bwd_reference(rows: torch.Tensor, w1: torch.Tensor, gy: torch.Tensor,
                        glin: torch.Tensor, cfg: ModelConfig):
    """Plain backward of the full-rows entries: rows (B, F, table_width).
    Returns (dRows (B, F, table_width), dW1 (C1, P, k) f32)."""
    b, f = rows.shape[:2]
    emb = rows[..., : cfg.row_width].reshape(b, f, f, cfg.embed_dim)
    de, dw = cross_conv1_bwd_reference(emb, w1, gy, cfg)
    drows = torch.zeros(rows.shape, dtype=rows.dtype, device=rows.device)
    drows[..., : cfg.row_width] = de.reshape(b, f, cfg.row_width)
    drows[..., cfg.row_width] = glin.to(rows.dtype)[:, None]
    return drows, dw


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.cffm_cross_conv1_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i, p, p, i, ll, ll, ll, ll, p, p, p,
                       i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.cffm_cross_conv1_fwd_channel_tile.argtypes = []
        lib.cffm_cross_conv1_fwd_channel_tile.restype = ctypes.c_int
        lib.cffm_cross_conv1_fwd_wgmma.argtypes = [i, p, p, ll, ll, ll, ll, i, i, i, i]
        lib.cffm_cross_conv1_fwd_wgmma.restype = ctypes.c_int
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = _build.load(_BWD_SOURCE)
    fn = lib.cffm_cross_conv1_bwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i, p, p, i, ll, ll, ll, ll, p, p, ll, ll, ll, ll,
                       p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.cffm_cross_conv1_bwd_blocks.argtypes = [i, i]
        lib.cffm_cross_conv1_bwd_blocks.restype = ctypes.c_int
        lib.cffm_cross_conv1_bwd_wgmma.argtypes = [i, p, p, ll, ll, ll, ll, p, p, ll, ll, ll,
                                                   ll, p, i, i, i, i, i]
        lib.cffm_cross_conv1_bwd_wgmma.restype = ctypes.c_int
        lib.cffm_cross_conv1_bwd_pair_chunk.argtypes = [i, i]
        lib.cffm_cross_conv1_bwd_pair_chunk.restype = ctypes.c_int
        lib.cffm_cross_conv1_bwd_takes.argtypes = [i, i, i, i]
        lib.cffm_cross_conv1_bwd_takes.restype = ctypes.c_int
    return lib


def _check_fused(cfg: ModelConfig, lin: bool = False):
    """The JAX entries' preconditions, raised instead of asserted."""
    if cfg.embed_dim % 2 != 0:
        raise ValueError("fused kernel requires even embed_dim")
    if cfg.conv_kernel % 2 != 1:
        raise ValueError("fused kernel supports odd k only")
    if lin and not (cfg.cross == "field_aware" and cfg.fused_linear):
        raise ValueError("full-rows entries need a field-aware cross with "
                         "a fused first-order column")


def _check_launch(parts, w1: torch.Tensor, cfg: ModelConfig):
    t0 = parts[0][0]
    dtype, dev = t0.dtype, t0.device
    if dtype not in _DTYPES:
        raise TypeError(f"cross_conv1 kernels take float32 or bfloat16, got {dtype}")
    for t, _, _, _ in parts:
        if t.device != dev or t.dtype != dtype:
            raise ValueError("all parts must share one CUDA device and dtype")
        if t.stride(-1) != 1:
            raise ValueError("field rows must have contiguous lanes")
    k = cfg.conv_kernel
    if k not in KERNEL_WIDTHS:
        raise ValueError(f"cross_conv1 kernels are built for k in {KERNEL_WIDTHS}, got {k}")
    c1, p, kw = w1.shape
    if p != cfg.num_pairs or kw != k:
        raise ValueError(f"w1 must be (C1, {cfg.num_pairs}, {k}), got {tuple(w1.shape)}")
    return dtype, dev


def _launch(parts, w1: torch.Tensor, cfg: ModelConfig, batch: int, lin: bool):
    """Launch the forward kernel on field rows given as parts.

    parts: [(tensor, num_fields, field_stride, batch_stride)], one or two
    CUDA tensors of one dtype whose field rows have contiguous lanes.
    bf16 rows with d=16, C1 <= 64, k*C1 <= 448 and 16-byte aligned rows
    run on the tensor cores (wgmma), with the weights in `wgmma_weights`'
    layout; every other shape, and f32, on the CUDA cores.
    Returns (y (B, C1, d) in the input dtype, lin (B,) f32 or None)."""
    dtype, dev = _check_launch(parts, w1, cfg)
    k = cfg.conv_kernel
    c1 = w1.shape[0]
    lib = _library()
    e0, nf0, fs0, bs0 = parts[0]
    e1, _, fs1, bs1 = parts[-1]
    is_bf16 = int(dtype == torch.bfloat16)
    wgmma = lib.cffm_cross_conv1_fwd_wgmma(is_bf16, e0.data_ptr(), e1.data_ptr(), fs0, bs0,
                                            fs1, bs1, cfg.num_fields, cfg.embed_dim, k, c1)
    if wgmma:
        wp = wgmma_weights(w1, dtype, dev)
    else:
        tile = lib.cffm_cross_conv1_fwd_channel_tile()
        c1p = -(-c1 // tile) * tile
        # (C1, P, k) -> (P, k, C1p): one pair chunk is one contiguous block
        wp = F.pad(w1.to(device=dev, dtype=dtype).permute(1, 2, 0), (0, c1p - c1))
        wp = wp.contiguous()
    y = torch.empty((batch, c1, cfg.embed_dim), dtype=dtype, device=dev)
    lin_out = torch.empty((batch,), dtype=torch.float32, device=dev) if lin else None
    with torch.cuda.device(dev):
        err = lib.cffm_cross_conv1_fwd(
            is_bf16, wgmma, e0.data_ptr(), e1.data_ptr(), nf0,
            fs0, bs0, fs1, bs1, wp.data_ptr(), y.data_ptr(),
            lin_out.data_ptr() if lin else None, batch, cfg.num_fields,
            cfg.embed_dim, k, c1, int(cfg.cross == "hadamard"),
            cfg.row_width, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cross_conv1_fwd kernel launch failed: CUDA error {err}")
    return y, lin_out


def cross_conv1_bwd(parts, dparts, w1: torch.Tensor, gy: torch.Tensor,
                    glin, cfg: ModelConfig, w_phys: int) -> torch.Tensor:
    """Launch the backward kernel: dE into dparts, returns dW1 (C1, P, k) f32.

    parts / dparts: [(tensor, num_fields, field_stride, batch_stride)] of
    the rows and of their gradient, one or two CUDA tensors each, with the
    same field partition. gy (B, C1, d); glin (B,) or None; w_phys: the
    lanes of one field row (table_width for the full-rows entries).
    Field-aware bf16 rows with d=16, C1 <= 64 (C1 <= 128 at k=3), k <= 7
    and 16-byte aligned rows run on the tensor cores (wgmma), with the
    weights in `bwd_wgmma_weights`' layout; every other shape, and f32, on
    the CUDA cores. Raises for a shape `bwd_kernel_takes` refuses."""
    dtype, dev = _check_launch(parts, w1, cfg)
    k, f, d = cfg.conv_kernel, cfg.num_fields, cfg.embed_dim
    c1, p, _ = w1.shape
    batch = gy.shape[0]
    if tuple(gy.shape) != (batch, c1, d) or (glin is not None and tuple(glin.shape) != (batch,)):
        raise ValueError(f"gy must be (B, {c1}, {d}) and glin (B,)")
    if not bwd_kernel_takes(cfg, c1, dev):
        raise ValueError(f"cross_conv1 backward kernels do not take C1={c1} at k={k}, "
                         f"d={d}, cross={cfg.cross} (see bwd_kernel_takes)")
    lib = _bwd_library()
    for t, _, _, _ in dparts:
        if t.device != dev or t.dtype != dtype or t.stride(-1) != 1:
            raise ValueError("gradient parts must match the rows' device and dtype")
    g = gy.to(device=dev, dtype=dtype).contiguous()
    gl = None if glin is None else glin.to(device=dev, dtype=torch.float32).contiguous()
    hadamard = cfg.cross == "hadamard"
    is_bf16 = int(dtype == torch.bfloat16)
    e0, nf0, fs0, bs0 = parts[0]
    e1, _, fs1, bs1 = parts[-1]
    d0, _, dfs0, dbs0 = dparts[0]
    d1, _, dfs1, dbs1 = dparts[-1]
    wgmma = lib.cffm_cross_conv1_bwd_wgmma(
        is_bf16, e0.data_ptr(), e1.data_ptr(), fs0, bs0, fs1, bs1, d0.data_ptr(),
        d1.data_ptr(), dfs0, dbs0, dfs1, dbs1, g.data_ptr(), f, d, k, c1, int(hadamard))
    if wgmma:
        wt = bwd_wgmma_weights(w1, lib.cffm_cross_conv1_bwd_pair_chunk(k, c1), dtype, dev)
    else:
        wt = w1.to(device=dev, dtype=dtype).permute(2, 0, 1).contiguous()   # (k, C1, P)
    with torch.cuda.device(dev):
        blocks = lib.cffm_cross_conv1_bwd_blocks(batch, wgmma)
    if blocks < 0:
        raise RuntimeError("cross_conv1_bwd: the device's SM count could not be read")
    dwp = torch.empty((blocks, k, p, c1), dtype=torch.float32, device=dev)
    dw = torch.empty((k, p, c1), dtype=torch.float32, device=dev)
    hacc = (torch.empty((batch, f, d), dtype=torch.float32, device=dev)
            if hadamard else None)
    with torch.cuda.device(dev):
        err = lib.cffm_cross_conv1_bwd(
            is_bf16, wgmma, e0.data_ptr(), e1.data_ptr(), nf0,
            fs0, bs0, fs1, bs1, d0.data_ptr(), d1.data_ptr(), dfs0, dbs0,
            dfs1, dbs1, wt.data_ptr(), g.data_ptr(),
            None if gl is None else gl.data_ptr(),
            None if hacc is None else hacc.data_ptr(), dwp.data_ptr(),
            dw.data_ptr(), batch, f, d, k, c1, int(hadamard), cfg.row_width,
            w_phys, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cross_conv1_bwd kernel launch failed: CUDA error {err}")
    cross_conv1_bwd.launches += 1
    return dw.permute(2, 1, 0)


def _require_cuda(*tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"cross_conv1 takes CPU or CUDA tensors, got {t.device}")


# ---------------------------------------------------------------------------
# Layouts and the autograd Function
# ---------------------------------------------------------------------------


def _descriptors(kind: str, cfg: ModelConfig, parts):
    """Kernel part descriptors (tensor, fields, field stride, batch stride)."""
    if kind == "sliced":
        (emb,) = parts
        return [(emb, cfg.num_fields, emb.stride(1), emb.stride(0))]
    if kind == "flat":
        (emb2d,) = parts
        return [(emb2d, cfg.num_fields, cfg.table_width, emb2d.stride(0))]
    return [(t, t.shape[0], t.stride(0), t.stride(1)) for t in parts]


def _plain_rows(kind: str, parts, cfg: ModelConfig) -> torch.Tensor:
    """The full-rows parts as one (B, F, table_width) tensor."""
    if kind == "flat":
        return parts[0].reshape(parts[0].shape[0], cfg.num_fields, -1)
    return torch.cat(list(parts)).transpose(0, 1)


def _split_rows(kind: str, parts, drows: torch.Tensor):
    """(B, F, table_width) gradient -> the parts' own layouts."""
    if kind == "flat":
        return (drows.reshape(parts[0].shape),)
    out, off = [], 0
    for t in parts:
        out.append(drows[:, off:off + t.shape[0]].transpose(0, 1).contiguous())
        off += t.shape[0]
    return tuple(out)


class _Spec:
    """Non-tensor arguments of one entry: the config and the layout kind
    ("sliced" | "flat" | "fm" | "fm2")."""

    def __init__(self, cfg: ModelConfig, kind: str):
        self.cfg, self.kind, self.lin = cfg, kind, kind != "sliced"


class _CrossConv1(torch.autograd.Function):
    """y (, lin) = cross_conv1*(parts, w1); backward to the parts and w1."""

    @staticmethod
    def forward(ctx, spec: _Spec, w1, *parts):
        ctx.spec = spec
        ctx.save_for_backward(w1, *parts)
        cfg, kind = spec.cfg, spec.kind
        if parts[0].device.type == "cuda":
            batch = parts[0].shape[0 if kind in ("sliced", "flat") else 1]
            y, lin = _launch(_descriptors(kind, cfg, parts), w1, cfg, batch, spec.lin)
            return (y, lin) if spec.lin else y
        if kind == "sliced":
            return cross_conv1_reference(parts[0], w1, cfg)
        return _rows_reference(_plain_rows(kind, parts, cfg), w1, cfg)

    @staticmethod
    def backward(ctx, gy, glin=None):
        spec = ctx.spec
        cfg, kind = spec.cfg, spec.kind
        w1, *parts = ctx.saved_tensors
        if parts[0].device.type == "cuda":
            dparts = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in parts]
            w_phys = cfg.table_width if spec.lin else cfg.row_width
            dw = cross_conv1_bwd(_descriptors(kind, cfg, parts),
                                 _descriptors(kind, cfg, dparts), w1, gy,
                                 glin if spec.lin else None, cfg, w_phys)
        elif kind == "sliced":
            de, dw = cross_conv1_bwd_reference(parts[0], w1, gy, cfg)
            dparts = [de]
        else:
            drows, dw = _rows_bwd_reference(_plain_rows(kind, parts, cfg), w1, gy,
                                            glin, cfg)
            dparts = _split_rows(kind, parts, drows)
        return (None, dw.to(w1.dtype), *dparts)


# ---------------------------------------------------------------------------
# The four entries
# ---------------------------------------------------------------------------


def cross_conv1(emb: torch.Tensor, w1: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """Fused cross + conv1 on sliced rows: emb (B,F,F,d) for the
    field-aware cross, (B,F,d) for hadamard. Returns y (B, C1, d)."""
    _check_fused(cfg)
    on_card = emb.device.type != "cpu"
    if on_card:
        _require_cuda(emb)
        f, d = cfg.num_fields, cfg.embed_dim
        want = (f, f, d) if cfg.cross == "field_aware" else (f, d)
        if tuple(emb.shape[1:]) != want:
            raise ValueError(f"emb must be (B, {want}), got {tuple(emb.shape)}")
        if cfg.cross == "field_aware" and emb.stride(2) != d:
            raise ValueError("each field row of emb must be contiguous")
    y = _CrossConv1.apply(_Spec(cfg, "sliced"), w1, emb)
    if on_card:
        cross_conv1.launches += 1
    return y


def cross_conv1_lin(emb2d: torch.Tensor, w1: torch.Tensor, cfg: ModelConfig):
    """Fused cross + conv1 + first-order sum on flat full rows:
    emb2d (B, F*table_width). Returns (y (B, C1, d), lin (B,) f32)."""
    _check_fused(cfg, lin=True)
    b = emb2d.shape[0]
    w = cfg.table_width
    if tuple(emb2d.shape) != (b, cfg.num_fields * w):
        raise ValueError(f"emb2d must be (B, {cfg.num_fields * w}), got {tuple(emb2d.shape)}")
    on_card = emb2d.device.type != "cpu"
    if on_card:
        _require_cuda(emb2d)
    y, lin = _CrossConv1.apply(_Spec(cfg, "flat"), w1, emb2d)
    if on_card:
        cross_conv1_lin.launches += 1
    return y, lin


def cross_conv1_lin_fm(emb3: torch.Tensor, w1: torch.Tensor, cfg: ModelConfig):
    """Field-major twin of cross_conv1_lin: emb3 (F, B, table_width)."""
    _check_fused(cfg, lin=True)
    f, b, w = emb3.shape
    if f != cfg.num_fields or w != cfg.table_width:
        raise ValueError(f"emb3 must be ({cfg.num_fields}, B, {cfg.table_width}), "
                         f"got {tuple(emb3.shape)}")
    on_card = emb3.device.type != "cpu"
    if on_card:
        _require_cuda(emb3)
    y, lin = _CrossConv1.apply(_Spec(cfg, "fm"), w1, emb3)
    if on_card:
        cross_conv1_lin_fm.launches += 1
    return y, lin


def cross_conv1_lin_fm2(e_small: torch.Tensor, e_big: torch.Tensor,
                        w1: torch.Tensor, cfg: ModelConfig):
    """Split-operand twin of cross_conv1_lin_fm for the hybrid lookup:
    e_small (Fs, B, W) and e_big (Fb, B, W) with Fs + Fb = F, read in
    place as one field axis (no concatenation in device memory); the
    gradient comes back as the same two parts."""
    _check_fused(cfg, lin=True)
    fs, b, w = e_small.shape
    fb = e_big.shape[0]
    if (fs + fb != cfg.num_fields or tuple(e_big.shape[1:]) != (b, w)
            or w != cfg.table_width):
        raise ValueError(f"parts must be (Fs, B, {cfg.table_width}) + (Fb, B, "
                         f"{cfg.table_width}) with Fs + Fb = {cfg.num_fields}")
    on_card = not (e_small.device.type == "cpu" and e_big.device.type == "cpu")
    if on_card:
        _require_cuda(e_small, e_big)
    y, lin = _CrossConv1.apply(_Spec(cfg, "fm2"), w1, e_small, e_big)
    if on_card:
        cross_conv1_lin_fm2.launches += 1
    return y, lin


ENTRIES = (cross_conv1, cross_conv1_lin, cross_conv1_lin_fm, cross_conv1_lin_fm2)
for _fn in ENTRIES + (cross_conv1_bwd,):
    _fn.launches = 0


def reset_launches():
    """Set every forward entry's and the backward's launch counts to 0."""
    for fn in ENTRIES + (cross_conv1_bwd,):
        fn.launches = 0


# ---------------------------------------------------------------------------
# Drop-in interaction_fn for the model
# ---------------------------------------------------------------------------


def _conv_tail(x: torch.Tensor, conv_params, cfg: ModelConfig) -> torch.Tensor:
    """bias/ReLU/pool of layer 1, then the remaining conv layers."""
    x = x + conv_params[0]["b"].to(x.dtype)[None, :, None]
    x = torch.relu(x)
    if cfg.conv_pool > 1:
        x = max_pool_valid(x, cfg.conv_pool)
    rest = list(conv_params[1:])
    if rest:
        return conv_core_reference(x, rest, cfg)
    return x.reshape(x.shape[0], -1)


def make_interaction_fn(use_kernel: bool = True):
    """Returns interaction_fn(emb, conv_params, cfg) -> flat features.

    Layer 1 runs in the fused cross+conv1 entry (odd k and even d; other
    shapes take the reference conv, as in the JAX package); bias, ReLU,
    pool and the remaining layers run in PyTorch. With use_kernel the fn
    also carries `.full_rows`, `.full_rows_fm` and `.full_rows_fm2`,
    which take raw physical table rows and return (feats, lin_sum); the
    model routes through them when the config qualifies.
    """

    def interaction_fn(emb, conv_params, cfg: ModelConfig):
        if not conv_params:
            m = build_cross_map(emb, cfg)
            return m.reshape(m.shape[0], -1)
        w1 = conv_params[0]["w"]
        if use_kernel and cfg.conv_kernel % 2 == 1 and cfg.embed_dim % 2 == 0:
            x = cross_conv1(emb, w1, cfg)
        else:
            x = cross_conv1_reference(emb, w1, cfg)
        return _conv_tail(x, conv_params, cfg)

    if use_kernel:
        def full_rows(emb2d, conv_params, cfg: ModelConfig):
            y, lin_sum = cross_conv1_lin(emb2d, conv_params[0]["w"], cfg)
            return _conv_tail(y, conv_params, cfg), lin_sum

        def full_rows_fm(emb3, conv_params, cfg: ModelConfig):
            y, lin_sum = cross_conv1_lin_fm(emb3, conv_params[0]["w"], cfg)
            return _conv_tail(y, conv_params, cfg), lin_sum

        def full_rows_fm2(e_small, e_big, conv_params, cfg: ModelConfig):
            y, lin_sum = cross_conv1_lin_fm2(e_small, e_big,
                                             conv_params[0]["w"], cfg)
            return _conv_tail(y, conv_params, cfg), lin_sum

        interaction_fn.full_rows = full_rows
        interaction_fn.full_rows_fm = full_rows_fm
        interaction_fn.full_rows_fm2 = full_rows_fm2

    return interaction_fn

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
          (`csrc/cross_conv1_bwd_v1.cu`): g staged once per example tile
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

_SOURCE = "cross_conv1_bwd_v1"
# conv widths kernel 8a is instantiated for
WIDTHS = (1, 3, 5, 7)


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


def _check(emb3, w, g, glin, cfg: ModelConfig, v1: bool):
    """The variants' preconditions, raised. Returns (device kind, C1)."""
    if not (cfg.cross == "field_aware" and cfg.fused_linear):
        raise ValueError("the backward variants need a field-aware cross with a "
                         "fused first-order column")
    k = cfg.conv_kernel
    if k not in WIDTHS:
        raise ValueError(f"k must be one of {WIDTHS}, got {k}")
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
        fn.argtypes = [i, p, p, ll, ll, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.cffm_cross_conv1_bwd_v1_blocks.argtypes = [i]
        lib.cffm_cross_conv1_bwd_v1_blocks.restype = ctypes.c_int
    return lib


def bwd_v1(emb3: torch.Tensor, wr: torch.Tensor, g: torch.Tensor, glin: torch.Tensor,
           cfg: ModelConfig):
    """The v1 backward from wr (P_pad, k*C1): kernel 8a on CUDA tensors.

    Field-aware bf16 rows with d=16, C1 <= 64 and 16-byte aligned rows run on
    the tensor cores; f32 and every other shape on the CUDA cores."""
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
    blocks = lib.cffm_cross_conv1_bwd_v1_blocks(b)
    dwp = torch.empty((blocks, k, cfg.num_pairs, c1), dtype=torch.float32, device=dev)
    dw = torch.empty((k, p_pad, c1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.cffm_cross_conv1_bwd_v1(
            int(dt == torch.bfloat16), e.data_ptr(), de.data_ptr(), e.stride(0), e.stride(1),
            w.data_ptr(), gg.data_ptr(), gl.data_ptr(), dwp.data_ptr(), dw.data_ptr(), b, f,
            cfg.embed_dim, k, c1, p_pad, cfg.row_width, wp,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cross_conv1_bwd_v1 kernel launch failed: CUDA error {err}")
    bwd_v1.launches += 1
    return de, dw


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

"""Fused pairwise cross + conv layer 1: kernel wrappers and plain version.

The port's counterpart of `cffm_tpu/ops/interaction_conv.py` (forward
only). The interaction map M (B, P, d), P = F(F-1)/2, is built on chip
and fed straight into the first, heaviest conv layer (in_channels = P);
M never reaches device memory. The remaining conv layers, bias, ReLU and
pooling run in PyTorch on the small (B, C1, d) activation (`_conv_tail`).

The kernel is `csrc/cross_conv1_fwd.cu`. Its four wrappers keep the
contracts of the four JAX entries:

  cross_conv1          sliced rows (B,F,F,d) | (B,F,d) -> y (B,C1,d)
  cross_conv1_lin      flat full rows (B, F*table_width) -> (y, lin)
  cross_conv1_lin_fm   field-major full rows (F,B,table_width) -> (y, lin)
  cross_conv1_lin_fm2  split field-major rows (Fs,B,W) + (Fb,B,W) -> (y, lin)

where lin[b] = sum_f E[b, f, row_width] in f32 (the fused first-order
column). y is accumulated in f32 and returned in the input dtype; the
cross products are rounded to the input dtype first, as on the TPU.

A wrapper launches the CUDA kernel for a CUDA tensor and takes the plain
PyTorch version (`cross_conv1_reference`) for a CPU tensor; any other
device raises. Each wrapper counts its kernel launches in its
`launches` attribute, a plain integer.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cffm_tpu_torch.config import ModelConfig
from cffm_tpu_torch.ops import _build
from cffm_tpu_torch.ops.cross import (build_cross_map, conv1d_same,
                                      conv_core_reference)

_SOURCE = "cross_conv1_fwd"
# conv widths the kernel is instantiated for (any other odd k raises on CUDA)
KERNEL_WIDTHS = (1, 3, 5, 7)
_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def cross_conv1_reference(emb: torch.Tensor, w1: torch.Tensor, cfg: ModelConfig
                          ) -> torch.Tensor:
    """emb: (B,F,d) or (B,F,F,d). w1: (C1, P, k). Returns (B, C1, d)."""
    m = build_cross_map(emb, cfg)
    return conv1d_same(m, w1.to(m.dtype))


def _rows_reference(rows: torch.Tensor, w1: torch.Tensor, cfg: ModelConfig):
    """Plain version of the full-rows entries: rows (B, F, table_width)."""
    b = rows.shape[0]
    f, d = cfg.num_fields, cfg.embed_dim
    emb = rows[..., : cfg.row_width].reshape(b, f, f, d)
    lin = rows[..., cfg.row_width].float().sum(dim=1)
    return cross_conv1_reference(emb, w1, cfg), lin


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.cffm_cross_conv1_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, p, p, i, ll, ll, ll, ll, p, p, p,
                       i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.cffm_cross_conv1_fwd_channel_tile.argtypes = []
        lib.cffm_cross_conv1_fwd_channel_tile.restype = ctypes.c_int
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


def _launch(parts, w1: torch.Tensor, cfg: ModelConfig, batch: int, lin: bool):
    """Launch the kernel on field rows given as parts.

    parts: [(tensor, num_fields, field_stride, batch_stride)], one or two
    CUDA tensors of one dtype whose field rows have contiguous lanes.
    Returns (y (B, C1, d) in the input dtype, lin (B,) f32 or None)."""
    t0 = parts[0][0]
    dtype, dev = t0.dtype, t0.device
    if dtype not in _DTYPES:
        raise TypeError(f"cross_conv1 kernel takes float32 or bfloat16, got {dtype}")
    for t, _, _, _ in parts:
        if t.device != dev or t.dtype != dtype:
            raise ValueError("all parts must share one CUDA device and dtype")
        if t.stride(-1) != 1:
            raise ValueError("field rows must have contiguous lanes")
    k = cfg.conv_kernel
    if k not in KERNEL_WIDTHS:
        raise ValueError(f"cross_conv1 kernel is built for k in {KERNEL_WIDTHS}, got {k}")
    c1, p, kw = w1.shape
    if p != cfg.num_pairs or kw != k:
        raise ValueError(f"w1 must be (C1, {cfg.num_pairs}, {k}), got {tuple(w1.shape)}")

    lib = _library()
    tile = lib.cffm_cross_conv1_fwd_channel_tile()
    c1p = -(-c1 // tile) * tile
    # (C1, P, k) -> (P, k, C1p): one pair chunk is one contiguous block
    wp = F.pad(w1.to(device=dev, dtype=dtype).permute(1, 2, 0), (0, c1p - c1))
    wp = wp.contiguous()
    y = torch.empty((batch, c1, cfg.embed_dim), dtype=dtype, device=dev)
    lin_out = torch.empty((batch,), dtype=torch.float32, device=dev) if lin else None
    e0, nf0, fs0, bs0 = parts[0]
    e1, _, fs1, bs1 = parts[-1]
    with torch.cuda.device(dev):
        err = lib.cffm_cross_conv1_fwd(
            int(dtype == torch.bfloat16), e0.data_ptr(), e1.data_ptr(), nf0,
            fs0, bs0, fs1, bs1, wp.data_ptr(), y.data_ptr(),
            lin_out.data_ptr() if lin else None, batch, cfg.num_fields,
            cfg.embed_dim, k, c1, int(cfg.cross == "hadamard"),
            cfg.row_width, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cross_conv1_fwd kernel launch failed: CUDA error {err}")
    return y, lin_out


def _require_cuda(*tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"cross_conv1 takes CPU or CUDA tensors, got {t.device}")


# ---------------------------------------------------------------------------
# The four entries
# ---------------------------------------------------------------------------


def cross_conv1(emb: torch.Tensor, w1: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """Fused cross + conv1 on sliced rows: emb (B,F,F,d) for the
    field-aware cross, (B,F,d) for hadamard. Returns y (B, C1, d)."""
    _check_fused(cfg)
    if emb.device.type == "cpu":
        return cross_conv1_reference(emb, w1, cfg)
    _require_cuda(emb)
    f, d = cfg.num_fields, cfg.embed_dim
    want = (f, f, d) if cfg.cross == "field_aware" else (f, d)
    if tuple(emb.shape[1:]) != want:
        raise ValueError(f"emb must be (B, {want}), got {tuple(emb.shape)}")
    if cfg.cross == "field_aware" and emb.stride(2) != d:
        raise ValueError("each field row of emb must be contiguous")
    part = (emb, f, emb.stride(1), emb.stride(0))
    y, _ = _launch([part], w1, cfg, emb.shape[0], lin=False)
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
    if emb2d.device.type == "cpu":
        return _rows_reference(emb2d.reshape(b, cfg.num_fields, w), w1, cfg)
    _require_cuda(emb2d)
    part = (emb2d, cfg.num_fields, w, emb2d.stride(0))
    y, lin = _launch([part], w1, cfg, b, lin=True)
    cross_conv1_lin.launches += 1
    return y, lin


def cross_conv1_lin_fm(emb3: torch.Tensor, w1: torch.Tensor, cfg: ModelConfig):
    """Field-major twin of cross_conv1_lin: emb3 (F, B, table_width)."""
    _check_fused(cfg, lin=True)
    f, b, w = emb3.shape
    if f != cfg.num_fields or w != cfg.table_width:
        raise ValueError(f"emb3 must be ({cfg.num_fields}, B, {cfg.table_width}), "
                         f"got {tuple(emb3.shape)}")
    if emb3.device.type == "cpu":
        return _rows_reference(emb3.transpose(0, 1), w1, cfg)
    _require_cuda(emb3)
    part = (emb3, f, emb3.stride(0), emb3.stride(1))
    y, lin = _launch([part], w1, cfg, b, lin=True)
    cross_conv1_lin_fm.launches += 1
    return y, lin


def cross_conv1_lin_fm2(e_small: torch.Tensor, e_big: torch.Tensor,
                        w1: torch.Tensor, cfg: ModelConfig):
    """Split-operand twin of cross_conv1_lin_fm for the hybrid lookup:
    e_small (Fs, B, W) and e_big (Fb, B, W) with Fs + Fb = F, read in
    place as one field axis (no concatenation in device memory)."""
    _check_fused(cfg, lin=True)
    fs, b, w = e_small.shape
    fb = e_big.shape[0]
    if (fs + fb != cfg.num_fields or tuple(e_big.shape[1:]) != (b, w)
            or w != cfg.table_width):
        raise ValueError(f"parts must be (Fs, B, {cfg.table_width}) + (Fb, B, "
                         f"{cfg.table_width}) with Fs + Fb = {cfg.num_fields}")
    if e_small.device.type == "cpu" and e_big.device.type == "cpu":
        return _rows_reference(torch.cat([e_small, e_big]).transpose(0, 1), w1, cfg)
    _require_cuda(e_small, e_big)
    parts = [(e_small, fs, e_small.stride(0), e_small.stride(1)),
             (e_big, fb, e_big.stride(0), e_big.stride(1))]
    y, lin = _launch(parts, w1, cfg, b, lin=True)
    cross_conv1_lin_fm2.launches += 1
    return y, lin


ENTRIES = (cross_conv1, cross_conv1_lin, cross_conv1_lin_fm, cross_conv1_lin_fm2)
for _fn in ENTRIES:
    _fn.launches = 0


def reset_launches():
    """Set every entry's launch count to 0."""
    for fn in ENTRIES:
        fn.launches = 0


# ---------------------------------------------------------------------------
# Drop-in interaction_fn for the model
# ---------------------------------------------------------------------------


def _conv_tail(x: torch.Tensor, conv_params, cfg: ModelConfig) -> torch.Tensor:
    """bias/ReLU/pool of layer 1, then the remaining conv layers."""
    x = x + conv_params[0]["b"].to(x.dtype)[None, :, None]
    x = torch.relu(x)
    if cfg.conv_pool > 1:
        x = F.max_pool1d(x, cfg.conv_pool, cfg.conv_pool)
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

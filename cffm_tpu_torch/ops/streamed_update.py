"""Per-row sparse optimizer apply on the touched rows (adagrad, sgd and
rowwise_adam).

The port's counterpart of `cffm_tpu/ops/streamed_update.py`
(`streamed_rowwise_apply`, `streamed_rowwise_adam_apply`). It keeps the
contract, not the design: the TPU streams the whole table because its
scatter is slow; the kernel (`csrc/streamed_update.cu`) reads and writes
only the rows named in uids, in place. Contract:

  uids (M,) int32 ascending: the unique valid prefix in [0, V), the
  sentinel V in the tail. gsum (M, W) duplicate-summed gradients, taken
  in bf16. Rows outside uids keep table and state bit for bit.

Both functions UPDATE table and state IN PLACE (the JAX step donates its
state) and return them. `pick_tile` and `padded_entries` stay as the
gates and sizes `optim.rowwise` uses, so the port routes as JAX does.
Stochastic rounding into a bf16 table uses Philox in the kernel, keyed
by sr_seed; the plain version draws its dither from a torch.Generator
seeded the same way, so the two agree in distribution, not in bits.

A wrapper launches the CUDA kernel for a CUDA tensor and takes the plain
PyTorch version (`streamed_apply_reference`) for a CPU tensor. Each
entry counts its kernel launches in its `launches` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from cffm_tpu_torch.ops import _build
from cffm_tpu_torch.ops.rounding import random_dither, stochastic_round_bf16

_SOURCE = "streamed_update"
EB = 128  # entry block of the JAX kernel's windows; sizes padded_entries
_MODES = {"sgd": 0, "adagrad": 1, "rowwise_adam": 2}


def pick_tile(num_rows: int) -> int:
    """The JAX kernel's row tile (0 = table too small to stream): the gate
    `optim.rowwise` routes on."""
    for r in (512, 256, 128, 64):
        if num_rows >= r:
            return r
    return 0


def win_blocks(r: int) -> int:
    """Window blocks of the JAX kernel: <= r entries starting anywhere in a block."""
    return (r - 1) // EB + 2


def padded_entries(m: int, r: int) -> int:
    """Entry-array length the JAX kernel needs (idempotent); the port keeps
    it so that uids and gsum have the same length in both packages."""
    return max(-(-m // EB), win_blocks(r)) * EB


def _hyper(lr, eps, extra=()) -> torch.Tensor:
    """f32 hyperparameters (lr, eps, ...) as one CPU tensor."""
    vals = [torch.as_tensor(x, dtype=torch.float32).reshape(()).cpu()
            for x in (lr, eps, *extra)]
    return torch.stack(vals)


def _adam_extra(b1: float, b2: float, t_step):
    """(b1, b2, c1, c2) with c = 1/(1 - b^t) in f32, t the incremented step."""
    t_f = torch.as_tensor(t_step).to(device="cpu", dtype=torch.float32)
    b1t = torch.tensor(b1, dtype=torch.float32)
    b2t = torch.tensor(b2, dtype=torch.float32)
    return b1t, b2t, 1.0 / (1.0 - b1t ** t_f), 1.0 / (1.0 - b2t ** t_f)


def streamed_apply_reference(table: torch.Tensor, state: dict, uids: torch.Tensor,
                             gsum: torch.Tensor, hyper: torch.Tensor, mode: str,
                             sr_seed: int | None = None):
    """Plain version, in place: state holds "accum" (V, 1) for adagrad,
    "m" (V, W) and "v" (V, 1) for rowwise_adam, nothing for sgd."""
    v = table.shape[0]
    valid = (uids >= 0) & (uids < v)
    rows = uids[valid].long()
    s = gsum[valid].to(torch.bfloat16).float()
    h = hyper.to(table.device)
    lr, eps = h[0], h[1]
    if mode == "adagrad":
        acc = state["accum"][rows] + torch.mean(s * s, dim=1, keepdim=True)
        state["accum"][rows] = acc
        delta = (-lr) * s / (torch.sqrt(acc) + eps)
    elif mode == "rowwise_adam":
        b1, b2, c1, c2 = h[2], h[3], h[4], h[5]
        m = b1 * state["m"][rows] + (1.0 - b1) * s
        vn = b2 * state["v"][rows] + (1.0 - b2) * torch.mean(s * s, dim=1, keepdim=True)
        state["m"][rows] = m
        state["v"][rows] = vn
        delta = (-lr) * (m * c1) / (torch.sqrt(vn * c2) + eps)
    elif mode == "sgd":
        delta = (-lr) * s
    else:
        raise ValueError(f"unknown mode {mode!r}")
    new = table[rows].float() + delta
    if table.dtype == torch.bfloat16:
        if sr_seed is None:
            new = new.to(torch.bfloat16)
        else:
            gen = torch.Generator(device=table.device).manual_seed(int(sr_seed))
            new = stochastic_round_bf16(new, random_dither(new.shape, gen, new.device))
    table[rows] = new.to(table.dtype)
    return table


def _library() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.cffm_streamed_apply
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, p, p, p, p, p, p, p, ll, ll, i, i, i, ctypes.c_ulonglong, p]
        fn.restype = ctypes.c_int
    return lib


def _apply(table, state: dict, uids, gsum, hyper, mode: str, sr_seed):
    v, w = table.shape
    if w % 128 != 0:
        raise ValueError(f"streamed update needs a 128-multiple width, got {w}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"streamed update takes an f32 or bf16 table, got {table.dtype}")
    if uids.dim() != 1 or uids.dtype != torch.int32 or gsum.shape != (uids.shape[0], w):
        raise ValueError("uids must be (M,) int32 and gsum (M, W)")
    if table.device.type == "cpu":
        return streamed_apply_reference(table, state, uids, gsum, hyper, mode, sr_seed)
    if table.device.type != "cuda":
        raise ValueError(f"streamed update takes CPU or CUDA tensors, got {table.device}")
    dev = table.device
    want = {"accum": (v, 1), "m": (v, w), "v": (v, 1)}
    for name, t in state.items():
        if (t.shape != want[name] or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"state {name!r} must be a contiguous f32 {want[name]} "
                             f"tensor on {dev}")
    if not table.is_contiguous():
        raise ValueError("the table must be contiguous (updated in place)")
    uids = uids.to(dev).contiguous()
    g = gsum.to(device=dev, dtype=torch.bfloat16).contiguous()
    hyp = hyper.to(dev, non_blocking=True)  # a fresh CPU tensor: no host wait
    stochastic = table.dtype == torch.bfloat16 and sr_seed is not None
    ptrs = {name: t.data_ptr() for name, t in state.items()}
    with torch.cuda.device(dev):
        err = _library().cffm_streamed_apply(
            int(table.dtype == torch.bfloat16), table.data_ptr(),
            ptrs.get("accum"), ptrs.get("m"), ptrs.get("v"),
            uids.data_ptr(), g.data_ptr(), hyp.data_ptr(), v, uids.shape[0], w,
            _MODES[mode], int(stochastic), int(sr_seed or 0) & (2**64 - 1),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"streamed_update kernel launch failed: CUDA error {err}")
    return table


def streamed_rowwise_apply(table: torch.Tensor, accum: torch.Tensor | None,
                           uids: torch.Tensor, gsum: torch.Tensor, lr, eps,
                           sr_seed: int | None = None):
    """Adagrad (accum (V, 1) f32) or sgd (accum None) at the rows in uids,
    in place. sr_seed: an integer that turns on stochastic rounding into a
    bf16 table (None rounds to nearest). Returns (table, accum)."""
    mode = "adagrad" if accum is not None else "sgd"
    state = {"accum": accum} if accum is not None else {}
    table = _apply(table, state, uids, gsum, _hyper(lr, eps), mode, sr_seed)
    if table.device.type == "cuda":
        streamed_rowwise_apply.launches += 1
    return table, accum


def streamed_rowwise_adam_apply(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                                uids: torch.Tensor, gsum: torch.Tensor, lr, eps,
                                b1: float, b2: float, t_step,
                                sr_seed: int | None = None):
    """Rowwise Adam at the rows in uids, in place: full first moment m
    (V, W) f32, row-scalar second moment v (V, 1) f32. t_step is the
    incremented step (state t + 1). Returns (table, m, v)."""
    hyper = _hyper(lr, eps, _adam_extra(b1, b2, t_step))
    table = _apply(table, {"m": m, "v": v}, uids, gsum, hyper, "rowwise_adam", sr_seed)
    if table.device.type == "cuda":
        streamed_rowwise_adam_apply.launches += 1
    return table, m, v


streamed_rowwise_apply.launches = 0
streamed_rowwise_adam_apply.launches = 0

"""Per-row sparse optimizer apply on the touched rows (adagrad, sgd and
rowwise_adam).

The port's counterpart of `cffm_tpu/ops/streamed_update.py`. It keeps the
contract, not the design: the TPU streams the whole table because its
scatter is slow; the kernels (`csrc/streamed_update.cu`) read and write
only the rows they are given, in place. Two contracts:

  flat (`streamed_rowwise_apply`, `streamed_rowwise_adam_apply`; kernels
  4-5): uids (M,) int32 ascending: the unique valid prefix in [0, V), the
  sentinel V in the tail. gsum (M, W) duplicate-summed gradients, taken
  in bf16.
  bucketed (`bucketed_rowwise_apply`, `bucketed_rowwise_adam_apply`;
  kernel 7, the sharded step's update): ids (NB, C) int32, each bucket
  ascending and unique with the sentinel (>= V) in its empty tail; g
  (NB, C, W), taken in bf16, garbage in sentinel slots. A row present in
  several buckets has its partials summed in f32, in bucket order, before
  the optimizer math; `clip` > 0 clips that total's L2 norm.

Rows outside the ids keep table and state bit for bit. Every function
UPDATES table and state IN PLACE (the JAX step donates its state) and
returns them. `pick_tile`, `padded_entries` and `bucketed_tile` stay as
the gates and sizes `optim.rowwise` uses, so the port routes as JAX does.
Stochastic rounding into a bf16 table uses Philox in the kernel, keyed
by sr_seed; the plain version draws its dither from a torch.Generator
seeded the same way, so the two agree in distribution, not in bits.

A wrapper launches the CUDA kernel for a CUDA tensor and takes the plain
PyTorch version (`streamed_apply_reference`) for a CPU tensor. Each
entry counts its kernel launches in its `launches` attribute.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cffm_tpu_torch.ops import _build
from cffm_tpu_torch.ops.rounding import random_dither, stochastic_round_bf16

_SOURCE = "streamed_update"
EB = 128  # entry block of the JAX kernel's windows; sizes padded_entries
MAX_RESIDENT_IDS_BYTES = 32 * 1024 * 1024  # the JAX kernel's VMEM guard on the ids
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


def bucketed_tile(num_rows: int, width: int, nb: int, c: int) -> int:
    """The JAX bucketed kernel's row tile (0 = unsupported): the gate
    `optim.rowwise.bucketed_rowwise_update` routes on. Each bucket must
    hold a full entry window and be EB-aligned, and the ids must fit the
    JAX kernel's VMEM guard."""
    if width % 128 != 0 or c % EB != 0 or nb * c * 4 > MAX_RESIDENT_IDS_BYTES:
        return 0
    for r in (512, 256, 128, 64):
        if num_rows >= r and c >= win_blocks(r) * EB:
            return r
    return 0


# widest row kernel 7 takes: cffm_bucketed_max_width() of csrc/streamed_update.cu
# (chip_smoke.py checks that the two agree); the plain version has no cap
BUCKETED_MAX_WIDTH = 64 * 32


def bucketed_kernel_takes(w: int, device=None) -> bool:
    """Whether kernel 7 takes rows of w lanes: the gate
    `optim.rowwise.bucketed_rowwise_update` adds to `bucketed_tile`. A
    wider table takes the flattened `rowwise_update` route (kernels 3-4),
    which gives the same result. On a CUDA device the cap is the
    library's own; otherwise BUCKETED_MAX_WIDTH, its copy, so that the
    route is the same on both."""
    if device is not None and torch.device(device).type == "cuda":
        return w <= _library().cffm_bucketed_max_width()
    return w <= BUCKETED_MAX_WIDTH


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
    """Plain version of kernels 4-5, in place: state holds "accum" (V, 1)
    for adagrad, "m" (V, W) and "v" (V, 1) for rowwise_adam, nothing for
    sgd."""
    v = table.shape[0]
    valid = (uids >= 0) & (uids < v)
    return _apply_rows(table, state, uids[valid].long(),
                       gsum[valid].to(torch.bfloat16).float(), hyper, mode, sr_seed)


def bucketed_apply_reference(table: torch.Tensor, state: dict, ids_bkt: torch.Tensor,
                             g_bkt: torch.Tensor, hyper: torch.Tensor, mode: str,
                             clip: float = 0.0, sr_seed: int | None = None):
    """Plain version of kernel 7, in place: the valid rows of each bucket
    summed into an f32 buffer one bucket at a time, in order, then the
    per-row clip, then the update of `streamed_apply_reference`."""
    v = table.shape[0]
    valid = (ids_bkt >= 0) & (ids_bkt < v)
    rows = torch.unique(ids_bkt[valid].long())
    slot = torch.searchsorted(rows, ids_bkt.long())
    s = torch.zeros((rows.numel(), table.shape[1]), dtype=torch.float32, device=table.device)
    for o in range(ids_bkt.shape[0]):  # a row occurs at most once per bucket
        s.index_add_(0, slot[o][valid[o]], g_bkt[o][valid[o]].to(torch.bfloat16).float())
    if clip > 0:
        norm = torch.sqrt(torch.sum(s * s, dim=1, keepdim=True))
        s = s * torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    return _apply_rows(table, state, rows, s, hyper, mode, sr_seed)


# slots the bucketed kernel merges in shared memory per window (k7Win)
BUCKETED_WINDOW = 2048


def bucketed_owners(ids_bkt, rows: int, groups: int, window: int = BUCKETED_WINDOW):
    """The bucketed kernel's partition and ownership rule in plain Python
    (csrc/streamed_update.cu `bucketed_kernel`; `groups` is its grid, as
    many blocks as the card holds at once). Each bucket's live range is
    [first id >= 0, first id >= rows); block k owns the ids in
    [s_k, s_k+1), s_k taken at step k/groups
    of the longest live range (s_0 = 0, s_groups = rows), and walks them in
    windows of at most `window` slots that each hold every occurrence of
    their ids; in a window the slots go in (id, bucket) order and the first
    slot of each id owns the row. Returns, per block, its rows in order as
    (id, [(bucket, slot), ...]) with the partials in bucket order."""
    ids = np.asarray(ids_bkt).astype(np.int64)
    nb = ids.shape[0]
    lo = [int(np.searchsorted(ids[b], 0)) for b in range(nb)]
    hi = [int(np.searchsorted(ids[b], rows)) for b in range(nb)]
    best = max(range(nb), key=lambda b: (hi[b] - lo[b], -b))
    length = hi[best] - lo[best]
    cap = window // nb
    out = []
    for k in range(groups):
        owned = []
        out.append(owned)
        if length == 0:
            continue
        s_lo = 0 if k == 0 else int(ids[best, lo[best] + k * length // groups])
        s_hi = rows if k + 1 == groups else int(ids[best, lo[best] + (k + 1) * length // groups])
        if s_lo >= s_hi:
            continue
        cur = [lo[b] + int(np.searchsorted(ids[b, lo[b]:hi[b]], s_lo)) for b in range(nb)]
        end = [lo[b] + int(np.searchsorted(ids[b, lo[b]:hi[b]], s_hi)) for b in range(nb)]
        while any(cur[b] < end[b] for b in range(nb)):
            v_end = s_hi
            for b in range(nb):
                if end[b] - cur[b] > cap:
                    v_end = min(v_end, int(ids[b, cur[b] + cap - 1]) + 1)
            merged = []
            for b in range(nb):
                seg = ids[b, cur[b]:cur[b] + min(cap, end[b] - cur[b])]
                n = int(np.searchsorted(seg, v_end))
                merged += [(int(seg[j]), b, cur[b] + j) for j in range(n)]
                cur[b] += n
            runs = []
            for x, b, j in sorted(merged):  # (id, bucket) order
                if runs and runs[-1][0] == x:
                    runs[-1][1].append((b, j))
                else:
                    runs.append((x, [(b, j)]))
            owned += runs
    return out


def _apply_rows(table, state: dict, rows: torch.Tensor, s: torch.Tensor,
                hyper: torch.Tensor, mode: str, sr_seed: int | None):
    """The update of the unique rows `rows` by their f32 gradients s, in place."""
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
        p, i, ll, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
        fn.argtypes = [i, p, p, p, p, p, p, p, ll, ll, i, i, i, u64, p]
        fn.restype = ctypes.c_int
        lib.cffm_bucketed_apply.argtypes = [i, p, p, p, p, p, p, p, ll, i, ll, i, i,
                                            ctypes.c_float, i, u64, p]
        lib.cffm_bucketed_apply.restype = ctypes.c_int
        lib.cffm_bucketed_max_width.argtypes = []
        lib.cffm_bucketed_max_width.restype = ctypes.c_int
    return lib


def _apply(table, state: dict, ids, g, hyper, mode: str, sr_seed, clip=None):
    """Kernels 4-5 (ids (M,), clip None) or kernel 7 (ids (NB, C)), or the
    plain version on the CPU."""
    v, w = table.shape
    if w % 128 != 0:
        raise ValueError(f"streamed update needs a 128-multiple width, got {w}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"streamed update takes an f32 or bf16 table, got {table.dtype}")
    if ids.dtype != torch.int32 or g.shape != (*ids.shape, w) or ids.dim() != (
            1 if clip is None else 2):
        raise ValueError("ids must be (M,) int32 with gsum (M, W), or (NB, C) int32 "
                         "with g (NB, C, W) for the bucketed apply")
    if table.device.type == "cpu":
        if clip is None:
            return streamed_apply_reference(table, state, ids, g, hyper, mode, sr_seed)
        return bucketed_apply_reference(table, state, ids, g, hyper, mode, clip, sr_seed)
    if table.device.type != "cuda":
        raise ValueError(f"streamed update takes CPU or CUDA tensors, got {table.device}")
    dev = table.device
    lib = _library()
    if clip is not None and w > lib.cffm_bucketed_max_width():
        raise ValueError(f"the bucketed apply takes W <= {lib.cffm_bucketed_max_width()}, "
                         f"got {w}")
    want = {"accum": (v, 1), "m": (v, w), "v": (v, 1)}
    for name, t in state.items():
        if (t.shape != want[name] or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"state {name!r} must be a contiguous f32 {want[name]} "
                             f"tensor on {dev}")
    if not table.is_contiguous():
        raise ValueError("the table must be contiguous (updated in place)")
    ids = ids.to(dev).contiguous()
    g = g.to(device=dev, dtype=torch.bfloat16).contiguous()
    hyp = hyper.to(dev, non_blocking=True)  # a fresh CPU tensor: no host wait
    stochastic = int(table.dtype == torch.bfloat16 and sr_seed is not None)
    seed = int(sr_seed or 0) & (2**64 - 1)
    ptrs = {name: t.data_ptr() for name, t in state.items()}
    common = (int(table.dtype == torch.bfloat16), table.data_ptr(), ptrs.get("accum"),
              ptrs.get("m"), ptrs.get("v"), ids.data_ptr(), g.data_ptr(), hyp.data_ptr(), v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if clip is None:
            err = lib.cffm_streamed_apply(*common, ids.shape[0], w, _MODES[mode],
                                          stochastic, seed, stream)
        else:
            err = lib.cffm_bucketed_apply(*common, ids.shape[0], ids.shape[1], w,
                                          _MODES[mode], float(clip), stochastic, seed, stream)
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


def bucketed_rowwise_apply(table: torch.Tensor, accum: torch.Tensor | None,
                           ids_bkt: torch.Tensor, g_bkt: torch.Tensor, lr, eps,
                           clip: float = 0.0, sr_seed: int | None = None):
    """Kernel 7, adagrad (accum (V, 1) f32) or sgd (accum None), in place,
    straight from the sharded gradient return's buckets: ids_bkt (NB, C),
    g_bkt (NB, C, W) (see the module note). clip > 0: per-row L2 clip of
    each row's cross-bucket total. Returns (table, accum)."""
    mode = "adagrad" if accum is not None else "sgd"
    state = {"accum": accum} if accum is not None else {}
    table = _apply(table, state, ids_bkt, g_bkt, _hyper(lr, eps), mode, sr_seed,
                   clip=float(clip))
    if table.device.type == "cuda":
        bucketed_rowwise_apply.launches += 1
    return table, accum


def bucketed_rowwise_adam_apply(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                                ids_bkt: torch.Tensor, g_bkt: torch.Tensor, lr, eps,
                                b1: float, b2: float, t_step, clip: float = 0.0,
                                sr_seed: int | None = None):
    """Kernel 7, rowwise Adam from the buckets, in place (see
    `bucketed_rowwise_apply` and `streamed_rowwise_adam_apply`). Returns
    (table, m, v)."""
    hyper = _hyper(lr, eps, _adam_extra(b1, b2, t_step))
    table = _apply(table, {"m": m, "v": v}, ids_bkt, g_bkt, hyper, "rowwise_adam", sr_seed,
                   clip=float(clip))
    if table.device.type == "cuda":
        bucketed_rowwise_adam_apply.launches += 1
    return table, m, v


streamed_rowwise_apply.launches = 0
streamed_rowwise_adam_apply.launches = 0
bucketed_rowwise_apply.launches = 0
bucketed_rowwise_adam_apply.launches = 0

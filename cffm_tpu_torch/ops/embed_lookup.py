"""The field-major lookup in one pass: (B, F) ids -> the compute-dtype
operands (emb_small, emb_big) of the split field-major interaction entry.

`lookup_fm` launches `csrc/embed_lookup.cu` for a CUDA tensor: one kernel
gathers the rows of both operands from the table, casts them to the output
dtype and writes the small-field prefix's zero rows, reading the ids in
place through their strides. It replaces no TPU kernel (the JAX package
leaves the gather and the cast to XLA); the source's note says what bounds
it. For a CPU tensor it takes `lookup_fm_reference`, the chain the port ran
before the kernel: `index_select` of clamped ids, the cast, and the prefix's
`torch.where`. Its `launches` attribute counts kernel launches, and under a
torch profiler each launch adds the rows it wrote to the counter
`lookup.fused_rows` (`utils/profiling.py`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cffm_tpu_torch.ops import _build
from cffm_tpu_torch.utils import profiling

_SOURCE = "embed_lookup"
# prefix fields one launch takes (the kernel's argument block holds their bounds)
MAX_SMALL_FIELDS = 512
_DTYPES = (torch.float32, torch.bfloat16)
_ID_DTYPES = (torch.int32, torch.int64)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] with ids clamped to [0, V-1] (jnp.take's mode="clip")."""
    flat = ids.reshape(-1).clamp(0, table.shape[0] - 1)
    return table.index_select(0, flat).reshape(*ids.shape, table.shape[1])


def lookup_fm_reference(table: torch.Tensor, ids: torch.Tensor, bounds: tuple,
                        out_dtype: torch.dtype):
    """Plain version of `lookup_fm`: the gather, the cast and the prefix's
    where, each a pass of its own."""
    fs = max(len(bounds) - 1, 0)
    ids_fm = ids.t()
    b, w = ids.shape[0], table.shape[1]
    if fs:
        edges = torch.tensor(bounds, dtype=torch.int64, device=ids.device)[:, None]
        small = ids_fm[:fs]
        valid = (small >= edges[:-1]) & (small < edges[1:])
        rows = take_rows(table[: bounds[-1]], small).to(out_dtype)
        # where lays its output out as the transposed ids are: made contiguous
        emb_small = torch.where(valid[..., None], rows, torch.zeros(
            (), dtype=out_dtype, device=rows.device)).contiguous()
    else:
        emb_small = torch.empty((0, b, w), dtype=out_dtype, device=table.device)
    return emb_small, take_rows(table, ids_fm[fs:]).to(out_dtype)


def lookup_fm(table: torch.Tensor, ids: torch.Tensor, bounds: tuple,
              out_dtype: torch.dtype):
    """The field-major operands of ids (B, F) int32 or int64 from table (V, W).

    bounds: () or the fs + 1 edges of the small-field prefix, field f < fs
    holding the global ids [bounds[f], bounds[f + 1]). Returns (emb_small
    (fs, B, W), emb_big (F - fs, B, W)), both contiguous in out_dtype:
    emb_small[f, b] is table[ids[b, f]] when that id lies in field f's block
    and a row of zeros otherwise (the one-hot product's answer), emb_big[f,
    b] is table[clamp(ids[b, fs + f], 0, V - 1)]. A CUDA table takes f32 or
    bf16 rows with W a multiple of 8, and gives f32 or bf16."""
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"lookup_fm takes a (V, W) table and (B, F) ids, got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if len(bounds) - 1 > ids.shape[1]:
        raise ValueError(f"{len(bounds) - 1} prefix fields of {ids.shape[1]}")
    if table.device != ids.device:
        raise ValueError("table and ids must share a device")
    if table.device.type == "cpu":
        return lookup_fm_reference(table, ids, bounds, out_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"lookup_fm takes CPU or CUDA tensors, got {table.device}")
    return _fused(table, ids, bounds, out_dtype)


def _fused(table, ids, bounds, out_dtype):
    """The kernel's checks, outputs, launch and counts."""
    v, w = table.shape
    b, f = ids.shape
    fs = max(len(bounds) - 1, 0)
    if table.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"lookup_fm's kernel reads and writes f32 or bf16, got "
                        f"{table.dtype} -> {out_dtype}")
    if ids.dtype not in _ID_DTYPES:
        raise TypeError(f"lookup_fm's kernel takes int32 or int64 ids, got {ids.dtype}")
    if w % 8:
        raise ValueError(f"lookup_fm's kernel needs W % 8 == 0 (16-byte stores), got {w}")
    if table.stride() != (w, 1) or table.data_ptr() % 16:
        raise ValueError("lookup_fm's kernel needs contiguous table rows on a 16-byte boundary")
    if fs > MAX_SMALL_FIELDS or (fs and not 0 <= bounds[0] <= bounds[-1] < 2**31):
        raise ValueError(f"lookup_fm's kernel takes at most {MAX_SMALL_FIELDS} prefix fields "
                         f"with int32 bounds, got {fs} ending at {bounds[-1] if fs else 0}")
    emb_small = torch.empty((fs, b, w), dtype=out_dtype, device=table.device)
    emb_big = torch.empty((f - fs, b, w), dtype=out_dtype, device=table.device)
    if f * b:
        _launch(table, ids, bounds, emb_small, emb_big)
        lookup_fm.launches += 1
        profiling.count("lookup.fused_rows", f * b)
    return emb_small, emb_big


lookup_fm.launches = 0


@functools.lru_cache(maxsize=64)
def _bounds_array(bounds: tuple):
    return (ctypes.c_int * len(bounds))(*bounds) if bounds else None


def _library() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.cffm_embed_lookup_fm
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cffm_embed_lookup_max_small.argtypes = []
        lib.cffm_embed_lookup_max_small.restype = i
        if lib.cffm_embed_lookup_max_small() != MAX_SMALL_FIELDS:
            raise RuntimeError("embed_lookup library's prefix limit differs from "
                               f"MAX_SMALL_FIELDS = {MAX_SMALL_FIELDS}")
        fn.argtypes = [p, i, ll, i, p, i, ll, ll, ll, i, i, ctypes.POINTER(ctypes.c_int),
                       p, p, i, p]
        fn.restype = i
    return lib


def _launch(table, ids, bounds, emb_small, emb_big):
    (v, w), (b, f) = table.shape, ids.shape
    lib = _library()
    dev = table.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.cffm_embed_lookup_fm(
            table.data_ptr(), int(table.dtype == torch.bfloat16), v, w, ids.data_ptr(),
            int(ids.dtype == torch.int64), ids.stride(0), ids.stride(1), b, f,
            max(len(bounds) - 1, 0), _bounds_array(tuple(bounds)), emb_small.data_ptr(),
            emb_big.data_ptr(), int(emb_small.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"embed_lookup kernel launch failed: CUDA error {err}")

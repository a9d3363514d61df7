"""Sorted-segment dedup: sorted (ids, grads) -> compact (uids, sums).

The port's counterpart of `cffm_tpu/ops/sorted_segment.py`: kernel 3
(`sorted_segment_sum_compact`, the single-device dedup) and kernel 6
(`sorted_segment_sum_by_seg`, the dedup of the sharded gradient return,
which starts from the routing's segment index and returns no ids). A
third entry, `scatter_segment_sum`, takes the scatter route's sums of
`optim/rowwise.py`: it reads the unsorted grads through the sort's order
and keeps f32 sums of the live segments only. All three are entries of
`csrc/sorted_segment.cu`, a tree of chunked passes whose depth follows
n, not the segment lengths; its design note says how.
Segment starts come from the id-change flags and `torch.cumsum`, outside
the kernel, as the JAX package computes them. `scratch_rows` sizes the
tree's f32 scratch, as the kernel's own rule does.

A wrapper launches the CUDA kernel for a CUDA tensor and takes the plain
PyTorch version (`sorted_segment_sum_reference`,
`sorted_segment_by_seg_reference`, `scatter_segment_sum_reference`) for
a CPU tensor. Its `launches` attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from cffm_tpu_torch.ops import _build

_SOURCE = "sorted_segment"
# entries per chunk of the kernel's tree: level 0, and every level above
CHUNK0, CHUNK_N = 128, 32


def scratch_rows(n: int) -> int:
    """Rows of (W,) f32 scratch the kernel takes for n entries: a head and
    a tail row per chunk of every level of its tree with more than one
    chunk (the level with one chunk ends it)."""
    rows, count, length = 0, n, CHUNK0
    while count > 0:
        chunks = -(-count // length)
        if chunks == 1:
            break
        rows += 2 * chunks
        count, length = chunks, CHUNK_N
    return rows


def segments(sid: torch.Tensor):
    """(seg (n,) int32, count 0-d int32): seg[e] is the index of e's
    segment, a cumsum of the id-change flags."""
    change = torch.ones(sid.shape, dtype=torch.int32, device=sid.device)
    change[1:] = (sid[1:] != sid[:-1]).to(torch.int32)
    seg = torch.cumsum(change, 0, dtype=torch.int32) - 1
    count = (seg[-1] + 1) if seg.numel() else torch.zeros((), dtype=torch.int32,
                                                          device=sid.device)
    return seg, count


def sorted_segment_sum_reference(sid: torch.Tensor, seg: torch.Tensor,
                                 grads: torch.Tensor, m_pad: int):
    """Plain version: (uids (m_pad,) int32, gsum (m_pad, W) bf16), the sums
    taken in f32 from bf16 grads; empty slots hold -1 and zero rows."""
    keep = seg < m_pad
    s = seg[keep].long()
    gsum = torch.zeros((m_pad, grads.shape[1]), dtype=torch.float32, device=grads.device)
    gsum.index_add_(0, s, grads[keep].float())
    uids = torch.full((m_pad,), -1, dtype=torch.int32, device=sid.device)
    # every entry of a segment carries the segment's id
    uids.scatter_(0, s, sid[keep].to(torch.int32))
    return uids, gsum.to(torch.bfloat16)


def sorted_segment_by_seg_reference(seg: torch.Tensor, grads: torch.Tensor,
                                    m_pad: int) -> torch.Tensor:
    """Plain version of kernel 6: gsum (m_pad, W) bf16, segment k's f32
    total at slot k, zero rows past the segment count."""
    keep = seg < m_pad
    gsum = torch.zeros((m_pad, grads.shape[1]), dtype=torch.float32, device=grads.device)
    gsum.index_add_(0, seg[keep].long(), grads[keep].float())
    return gsum.to(torch.bfloat16)


def scatter_segment_sum_reference(order: torch.Tensor, seg: torch.Tensor,
                                  grads: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """Plain version of the scatter route's sums: (n, W) f32, live segment
    s's sum at row s - lo, taken by `index_add_` in entry order (the rows
    [lo, lo + n) of the scatter route's sums into one slot per entry, bit
    for bit)."""
    keep = (seg >= lo) & (seg < lo + n)
    out = torch.zeros((n, grads.shape[1]), dtype=torch.float32, device=grads.device)
    out.index_add_(0, seg[keep] - lo, grads.index_select(0, order[keep]).float())
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.cffm_sorted_segment_sum
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cffm_sorted_segment_chunk.argtypes = [i]
        lib.cffm_sorted_segment_chunk.restype = i
        chunks = (lib.cffm_sorted_segment_chunk(0), lib.cffm_sorted_segment_chunk(1))
        if chunks != (CHUNK0, CHUNK_N):
            raise RuntimeError(f"sorted_segment library chunks {chunks} differ from "
                               f"{(CHUNK0, CHUNK_N)}: scratch_rows would size it wrong")
        lib.cffm_sorted_segment_sum_by_seg.argtypes = [p, p, ll, i, p, ll, p, ll, p]
        lib.cffm_sorted_segment_sum_by_seg.restype = i
        lib.cffm_scatter_segment_sum.argtypes = [p, p, p, ll, i, ll, ll, p, p, ll, p]
        lib.cffm_scatter_segment_sum.restype = i
        fn.argtypes = [p, p, p, ll, i, p, p, ll, p, ll, p]
        fn.restype = i
    return lib


def _launch(sid, seg, grads, m_pad: int):
    """Kernel 3 when sid is given, else kernel 6: (uids | None, gsum)."""
    n, w = grads.shape
    dev = grads.device
    if grads.data_ptr() % 16:  # the kernel reads rows in 16-byte words
        grads = grads.clone()
    lib = _library()
    gsum = torch.empty((m_pad, w), dtype=torch.bfloat16, device=dev)
    rows = scratch_rows(n)
    scratch = torch.empty((rows, w), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    uids = None
    with torch.cuda.device(dev):
        if sid is None:
            err = lib.cffm_sorted_segment_sum_by_seg(
                seg.data_ptr(), grads.data_ptr(), n, w, gsum.data_ptr(), m_pad,
                scratch.data_ptr(), rows, stream)
        else:
            uids = torch.empty((m_pad,), dtype=torch.int32, device=dev)
            err = lib.cffm_sorted_segment_sum(
                sid.data_ptr(), seg.data_ptr(), grads.data_ptr(), n, w,
                uids.data_ptr(), gsum.data_ptr(), m_pad, scratch.data_ptr(), rows, stream)
    if err != 0:
        raise RuntimeError(f"sorted_segment kernel launch failed: CUDA error {err}")
    return uids, gsum


def sorted_segment_sum_compact(sid: torch.Tensor, grads: torch.Tensor, m_pad: int):
    """sid (n,) int32 sorted ascending; grads (n, W) in the same order, W
    a multiple of 128, rounded to bf16 first. m_pad: output slots, which
    must bound the segment count. Returns (uids (m_pad,) int32 with -1 in
    empty slots, gsum (m_pad, W) bf16 summed in f32 with zero rows in
    empty slots, count 0-d int32)."""
    n, w = grads.shape
    if w % 128 != 0:
        raise ValueError(f"sorted_segment_sum_compact needs W % 128 == 0, got {w}")
    if sid.shape != (n,) or sid.dtype != torch.int32:
        raise ValueError("sid must be (n,) int32")
    if sid.device != grads.device:
        raise ValueError("sid and grads must share a device")
    g = grads.to(torch.bfloat16).contiguous()
    sid = sid.contiguous()
    seg, count = segments(sid)
    if g.device.type == "cpu":
        uids, gsum = sorted_segment_sum_reference(sid, seg, g, m_pad)
        return uids, gsum, count
    if g.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum_compact takes CPU or CUDA tensors, got {g.device}")
    uids, gsum = _launch(sid, seg, g, m_pad)
    sorted_segment_sum_compact.launches += 1
    return uids, gsum, count


def sorted_segment_sum_by_seg(seg: torch.Tensor, sorted_grads: torch.Tensor,
                              m_pad: int) -> torch.Tensor:
    """Kernel 6. seg (n,) int32, non-decreasing from 0 in steps of at most
    1 (the routing's segment index); sorted_grads (n, W) bf16, W a multiple
    of 128; m_pad output slots. Returns gsum (m_pad, W) bf16: segment k's
    total, summed in f32 and rounded once, at slot k; zero rows past the
    segment count."""
    n, w = sorted_grads.shape
    if w % 128 != 0:
        raise ValueError(f"sorted_segment_sum_by_seg needs W % 128 == 0, got {w}")
    if sorted_grads.dtype != torch.bfloat16:
        raise TypeError(f"sorted_segment_sum_by_seg takes bf16 grads, got {sorted_grads.dtype}")
    if seg.shape != (n,) or seg.dtype != torch.int32:
        raise ValueError("seg must be (n,) int32")
    if seg.device != sorted_grads.device:
        raise ValueError("seg and sorted_grads must share a device")
    g = sorted_grads.contiguous()
    seg = seg.contiguous()
    if g.device.type == "cpu":
        return sorted_segment_by_seg_reference(seg, g, m_pad)
    if g.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum_by_seg takes CPU or CUDA tensors, got {g.device}")
    _, gsum = _launch(None, seg, g, m_pad)
    sorted_segment_sum_by_seg.launches += 1
    return gsum


def scatter_segment_sum(order: torch.Tensor, seg: torch.Tensor, grads: torch.Tensor,
                        lo: int, n: int) -> torch.Tensor:
    """The scatter route's segment sums. grads (N, W) bf16 in the ids'
    order, W a multiple of 128; order (N,) the sort's permutation of them;
    seg (N,) each sorted entry's segment, non-decreasing from 0 in steps of
    at most 1; the live segments are the run [lo, lo + n). Returns (n, W)
    f32: live segment s's sum at row s - lo, summed in f32 and not
    rounded; the other segments are dropped. On a card the sums are taken
    in the tree's fixed order, with no atomics, so two calls give the same
    bits."""
    big, w = grads.shape
    if w % 128 != 0:
        raise ValueError(f"scatter_segment_sum needs W % 128 == 0, got {w}")
    if grads.dtype != torch.bfloat16:
        raise TypeError(f"scatter_segment_sum takes bf16 grads, got {grads.dtype}")
    if order.shape != (big,) or seg.shape != (big,):
        raise ValueError(f"order and seg must be ({big},)")
    if not (order.device == seg.device == grads.device):
        raise ValueError("order, seg and grads must share a device")
    lo, n = int(lo), int(n)
    if grads.device.type == "cpu":
        return scatter_segment_sum_reference(order, seg, grads, lo, n)
    if grads.device.type != "cuda":
        raise ValueError(f"scatter_segment_sum takes CPU or CUDA tensors, got {grads.device}")
    dev = grads.device
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    if n == 0 or big == 0:
        return out
    g = grads.contiguous()
    if g.data_ptr() % 16:  # the kernel reads rows in 16-byte words
        g = g.clone()
    order = order.to(torch.int64).contiguous()
    seg = seg.to(torch.int32).contiguous()
    lib = _library()
    rows = scratch_rows(big)
    scratch = torch.empty((rows, w), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.cffm_scatter_segment_sum(order.data_ptr(), seg.data_ptr(), g.data_ptr(), big,
                                           w, lo, n, out.data_ptr(), scratch.data_ptr(), rows,
                                           stream)
    if err != 0:
        raise RuntimeError(f"scatter_segment_sum kernel launch failed: CUDA error {err}")
    scatter_segment_sum.launches += 1
    return out


sorted_segment_sum_compact.launches = 0
sorted_segment_sum_by_seg.launches = 0
scatter_segment_sum.launches = 0

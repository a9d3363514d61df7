"""Sorted-segment dedup: sorted (ids, grads) -> compact (uids, sums).

The port's counterpart of `cffm_tpu/ops/sorted_segment.py`
(`sorted_segment_sum_compact`). The kernel is `csrc/sorted_segment.cu`,
a chunked segmented reduction; its design note says how it deals with
hot segments. Segment starts come from the id-change flags and
`torch.cumsum`, outside the kernel, as the JAX package computes them.

A wrapper launches the CUDA kernel for a CUDA tensor and takes the plain
PyTorch version (`sorted_segment_sum_reference`) for a CPU tensor. Its
`launches` attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from cffm_tpu_torch.ops import _build

_SOURCE = "sorted_segment"


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


def _library() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.cffm_sorted_segment_sum
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, i, p, p, ll, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.cffm_sorted_segment_chunk.argtypes = []
        lib.cffm_sorted_segment_chunk.restype = ctypes.c_int
    return lib


def _launch(sid, seg, grads, m_pad: int):
    n, w = grads.shape
    dev = grads.device
    lib = _library()
    chunks = -(-n // lib.cffm_sorted_segment_chunk())
    uids = torch.empty((m_pad,), dtype=torch.int32, device=dev)
    gsum = torch.empty((m_pad, w), dtype=torch.bfloat16, device=dev)
    head = torch.empty((chunks, w), dtype=torch.float32, device=dev)
    tail = torch.empty((chunks, w), dtype=torch.float32, device=dev)
    tail_seg = torch.empty((chunks,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.cffm_sorted_segment_sum(
            sid.data_ptr(), seg.data_ptr(), grads.data_ptr(), n, w,
            uids.data_ptr(), gsum.data_ptr(), m_pad, head.data_ptr(),
            tail.data_ptr(), tail_seg.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
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


sorted_segment_sum_compact.launches = 0

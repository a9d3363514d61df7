"""Pre-hashed binary dataset format (.cfb): parse and hash once, read
at memory speed after.

The port's copy of `cffm_tpu/data/prehashed.py`; files written by either
package are byte-equal, and either reads the other's. The layout:

    header (32 B): magic b"CFB1" | u32 version | u32 num_fields F
                   | u32 num_dense D | u64 num_rows N | 8 B reserved
    body: N records of (F + D + 1) little-endian 4-byte words:
          F int32 local per-field ids, D float32 dense, 1 float32 label

A uniform 4-byte word stride means the whole body memmaps as ONE int32
(N, F+D+1) array; a batch is a contiguous row-slice copy, and the parse
cost is paid once at conversion. Dense and label words reinterpret via a
same-itemsize ``.view(np.float32)``.

Reader semantics mirror the streaming readers (readers.py): blocks of
``batch_size`` rows take the role of chunks. Every ``val_every``-th block
is held out for eval, the rest round-robin across shards by a population
counter (readers._chunk_selector, so split and shard behave identically
by construction). ``shuffle=True`` adds a per-epoch permutation of this
shard's block order keyed by (seed, epoch) and an in-block row
permutation keyed by (seed, epoch, file, block), so resume's
skip_batches fast-forward stays exact.

Convert with:  python -m cffm_tpu_torch.data.prehash IN OUT --config=...
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

from cffm_tpu_torch.config import ModelConfig
from cffm_tpu_torch.data.readers import _chunk_selector, resolve_paths

MAGIC = b"CFB1"
VERSION = 1
HEADER_BYTES = 32
_HEADER = struct.Struct("<4sIIIQ8x")  # magic, version, F, D, N, pad: 32 bytes



def write_header(f, num_fields: int, num_dense: int, num_rows: int) -> None:
    f.write(_HEADER.pack(MAGIC, VERSION, num_fields, num_dense, num_rows))


def read_header(path: str) -> Tuple[int, int, int]:
    """-> (num_fields, num_dense, num_rows). Raises on bad magic."""
    with open(path, "rb") as f:
        magic, version, nf, nd, n = _HEADER.unpack(f.read(HEADER_BYTES))
    if magic != MAGIC:
        raise ValueError(f"{path}: not a CFB file (magic {magic!r})")
    if version != VERSION:
        raise ValueError(f"{path}: CFB version {version} unsupported")
    return nf, nd, n


def is_prehashed(path: str) -> bool:
    """True iff path resolves to data file(s) starting with the CFB
    magic (multi-file datasets: the first resolved file decides)."""
    files = resolve_paths(path)
    if not files:
        return False
    try:
        with open(files[0], "rb") as f:
            return f.read(4) == MAGIC
    except OSError:
        return False


def write_prehashed(out_path: str, batches, num_fields: int,
                    num_dense: int) -> int:
    """Stream (ids, dense|None, label) numpy batches to a .cfb file.

    Patches the row count into the header at close. Returns rows
    written. ids must be LOCAL per-field (what readers.py yields —
    loader.py applies the global field offsets at read time).
    """
    n = 0
    with open(out_path, "wb") as f:
        write_header(f, num_fields, num_dense, 0)
        for ids, dense, label in batches:
            b = len(ids)
            rec = np.empty((b, num_fields + num_dense + 1), dtype=np.int32)
            rec[:, :num_fields] = ids
            fwords = rec[:, num_fields:].view(np.float32)
            if num_dense:
                fwords[:, :num_dense] = dense
            fwords[:, num_dense] = label
            f.write(rec.tobytes())
            n += b
        f.seek(0)
        write_header(f, num_fields, num_dense, n)
    return n


def _open_memmap(path: str):
    nf, nd, n = read_header(path)
    width = nf + nd + 1
    mm = np.memmap(path, dtype="<i4", mode="r", offset=HEADER_BYTES,
                   shape=(n, width))
    return nf, nd, n, mm


def prehashed_batches(
    path: str, cfg: ModelConfig, batch_size: int,
    shard_index: int = 0, num_shards: int = 1, repeat: bool = True,
    split: str = "train", val_every: int = 0,
    shuffle: bool = False, seed: int = 0,
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
    """Yield (ids, dense|None, label) batches from .cfb file(s).

    Same contract as readers.criteo_batches: local per-field ids, dense
    may be None (when the file has 0 dense words or cfg.num_dense == 0).
    path may be a file, directory, or glob (readers.resolve_paths) —
    block indices run continuously across files so the host sharding
    and val split spread over the whole dataset. In repeat mode every
    batch is exactly batch_size rows (each file's partial tail block is
    dropped — training needs static shapes); with repeat=False each
    file's tail yields as one final PARTIAL batch so a full-pass eval
    covers every held-out row.
    """
    files = resolve_paths(path)
    if not files:
        raise FileNotFoundError(f"no data files match {path!r}")
    maps = []  # (nf, nd, n, mm) per file
    for fp in files:
        nf, nd, n, mm = _open_memmap(fp)
        if nf != cfg.num_fields:
            raise ValueError(
                f"{fp}: file has {nf} fields, config wants {cfg.num_fields}")
        maps.append((nf, nd, n, mm))
    want_dense = cfg.num_dense > 0 and maps[0][1] > 0

    def decode(rec, nf, nd, perm=None):
        # One-pass contiguous extraction straight from the memmap slice:
        # the shuffle permutation rides inside the ids and float gathers
        # (advanced row index + basic column slice -> one contiguous copy
        # each). Downstream consumers (wire.pack's per-field indexing, the
        # pinned-buffer copy for the card) walk these arrays again, so they
        # must come out contiguous, not strided by the whole record.
        if perm is not None:
            ids = rec[perm, :nf]
            fwords = rec[perm, nf:].view(np.float32)
        else:
            ids = np.array(rec[:, :nf])
            fwords = np.array(rec[:, nf:]).view(np.float32)
        dense = np.ascontiguousarray(fwords[:, :nd]) if want_dense else None
        label = np.ascontiguousarray(fwords[:, nd])
        return ids, dense, label

    epoch = 0
    while True:
        take = _chunk_selector(split, val_every, shard_index, num_shards)
        # global block ids: (file_idx, local block, row count)
        mine = []
        gblk = 0
        for fi, (nf, nd, n, mm) in enumerate(maps):
            full = n // batch_size
            for b in range(full):
                if take(gblk):
                    mine.append((fi, b, batch_size))
                gblk += 1
            tail = n - full * batch_size
            if tail and not repeat:
                if take(gblk):
                    mine.append((fi, full, tail))
                gblk += 1
            elif tail:
                gblk += 1  # tail keeps its block id even when dropped
        if repeat and not mine:
            raise ValueError(f"{path!r} holds no block of the {split} split for shard "
                             f"{shard_index} of {num_shards}: a repeating stream would "
                             "never yield")
        if shuffle:
            # (seed, epoch)-keyed so resume-by-skip replays the same order
            order = np.random.default_rng((seed, epoch)).permutation(len(mine))
            mine = [mine[int(i)] for i in order]
        for fi, blk, rows in mine:
            nf, nd, n, mm = maps[fi]
            rec = mm[blk * batch_size:blk * batch_size + rows]
            perm = (np.random.default_rng(
                        (seed, epoch, fi, blk)).permutation(rows)
                    if shuffle else None)
            yield decode(rec, nf, nd, perm)
        epoch += 1
        if not repeat:
            return

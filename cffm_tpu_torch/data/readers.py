"""Streaming readers: Criteo TSV, Avazu CSV, MovieLens-1M.

The port's copy of `cffm_tpu/data/readers.py`, batch for batch the same.
Each reader yields numpy batches (ids (B, F) local per field, dense |
None, label) matching the schema in `cffm_tpu_torch/config.py`. Files
are read in chunks and hashed with the vectorized hasher
(`data/hashing.py`) or the native parser (`data/native.py`), with no
per-row Python loop in the native hot path. Per-process sharding: shard
i reads every num_shards-th chunk of its split.

Criteo TSV: label \t 13 ints \t 26 hex-cat. Avazu CSV: id,click,hour,
C1,banner_pos,site_id,...,C21 (24 cols). MovieLens-1M: ratings.dat ::
separated, joined with users.dat/movies.dat.
"""

from __future__ import annotations

import functools
import itertools
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from cffm_tpu_torch.config import ModelConfig
from cffm_tpu_torch.data import native
from cffm_tpu_torch.data.hashing import bucketize_log2, hash_strings
from cffm_tpu_torch.data.parallel_reader import ordered_parallel_map

# Sakamoto's day-of-week table (0 = Sunday); used for Avazu's YYMMDD
# timestamps. Bit-matched by the C++ parser (native/cffm_native.cpp).
_SAKAMOTO = np.array([0, 3, 2, 5, 0, 3, 5, 1, 4, 6, 2, 4], dtype=np.int64)


def _want_fields(cfg: ModelConfig, n: int) -> None:
    if cfg.num_fields != n:
        raise ValueError(f"this reader yields {n} fields; the config has {cfg.num_fields}")


def day_of_week_yymmdd(yymmdd: np.ndarray) -> np.ndarray:
    """Real day-of-week (0=Sunday) from YYMMDD ints (years 2000-2099)."""
    yymmdd = np.asarray(yymmdd, dtype=np.int64)
    y = 2000 + yymmdd // 10000
    m = (yymmdd // 100) % 100
    d = yymmdd % 100
    m = np.clip(m, 1, 12)
    y = y - (m < 3)
    return ((y + y // 4 - y // 100 + y // 400 + _SAKAMOTO[m - 1] + d) % 7).astype(
        np.int32)


def resolve_paths(path: str) -> list[str]:
    """Expand a dataset path into an ordered list of data files.

    Accepts a single file, a directory (all non-hidden files inside,
    sorted — full Criteo ships as day_0..day_23), or a glob pattern
    ("day_*.gz"). Returns [] when nothing matches."""
    import glob as _glob

    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if not f.startswith(".")
            and os.path.isfile(os.path.join(path, f)))
    if any(c in path for c in "*?["):
        return sorted(p for p in _glob.glob(path) if os.path.isfile(p))
    return [path] if os.path.isfile(path) else []


def _open_data(path: str):
    """Binary handle; .gz transparently decompressed (Criteo/Avazu are
    distributed gzipped; zcat-ing terabytes to disk first shouldn't be
    a prerequisite for training)."""
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, "rb")
    return open(path, "rb")


def _chunk_selector(split: str, val_every: int, shard_index: int,
                    num_shards: int):
    """Chunk-level held-out split + host round-robin (eval must run on
    examples never trained on).

    Every `val_every`-th chunk belongs to the "val" split; the rest are
    "train". Within its split, each chunk is assigned to hosts
    round-robin by a population counter (NOT the global chunk index, so
    host coverage stays balanced after the split removes chunks).
    val_every=0 disables the split: BOTH streams see every chunk (the
    documented smoke-test behavior — eval reuses the train stream;
    previously the val stream came back empty)."""
    if split not in ("train", "val"):
        raise ValueError(f"split must be 'train' or 'val', got {split!r}")
    pop = 0

    def take(chunk_idx: int) -> bool:
        nonlocal pop
        if val_every > 0:
            is_val = chunk_idx % val_every == val_every - 1
            if (split == "val") != is_val:
                return False
        mine = pop % num_shards == shard_index
        pop += 1
        return mine

    return take


def _check_epoch(taken: int, path: str, split: str, shard_index: int, num_shards: int):
    """A repeating stream whose pass took no chunk would spin forever
    without yielding: refuse it (the JAX readers hang there)."""
    if not taken:
        raise ValueError(f"{path!r} holds no chunk of the {split} split for shard "
                         f"{shard_index} of {num_shards}: a repeating stream would never yield")


def _chunked_lines(path: str, chunk: int, shard_index: int = 0, num_shards: int = 1,
                   skip_header: bool = False, repeat: bool = True,
                   split: str = "train", val_every: int = 0):
    """Yield lists of `chunk` lines; shard by chunk round-robin across hosts,
    with an optional chunk-level train/val split (see _chunk_selector).
    path may be a file, directory, or glob (resolve_paths); chunk
    indices run continuously across files so the host sharding and the
    val split both spread over the whole multi-file dataset."""
    files = resolve_paths(path)
    if not files:
        raise FileNotFoundError(f"no data files match {path!r}")
    while True:
        take = _chunk_selector(split, val_every, shard_index, num_shards)
        chunk_idx = taken = 0
        for fp in files:
            with _open_data(fp) as f:
                it = iter(f)
                if skip_header:
                    next(it, None)
                while True:
                    lines = list(itertools.islice(it, chunk))
                    if not lines:
                        break
                    if take(chunk_idx):
                        taken += 1
                        yield lines
                    chunk_idx += 1
        if not repeat:
            return
        _check_epoch(taken, path, split, shard_index, num_shards)


def _rebatch(chunks, batch_size: int):
    """Re-accumulate variable-size (ids, dense, label) chunks into exact
    batch_size batches (the static-shape sharded train step requires it;
    the native readers do the same). When the source exhausts (non-repeat
    mode only — repeat streams never do), the leftover tail rows flush as
    one final partial batch, matching the single-thread native readers —
    converters/eval passes must see every row; training uses repeat=True
    and only ever sees exact batches."""
    pending = []
    count = 0
    for ids, dense, label in chunks:
        if len(ids) == 0:
            continue
        pending.append((ids, dense, label))
        count += len(ids)
        while count >= batch_size:
            all_ids = np.concatenate([p[0] for p in pending])
            all_dense = (np.concatenate([p[1] for p in pending])
                         if pending[0][1] is not None else None)
            all_lab = np.concatenate([p[2] for p in pending])
            yield (all_ids[:batch_size],
                   None if all_dense is None else all_dense[:batch_size],
                   all_lab[:batch_size])
            rem = all_ids[batch_size:]
            if len(rem):
                pending = [(rem,
                            None if all_dense is None else all_dense[batch_size:],
                            all_lab[batch_size:])]
            else:
                pending = []
            count = len(rem)
    if pending:  # final partial batch (source exhausted: non-repeat mode)
        yield (np.concatenate([p[0] for p in pending]),
               (np.concatenate([p[1] for p in pending])
                if pending[0][1] is not None else None),
               np.concatenate([p[2] for p in pending]))


def criteo_batches(
    path: str, cfg: ModelConfig, batch_size: int,
    shard_index: int = 0, num_shards: int = 1, repeat: bool = True,
    split: str = "train", val_every: int = 0,
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
    """Criteo TSV -> (ids, dense, label). 39 fields: 13 bucketized ints
    + 26 hashed categoricals; ints also pass through as log1p dense."""
    _want_fields(cfg, 39)

    def chunks():
        for lines in _chunked_lines(path, batch_size, shard_index, num_shards,
                                    repeat=repeat, split=split,
                                    val_every=val_every):
            # filter malformed rows (wrong field count) before np.array —
            # ragged rows would otherwise raise, and undersized arrays
            # would break the static-shape train step
            parts = [p for p in (ln.rstrip(b"\n").split(b"\t") for ln in lines)
                     if len(p) == 40]
            if not parts:
                continue
            rows = np.array(parts, dtype=object)
            n = len(rows)
            label = rows[:, 0].astype(np.float32)
            ints_raw = rows[:, 1:14]
            ints = np.where(ints_raw == b"", b"-1", ints_raw).astype(np.int64)
            ids = np.empty((n, 39), dtype=np.int32)
            for i in range(13):
                ids[:, i] = bucketize_log2(ints[:, i], cfg.vocab_sizes[i])
            for i in range(26):
                col = rows[:, 14 + i].astype("S16")
                ids[:, 13 + i] = hash_strings(col, cfg.vocab_sizes[13 + i])
            dense = (np.log1p(np.maximum(ints, 0)).astype(np.float32)
                     if cfg.num_dense else None)
            yield ids, dense, label

    return _rebatch(chunks(), batch_size)


def avazu_batches(
    path: str, cfg: ModelConfig, batch_size: int,
    shard_index: int = 0, num_shards: int = 1, repeat: bool = True,
    split: str = "train", val_every: int = 0,
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
    """Avazu CSV -> 23 fields: hour-of-day, day-of-week + 21 hashed cats."""
    _want_fields(cfg, 23)

    def chunks():
        for lines in _chunked_lines(path, batch_size, shard_index, num_shards,
                                    skip_header=True, repeat=repeat,
                                    split=split, val_every=val_every):
            parts = [p for p in (ln.rstrip(b"\n").split(b",") for ln in lines)
                     if len(p) == 24]
            if not parts:
                continue
            rows = np.array(parts, dtype=object)
            n = len(rows)
            label = rows[:, 1].astype(np.float32)
            hour_str = rows[:, 2].astype("S8")  # YYMMDDHH
            hh = np.array([int(h[-2:]) for h in hour_str], dtype=np.int32)
            yymmdd = np.array([int(h[:6]) for h in hour_str], dtype=np.int64)
            dow = day_of_week_yymmdd(yymmdd)
            ids = np.empty((n, 23), dtype=np.int32)
            ids[:, 0] = np.minimum(hh, cfg.vocab_sizes[0] - 1)
            ids[:, 1] = np.minimum(dow, cfg.vocab_sizes[1] - 1)
            for i in range(21):
                col = rows[:, 3 + i].astype("S24")
                ids[:, 2 + i] = hash_strings(col, cfg.vocab_sizes[2 + i])
            yield ids, None, label

    return _rebatch(chunks(), batch_size)


def movielens_batches(
    path: str, cfg: ModelConfig, batch_size: int, seed: int = 0, repeat: bool = True,
    split: str = "train", val_every: int = 0,
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
    """MovieLens-1M directory (ratings.dat/users.dat/movies.dat) ->
    7 fields (user, movie, gender, age, occupation, zip, first-genre);
    label = rating >= 4 (standard CTR-ification). The held-out split
    leaves out every `val_every`-th rating (by file order, so train and
    val are disjoint and deterministic across hosts/seeds)."""
    _want_fields(cfg, 7)
    users = {}
    with open(os.path.join(path, "users.dat"), "rb") as f:
        for ln in f:
            uid, gender, age, occ, zipc = ln.rstrip(b"\n").split(b"::")
            users[int(uid)] = (gender, int(age), int(occ), zipc)
    movies = {}
    genre_vocab = {}
    with open(os.path.join(path, "movies.dat"), "rb") as f:
        for ln in f:
            mid, _title, genres = ln.rstrip(b"\n").split(b"::")
            g = genres.split(b"|")[0]
            gid = genre_vocab.setdefault(g, len(genre_vocab))
            movies[int(mid)] = gid
    ages = sorted({v[1] for v in users.values()})
    age_idx = {a: i for i, a in enumerate(ages)}

    ratings = []
    with open(os.path.join(path, "ratings.dat"), "rb") as f:
        for ln in f:
            uid, mid, r, _ts = ln.rstrip(b"\n").split(b"::")
            ratings.append((int(uid), int(mid), int(r)))
    ratings = np.asarray(ratings, dtype=np.int64)
    if val_every > 0:
        is_val = (np.arange(len(ratings)) % val_every) == val_every - 1
        ratings = ratings[is_val if split == "val" else ~is_val]
    rng = np.random.default_rng(seed)
    if repeat and len(ratings) < batch_size:
        raise ValueError(f"{path!r}: the {split} split holds {len(ratings)} ratings, fewer "
                         f"than one batch of {batch_size}: a repeating stream would never yield")

    while True:
        perm = rng.permutation(len(ratings))
        for start in range(0, len(perm) - batch_size + 1, batch_size):
            sel = ratings[perm[start : start + batch_size]]
            n = len(sel)
            ids = np.zeros((n, 7), dtype=np.int32)
            for k, (uid, mid, _r) in enumerate(sel):
                gender, age, occ, zipc = users[int(uid)]
                ids[k, 0] = int(uid) % cfg.vocab_sizes[0]
                ids[k, 1] = int(mid) % cfg.vocab_sizes[1]
                ids[k, 2] = 0 if gender == b"M" else 1
                ids[k, 3] = age_idx[age]
                ids[k, 4] = occ % cfg.vocab_sizes[4]
                ids[k, 6] = movies.get(int(mid), 0) % cfg.vocab_sizes[6]
            zips = np.array([users[int(u)][3] for u, _m, _r in sel], dtype="S8")
            ids[:, 5] = hash_strings(zips, cfg.vocab_sizes[5])
            label = (sel[:, 2] >= 4).astype(np.float32)
            yield ids, None, label
        if not repeat:
            return


# ---------------------------------------------------------------------------
# Native-parser-backed readers (C++ fast path; see data/native.py)
# ---------------------------------------------------------------------------


def _chunked_bytes(path: str, chunk_bytes: int, shard_index: int = 0,
                   num_shards: int = 1, skip_header: bool = False,
                   repeat: bool = True, split: str = "train",
                   val_every: int = 0):
    """Yield raw byte chunks ending on row boundaries, sharded by chunk,
    with the same chunk-level train/val split as _chunked_lines.
    Multi-file paths (dir/glob) chunk continuously across files; row
    boundaries never span files (each file's tail flushes before the
    next file opens)."""
    files = resolve_paths(path)
    if not files:
        raise FileNotFoundError(f"no data files match {path!r}")
    while True:
        take = _chunk_selector(split, val_every, shard_index, num_shards)
        chunk_idx = taken = 0
        for fp in files:
            with _open_data(fp) as f:
                if skip_header:
                    f.readline()
                tail = b""
                while True:
                    data = f.read(chunk_bytes)
                    if not data:
                        break
                    buf = tail + data
                    cut = buf.rfind(b"\n") + 1
                    tail = buf[cut:]
                    if take(chunk_idx):
                        taken += 1
                        yield buf[:cut]
                    chunk_idx += 1
                if tail.strip():
                    # file ends without a trailing newline: flush the
                    # last row as its own chunk (normalized so parsers
                    # always see newline-terminated rows)
                    if take(chunk_idx):
                        taken += 1
                        yield tail + b"\n"
                    chunk_idx += 1
        if not repeat:
            return
        _check_epoch(taken, path, split, shard_index, num_shards)


def criteo_batches_native(
    path: str, cfg: ModelConfig, batch_size: int,
    shard_index: int = 0, num_shards: int = 1, repeat: bool = True,
    split: str = "train", val_every: int = 0,
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
    """Criteo TSV via the C++ parser."""
    _want_fields(cfg, 39)
    # criteo rows are ~150 bytes; over-read so each chunk fills a batch
    chunk_bytes = max(batch_size * 220, 1 << 16)
    want_dense = cfg.num_dense > 0
    pending = []
    count = 0
    for buf in _chunked_bytes(path, chunk_bytes, shard_index, num_shards,
                              repeat=repeat, split=split,
                              val_every=val_every):
        off = 0
        while off < len(buf):
            ids, dense, labels, consumed = native.parse_criteo_buffer(
                buf[off:], batch_size - count if pending else batch_size,
                cfg.vocab_sizes, want_dense)
            if consumed == 0:
                break
            off += consumed
            if len(ids) == 0:
                continue
            if not pending and len(ids) == batch_size:
                yield ids, dense, labels
                continue
            pending.append((ids, dense, labels))
            count += len(ids)
            if count >= batch_size:
                all_ids = np.concatenate([p[0] for p in pending])
                all_dense = (np.concatenate([p[1] for p in pending])
                             if want_dense else None)
                all_lab = np.concatenate([p[2] for p in pending])
                yield (all_ids[:batch_size],
                       None if all_dense is None else all_dense[:batch_size],
                       all_lab[:batch_size])
                rem = all_ids[batch_size:]
                if len(rem):
                    pending = [(rem,
                                None if all_dense is None else all_dense[batch_size:],
                                all_lab[batch_size:])]
                    count = len(rem)
                else:
                    pending, count = [], 0
    if pending:  # final partial batch (non-repeat mode)
        yield (np.concatenate([p[0] for p in pending]),
               np.concatenate([p[1] for p in pending]) if want_dense else None,
               np.concatenate([p[2] for p in pending]))


def _parse_criteo_chunk(buf: bytes, cfg: ModelConfig):
    """Parse one whole byte chunk via the C++ parser (GIL released)."""
    # a bound on the rows, not a count of the newlines: the count holds the
    # GIL for a pass over the chunk and kept the threads from scaling; a
    # Criteo row is 39 tabs and a newline at least
    cap = len(buf) // 40 + 1
    want_dense = cfg.num_dense > 0
    parts = []
    off = 0
    while off < len(buf):
        ids, dense, labels, consumed = native.parse_criteo_buffer(
            buf[off:], cap, cfg.vocab_sizes, want_dense)
        if consumed == 0:
            break
        off += consumed
        if len(ids):
            parts.append((ids, dense, labels))
    if len(parts) == 1:
        return parts[0]
    if not parts:
        return (np.empty((0, 39), np.int32),
                np.empty((0, 13), np.float32) if want_dense else None,
                np.empty((0,), np.float32))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]) if want_dense else None,
            np.concatenate([p[2] for p in parts]))


def _parse_avazu_chunk(buf: bytes, cfg: ModelConfig):
    cap = len(buf) // 24 + 1  # an Avazu row is 23 commas and a newline at least
    parts = []
    off = 0
    while off < len(buf):
        ids, labels, consumed = native.parse_avazu_buffer(
            buf[off:], cap, cfg.vocab_sizes)
        if consumed == 0:
            break
        off += consumed
        if len(ids):
            parts.append((ids, None, labels))
    if len(parts) == 1:
        return parts[0]
    if not parts:
        return (np.empty((0, 23), np.int32), None, np.empty((0,), np.float32))
    return (np.concatenate([p[0] for p in parts]), None,
            np.concatenate([p[2] for p in parts]))


def criteo_batches_native_mt(
    path: str, cfg: ModelConfig, batch_size: int,
    shard_index: int = 0, num_shards: int = 1, repeat: bool = True,
    split: str = "train", val_every: int = 0, num_threads: int = 4,
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
    """Criteo via the C++ parser on a thread pool (ctypes releases the
    GIL, so parsing scales ~linearly; ordered reassembly keeps the
    stream deterministic). NOTE: the train/val split is defined at this
    reader's chunk granularity — consistent within a run, not across
    reader paths with different chunk sizes."""
    _want_fields(cfg, 39)
    chunk_bytes = max(batch_size * 220, 1 << 20)
    chunks = _chunked_bytes(path, chunk_bytes, shard_index, num_shards,
                            repeat=repeat, split=split, val_every=val_every)
    parsed = ordered_parallel_map(
        chunks, functools.partial(_parse_criteo_chunk, cfg=cfg), num_threads)
    return _rebatch(parsed, batch_size)


def avazu_batches_native_mt(
    path: str, cfg: ModelConfig, batch_size: int,
    shard_index: int = 0, num_shards: int = 1, repeat: bool = True,
    split: str = "train", val_every: int = 0, num_threads: int = 4,
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
    _want_fields(cfg, 23)
    chunk_bytes = max(batch_size * 180, 1 << 20)
    chunks = _chunked_bytes(path, chunk_bytes, shard_index, num_shards,
                            skip_header=True, repeat=repeat, split=split,
                            val_every=val_every)
    parsed = ordered_parallel_map(
        chunks, functools.partial(_parse_avazu_chunk, cfg=cfg), num_threads)
    return _rebatch(parsed, batch_size)


def avazu_batches_native(
    path: str, cfg: ModelConfig, batch_size: int,
    shard_index: int = 0, num_shards: int = 1, repeat: bool = True,
    split: str = "train", val_every: int = 0,
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]]:
    _want_fields(cfg, 23)
    chunk_bytes = max(batch_size * 180, 1 << 16)
    pending = []
    count = 0
    for buf in _chunked_bytes(path, chunk_bytes, shard_index, num_shards,
                              skip_header=True, repeat=repeat, split=split,
                              val_every=val_every):
        off = 0
        while off < len(buf):
            ids, labels, consumed = native.parse_avazu_buffer(
                buf[off:], batch_size - count if pending else batch_size,
                cfg.vocab_sizes)
            if consumed == 0:
                break
            off += consumed
            if len(ids) == 0:
                continue
            if not pending and len(ids) == batch_size:
                yield ids, None, labels
                continue
            pending.append((ids, labels))
            count += len(ids)
            if count >= batch_size:
                all_ids = np.concatenate([p[0] for p in pending])
                all_lab = np.concatenate([p[1] for p in pending])
                yield all_ids[:batch_size], None, all_lab[:batch_size]
                rem = all_ids[batch_size:]
                if len(rem):
                    pending = [(rem, all_lab[batch_size:])]
                    count = len(rem)
                else:
                    pending, count = [], 0
    if pending:  # final partial batch (non-repeat mode)
        yield (np.concatenate([p[0] for p in pending]), None,
               np.concatenate([p[1] for p in pending]))


# ---------------------------------------------------------------------------
# Route choice (the JAX loader's, in one place for the loader and prehash)
# ---------------------------------------------------------------------------


def reader_route(reader_threads: int) -> str:
    """The route a Criteo or Avazu file stream takes, as the JAX loader
    picks it: "native_mt" when the native parser is available and
    reader_threads > 1, else "native", else "python". The route sets the
    chunk size, and with it which rows the val split holds."""
    if native.available():
        return "native_mt" if reader_threads > 1 else "native"
    return "python"


_READERS = {
    ("criteo", "native_mt"): criteo_batches_native_mt,
    ("criteo", "native"): criteo_batches_native,
    ("criteo", "python"): criteo_batches,
    ("avazu", "native_mt"): avazu_batches_native_mt,
    ("avazu", "native"): avazu_batches_native,
    ("avazu", "python"): avazu_batches,
}


def file_batches(dataset: str, path: str, cfg: ModelConfig, batch_size: int,
                 shard_index: int = 0, num_shards: int = 1, repeat: bool = True,
                 split: str = "train", val_every: int = 0, reader_threads: int = 4):
    """The Criteo or Avazu stream of path on reader_route(reader_threads)."""
    route = reader_route(reader_threads)
    kw = dict(repeat=repeat, split=split, val_every=val_every)
    if route == "native_mt":
        kw["num_threads"] = reader_threads
    try:
        reader = _READERS[(dataset, route)]
    except KeyError:
        raise ValueError(f"no file reader for dataset {dataset!r}") from None
    return reader(path, cfg, batch_size, shard_index, num_shards, **kw)

"""Vectorized feature hashing and integer bucketization.

The port's copy of `cffm_tpu/data/hashing.py`, bit-equal to it. Criteo
categorical values are 8-hex-digit strings and Avazu values short
alphanumeric strings; both hash into per-field bucket spaces with an
FNV-1a over fixed-width byte matrices (numpy, no per-string Python
loop). Criteo integer features take the log-squared bucketization.
The native parser (`native/cffm_native.cpp`) computes the same bits.
"""

from __future__ import annotations

import numpy as np

_FNV_PRIME = np.uint64(0x100000001B3)
_FNV_OFFSET = np.uint64(0xCBF29CE484222325)


def fnv1a_bytes_matrix(mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """FNV-1a over each row of a (N, W) uint8 matrix, honoring per-row length.

    Vectorized across rows; loops only over the (small) max width W.
    Returns uint64 hashes of shape (N,).
    """
    n, w = mat.shape
    h = np.full((n,), _FNV_OFFSET, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for col in range(w):
            active = col < lengths
            hx = (h ^ mat[:, col].astype(np.uint64)) * _FNV_PRIME
            h = np.where(active, hx, h)
    return h


def hash_strings(values: np.ndarray, num_buckets: int) -> np.ndarray:
    """Hash an array of byte-strings (dtype 'S*') into [0, num_buckets)."""
    if values.dtype.kind != "S":
        values = values.astype("S")
    w = values.dtype.itemsize
    mat = values.view(np.uint8).reshape(-1, w)
    lengths = (mat != 0).cumprod(axis=1).sum(axis=1)  # length to first NUL
    h = fnv1a_bytes_matrix(mat, lengths)
    return (h % np.uint64(num_buckets)).astype(np.int32)


def bucketize_log2(values: np.ndarray, num_buckets: int) -> np.ndarray:
    """Criteo-style integer bucketization: floor(log(x)^2) + 3 for x > 2,
    else x + 1. Missing values (a negative sentinel) map to bucket 0."""
    v = values.astype(np.float64)
    logv = np.log(np.maximum(v, 1.0))
    out = np.where(v > 2.0, np.floor(logv ** 2) + 3.0, np.maximum(v, -1.0) + 1.0)
    return np.clip(out.astype(np.int64), 0, num_buckets - 1).astype(np.int32)

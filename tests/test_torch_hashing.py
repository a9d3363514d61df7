"""The port's hashing is the JAX package's bit for bit: FNV-1a over byte
matrices, string hashing into bucket spaces, the log-squared integer
bucketization, and the native parser's hash."""

import numpy as np
import pytest

from cffm_tpu.data import hashing as jax_hashing
from cffm_tpu_torch.data import hashing, native


def _fnv1a_ref(s: bytes) -> int:
    h = 0xCBF29CE484222325
    for c in s:
        h = ((h ^ c) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _strings(width: int, n: int = 2000, seed: int = 0):
    """Hex and alphanumeric strings up to width bytes, empty ones included."""
    rng = np.random.default_rng(seed)
    vals = [format(int(x), "x")[: int(k)] for x, k in
            zip(rng.integers(0, 2**62, n), rng.integers(0, width + 1, n))]
    return np.array([v.encode() for v in vals], dtype=f"S{width}")


def test_fnv_matches_scalar_reference_and_jax():
    strs = [b"", b"a", b"hello", b"0a1b2c3d", b"ffffffff", b"x" * 15, b"\xff" * 16]
    vals = np.array(strs, dtype="S16")
    mat = vals.view(np.uint8).reshape(len(strs), 16)
    lengths = np.array([len(s) for s in strs])
    got = hashing.fnv1a_bytes_matrix(mat, lengths)
    np.testing.assert_array_equal(got, np.array([_fnv1a_ref(s) for s in strs], np.uint64))
    np.testing.assert_array_equal(got, jax_hashing.fnv1a_bytes_matrix(mat, lengths))


@pytest.mark.parametrize("buckets", [1, 7, 997, 65536, 100_000, 2**31 - 1])
@pytest.mark.parametrize("width", [8, 16, 24])
def test_hash_strings_bit_equal_jax(width, buckets):
    vals = _strings(width, seed=width)
    got = hashing.hash_strings(vals, buckets)
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() < buckets
    np.testing.assert_array_equal(got, jax_hashing.hash_strings(vals, buckets))
    if buckets >= 997:
        assert len(np.unique(got)) > min(buckets, len(vals)) // 2  # a decent spread


def test_hash_strings_takes_str_arrays():
    vals = np.array(["abc", "", "0a1b2c3d"])
    np.testing.assert_array_equal(hashing.hash_strings(vals, 1000),
                                  jax_hashing.hash_strings(vals, 1000))


@pytest.mark.parametrize("buckets", [2, 64, 1000])
def test_bucketize_log2_bit_equal_jax(buckets):
    v = np.concatenate([np.array([-5, -1, 0, 1, 2, 3, 10, 100, 10**6, 2**40]),
                        np.random.default_rng(1).integers(-1, 10**7, 5000)])
    got = hashing.bucketize_log2(v, buckets)
    np.testing.assert_array_equal(got, jax_hashing.bucketize_log2(v, buckets))
    assert got.dtype == np.int32 and got.max() < buckets
    if buckets == 64:
        assert got.tolist()[1:6] == [0, 1, 2, 3, 4]
        assert (np.diff(got[:10]) >= 0).all()


@pytest.mark.parametrize("width", [8, 16, 24])
def test_native_hash_bit_equal(width):
    vals = _strings(width, seed=100 + width)
    np.testing.assert_array_equal(native.hash_strings_native(vals, 99991),
                                  jax_hashing.hash_strings(vals, 99991))

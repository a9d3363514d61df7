"""The port's sorted-segment dedup (plain version, CPU) vs
`cffm_tpu.ops.sorted_segment.sorted_segment_sum_compact` (Pallas
interpret mode).

uids and count must be exact. gsum is an f32 sum rounded to bf16 in both
packages, in different orders: within one bf16 ulp of the larger value
plus the f32 rounding two orders may differ by, (len - 1) * 2^-24 * sum|g|
over the segment. Empty slots hold -1 and exact zero rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu.ops.sorted_segment import EB
from cffm_tpu.ops.sorted_segment import sorted_segment_sum_compact as jax_compact
from cffm_tpu_torch.ops import sorted_segment as ss


def _case(n, w, seed, lo=0, hi=4096, hot=0):
    rng = np.random.default_rng(seed)
    sid = rng.integers(lo, hi, size=n).astype(np.int64)
    if hot:
        sid[:hot] = sid[hot]  # one hot segment spanning many blocks
    sid = np.sort(sid).astype(np.int32)
    grads = (rng.normal(size=(n, w)) * 0.1).astype(np.float32)
    m_pad = -(-n // EB) * EB + EB
    return sid, grads, m_pad


def _compare(sid, grads, m_pad, max_id=None):
    uw, gw, cw = jax_compact(jnp.asarray(sid), jnp.asarray(grads), m_pad, max_id=max_id)
    uids, gsum, count = ss.sorted_segment_sum_compact(torch.from_numpy(sid),
                                                      torch.from_numpy(grads), m_pad)
    assert uids.dtype == torch.int32 and gsum.dtype == torch.bfloat16
    assert int(count) == int(cw)
    np.testing.assert_array_equal(uids.numpy(), np.asarray(uw))
    c = int(count)
    assert (uids[c:] == -1).all() and (gsum[c:] == 0).all()
    got, want = gsum.float().numpy(), np.asarray(gw, np.float32)
    _, inv, lens = np.unique(sid, return_inverse=True, return_counts=True)
    abs_sum = np.zeros((m_pad, grads.shape[1]), np.float64)
    np.add.at(abs_sum, inv, np.abs(grads.astype(np.float64)))
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.ldexp(1.0, np.frexp(np.maximum(big, 1e-30))[1] - 8)
    runs = np.zeros(m_pad)
    runs[: len(lens)] = lens
    limit = ulp + np.maximum(runs - 1, 0)[:, None] * 2.0**-24 * abs_sum
    assert (np.abs(got - want) <= limit).all()
    return c


@pytest.mark.parametrize("n,seed", [(333, 0), (1000, 1), (129, 2)])
def test_matches_jax_with_ragged_n_and_a_hot_segment(n, seed):
    sid, grads, m_pad = _case(n, 128, seed, hot=n // 3)
    assert n % 128 != 0
    _compare(sid, grads, m_pad)


@pytest.mark.parametrize("lo", [1 << 16, 1 << 24])
def test_wide_ids_come_back_exact(lo):
    sid, grads, m_pad = _case(300, 256, 3, lo=lo, hi=lo + 5000, hot=40)
    c = _compare(sid, grads, m_pad, max_id=lo + 5001)
    uids, _, _ = ss.sorted_segment_sum_compact(torch.from_numpy(sid),
                                               torch.from_numpy(grads), m_pad)
    np.testing.assert_array_equal(uids[:c].numpy(), np.unique(sid))


def test_single_segment_sums_in_f32():
    """One id repeated 1024 times: the sum is f32-exact before its one
    bf16 rounding (ones sum to 1024 exactly)."""
    sid = np.full((1024,), 7, np.int32)
    grads = np.ones((1024, 128), np.float32)
    uids, gsum, count = ss.sorted_segment_sum_compact(torch.from_numpy(sid),
                                                      torch.from_numpy(grads), 256)
    assert int(count) == 1 and uids[0] == 7 and (uids[1:] == -1).all()
    assert (gsum[0] == 1024).all() and (gsum[1:] == 0).all()


def test_grads_are_rounded_to_bf16_before_the_sum():
    sid = np.array([0, 0], np.int32)
    grads = np.full((2, 128), 1.0 + 2.0**-12, np.float32)  # rounds to 1.0 in bf16
    _, gsum, _ = ss.sorted_segment_sum_compact(torch.from_numpy(sid),
                                               torch.from_numpy(grads), 128)
    assert (gsum[0] == 2.0).all()


def test_rejects_unaligned_width():
    with pytest.raises(ValueError, match="W % 128"):
        ss.sorted_segment_sum_compact(torch.zeros(4, dtype=torch.int32),
                                      torch.zeros(4, 100), 128)

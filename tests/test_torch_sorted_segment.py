"""The port's sorted-segment dedup (plain versions, CPU) vs
`cffm_tpu.ops.sorted_segment.sorted_segment_sum_compact` (kernel 3) and
`sorted_segment_sum_by_seg` (kernel 6), Pallas interpret mode.

Kernel 6: one bf16 ulp of the larger value (each package rounds its f32
sum once), and bit for bit where every sum is exact in f32 and bf16;
slots past the segment count zero in both.

Kernel 3:

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
from cffm_tpu.ops.sorted_segment import sorted_segment_sum_by_seg as jax_by_seg
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


# ---------------------------------------------------------------------------
# Kernel 6: sorted_segment_sum_by_seg (the sharded gradient return's dedup)
# ---------------------------------------------------------------------------


def _by_seg_case(n, w, seed, hot=0, integer=False):
    """A routing-style seg stream (from 0, steps of 0 or 1) and bf16 grads."""
    rng = np.random.default_rng(seed)
    steps = (rng.random(n) < 0.3).astype(np.int32)
    steps[0] = 0
    if hot:
        steps[n // 3:n // 3 + hot] = 0  # one hot segment spanning many blocks
    seg = np.cumsum(steps).astype(np.int32)
    g = (rng.integers(-4, 5, size=(n, w)) if integer else rng.normal(size=(n, w)))
    grads = np.asarray(jnp.asarray(g.astype(np.float32)).astype(jnp.bfloat16))
    m_pad = -(-n // EB) * EB + EB
    return seg, grads, m_pad


def _bf16_torch(a):
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("n,seed,hot", [(333, 0, 150), (1000, 1, 0), (129, 2, 100)])
def test_by_seg_matches_jax_within_one_ulp(n, seed, hot):
    seg, grads, m_pad = _by_seg_case(n, 256, seed, hot)
    want = np.asarray(jax_by_seg(jnp.asarray(seg), jnp.asarray(grads), m_pad), np.float32)
    got = ss.sorted_segment_sum_by_seg(torch.from_numpy(seg), _bf16_torch(grads), m_pad)
    assert got.dtype == torch.bfloat16 and got.shape == (m_pad, 256)
    got = got.float().numpy()
    count = int(seg[-1]) + 1
    assert (got[count:] == 0).all() and (want[count:] == 0).all()
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.ldexp(1.0, np.frexp(np.maximum(big, 1e-30))[1] - 8)
    assert (np.abs(got - want) <= ulp).all()


def test_by_seg_is_exact_where_the_sums_are():
    """Small-integer grads: every f32 sum is exact and fits bf16, so the two
    packages agree bit for bit, the hot segment included."""
    seg, grads, m_pad = _by_seg_case(700, 128, 3, hot=300, integer=True)
    want = np.asarray(jax_by_seg(jnp.asarray(seg), jnp.asarray(grads), m_pad), np.float32)
    got = ss.sorted_segment_sum_by_seg(torch.from_numpy(seg), _bf16_torch(grads), m_pad)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_by_seg_rejects_what_the_kernel_does_not_take():
    seg = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="W % 128"):
        ss.sorted_segment_sum_by_seg(seg, torch.zeros(4, 100, dtype=torch.bfloat16), 128)
    with pytest.raises(TypeError, match="bf16"):
        ss.sorted_segment_sum_by_seg(seg, torch.zeros(4, 128), 128)

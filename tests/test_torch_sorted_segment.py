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


# ---------------------------------------------------------------------------
# Streams that cut the kernels' tree of chunked passes at its edges
# ---------------------------------------------------------------------------


def _edge_seg(kind, n):
    """A seg stream (from 0, steps of 0 or 1) of one edge kind."""
    ar = np.arange(n)
    if kind == "stage2":  # a few singletons, then one tail segment over most of n
        return np.minimum(ar, n - 1700).astype(np.int32)
    if kind == "aligned":  # boundaries on the chunks of the kernel's first pass
        return (ar // ss.CHUNK0).astype(np.int32)
    if kind == "off_by_one":  # boundaries one entry past them
        return (np.maximum(ar - 1, 0) // ss.CHUNK0).astype(np.int32)
    raise ValueError(kind)


def _int_grads(n, w, seed):
    """bf16 small integers: every f32 sum is exact, whatever its order."""
    g = np.random.default_rng(seed).integers(-4, 5, size=(n, w)).astype(np.float32)
    return np.asarray(jnp.asarray(g).astype(jnp.bfloat16))


EDGES = [("stage2", 2000), ("aligned", 12 * ss.CHUNK0), ("aligned", 12 * ss.CHUNK0 + 1),
         ("off_by_one", 12 * ss.CHUNK0 + 3)]


@pytest.mark.parametrize("kind,n", EDGES, ids=[f"{k}-{n}" for k, n in EDGES])
@pytest.mark.parametrize("integer", [True, False], ids=["exact", "normal"])
def test_by_seg_edge_streams_match_jax(kind, n, integer):
    """Kernel 6's plain version against JAX on a stream whose last segment
    spans most of n (stage 2 scaled down) and on boundaries at and one entry
    off the chunks of the kernel's first pass: bit for bit where every sum
    is exact, else within one bf16 ulp."""
    seg = _edge_seg(kind, n)
    grads = _int_grads(n, 256, 4) if integer else _by_seg_case(n, 256, 4)[1]
    m_pad = -(-(int(seg[-1]) + 1) // EB) * EB + EB
    want = np.asarray(jax_by_seg(jnp.asarray(seg), jnp.asarray(grads), m_pad), np.float32)
    got = ss.sorted_segment_sum_by_seg(torch.from_numpy(seg), _bf16_torch(grads), m_pad)
    got = got.float().numpy()
    if integer:
        np.testing.assert_array_equal(got, want)
        return
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.ldexp(1.0, np.frexp(np.maximum(big, 1e-30))[1] - 8)
    assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("kind,n", EDGES, ids=[f"{k}-{n}" for k, n in EDGES])
def test_compact_edge_streams_match_jax(kind, n):
    """Kernel 3's plain version against JAX on the same streams (ids from
    the segment index), within `_compare`'s limit: uids and count exact."""
    seg = _edge_seg(kind, n)
    sid = (seg * 3 + 5).astype(np.int32)
    grads = np.random.default_rng(5).normal(size=(n, 128)).astype(np.float32) * 0.1
    m_pad = -(-(int(seg[-1]) + 1) // EB) * EB + EB
    assert _compare(sid, grads, m_pad) == int(seg[-1]) + 1


def _exact_sums(seg, grads, m_pad):
    out = np.zeros((max(m_pad, int(seg[-1]) + 1), grads.shape[1]), np.float64)
    np.add.at(out, seg, grads.astype(np.float64))
    return out[:m_pad]


def test_by_seg_drops_segments_past_m_pad():
    """A count (667) past m_pad (256): the port keeps segments below m_pad,
    exact, and drops the rest. The JAX kernel writes the blocks past its
    last one onto that block (its callers bound the count), so the two
    agree on the slots below m_pad - EB."""
    seg = (np.arange(2000) // 3).astype(np.int32)
    grads = _int_grads(2000, 128, 6)
    m_pad = 2 * EB
    got = ss.sorted_segment_sum_by_seg(torch.from_numpy(seg), _bf16_torch(grads), m_pad)
    got = got.float().numpy()
    np.testing.assert_array_equal(got, _exact_sums(seg, grads, m_pad))
    want = np.asarray(jax_by_seg(jnp.asarray(seg), jnp.asarray(grads), m_pad), np.float32)
    np.testing.assert_array_equal(got[:m_pad - EB], want[:m_pad - EB])


def test_compact_drops_segments_past_m_pad():
    """Kernel 3's plain version at a count (667) past m_pad (256): uids and
    sums of the segments below m_pad, exact; the count is the full count.
    JAX agrees below m_pad - EB (see the kernel-6 case)."""
    seg = (np.arange(2000) // 3).astype(np.int32)
    sid = (seg * 3 + 5).astype(np.int32)
    grads = np.asarray(_int_grads(2000, 128, 7), np.float32)
    m_pad = 2 * EB
    uids, gsum, count = ss.sorted_segment_sum_compact(torch.from_numpy(sid),
                                                      torch.from_numpy(grads), m_pad)
    assert int(count) == 667
    np.testing.assert_array_equal(uids.numpy(), np.arange(m_pad) * 3 + 5)
    np.testing.assert_array_equal(gsum.float().numpy(), _exact_sums(seg, grads, m_pad))
    uw, gw, cw = jax_compact(jnp.asarray(sid), jnp.asarray(grads), m_pad)
    assert int(cw) == 667
    np.testing.assert_array_equal(uids.numpy()[:m_pad - EB], np.asarray(uw)[:m_pad - EB])
    np.testing.assert_array_equal(gsum.float().numpy()[:m_pad - EB],
                                  np.asarray(gw, np.float32)[:m_pad - EB])


# scratch rows: 2 per chunk of every level with more than one chunk
SCRATCH = [(0, 0), (1, 0), (128, 0), (129, 4), (4096, 64), (4097, 70),
           (1_703_936, 2 * (13_312 + 416 + 13)), (1_704_832, 2 * (13_319 + 417 + 14))]


@pytest.mark.parametrize("n,rows", SCRATCH, ids=[str(n) for n, _ in SCRATCH])
def test_scratch_rows_counts_each_level(n, rows):
    assert ss.CHUNK0 == 128 and ss.CHUNK_N == 32
    assert ss.scratch_rows(n) == rows


def _tree_sums(seg, grads, m_pad, chunk0, chunk_n, order=None, lo=0):
    """The kernel's tree, pass by pass, in f32 (csrc/sorted_segment.cu):
    level 0 walks chunks of chunk0 entries; each level above takes entry j
    = tail[j] + head[j + 1] of the level below, labelled by chunk j's last
    entry, in chunks of chunk_n; the level with one chunk stores the rest.
    With order (the scatter entry), level 0 reads entry e's row order[e]
    and segment s goes to row s - lo, m_pad rows from lo. Returns (sums
    (m_pad, W), times each row was stored)."""
    n, w = grads.shape
    out = np.zeros((m_pad, w), np.float32)
    stored = np.zeros(m_pad, np.int64)

    def store(s, acc):
        if 0 <= s - lo < m_pad:
            out[s - lo] = acc
            stored[s - lo] += 1

    def value(e):
        return grads[e if order is None else order[e]].astype(np.float32)

    count, length, stride = n, chunk0, 1
    while count > 0:
        chunks = -(-count // length)
        top = chunks == 1

        def label(i, stride=stride):
            return int(seg[min((i + 1) * stride, n) - 1])

        head = np.zeros((chunks, w), np.float32)
        tail = np.zeros((chunks, w), np.float32)
        for c in range(chunks):
            e0, e1 = c * length, min((c + 1) * length, count)
            cur = label(e0)
            here = e0 == 0 or label(e0 - 1) != cur
            acc = np.zeros(w, np.float32)
            for e in range(e0, e1):
                if label(e) != cur:
                    if here:
                        store(cur, acc)
                    else:
                        head[c] = acc
                    acc, cur, here = np.zeros(w, np.float32), label(e), True
                acc = acc + value(e)
            if top:
                store(cur, acc)
            elif here:
                tail[c] = acc
            else:
                head[c] = acc
        if top:
            break

        def value(j, tail=tail, head=head, chunks=chunks):
            return tail[j] + (head[j + 1] if j + 1 < chunks else np.float32(0))

        count, length, stride = chunks, chunk_n, stride * length
    return out, stored


TREES = [(ss.CHUNK0, ss.CHUNK_N, n) for n in (1, 128, 129, 4500)] + [
    (4, 3, n) for n in (1, 2, 5, 17, 100)] + [(2, 2, 33)]


@pytest.mark.parametrize("chunk0,chunk_n,n", TREES,
                         ids=[f"{a}-{b}-{n}" for a, b, n in TREES])
@pytest.mark.parametrize("kind", ["one", "each", "random", "tail", "aligned", "past_m_pad"])
def test_tree_of_passes_stores_each_segment_once(chunk0, chunk_n, n, kind):
    """The kernel's tree, modelled in numpy at its own chunk lengths and at
    tiny ones (many levels): every segment below m_pad stored exactly once
    with its exact sum, whatever the stream's cut; nothing else stored."""
    rng = np.random.default_rng(n)
    ar = np.arange(n)
    steps = (rng.random(n) < 0.3).astype(np.int64)
    steps[0] = 0
    seg = {"one": 0 * ar, "each": ar, "random": np.cumsum(steps),
           "tail": np.minimum(ar, n // 10), "aligned": ar // chunk0,
           "past_m_pad": ar // 2}[kind].astype(np.int32)
    count = int(seg[-1]) + 1
    m_pad = max(1, n // 5) if kind == "past_m_pad" else count + 3
    grads = rng.integers(-4, 5, size=(n, 8)).astype(np.float32)
    sums, stored = _tree_sums(seg, grads, m_pad, chunk0, chunk_n)
    kept = min(count, m_pad)
    assert (stored[:kept] == 1).all() and (stored[kept:] == 0).all()
    np.testing.assert_array_equal(sums, _exact_sums(seg, grads, m_pad))


SCATTER_TREES = [(ss.CHUNK0, ss.CHUNK_N, 6000, 4500), (4, 3, 100, 40), (2, 2, 33, 20)]


@pytest.mark.parametrize("chunk0,chunk_n,n,hot", SCATTER_TREES,
                         ids=[f"{a}-{b}-{n}" for a, b, n, _ in SCATTER_TREES])
def test_the_scatter_entry_stores_each_live_segment_once_at_its_row(chunk0, chunk_n, n, hot):
    """The scatter entry's compaction, modelled on its tree: grads read in
    their own order through the sort's permutation, negative ids first and
    the sentinel run last; every live segment s stored once, at row s - lo,
    with its exact sum, and nothing of the other segments. At the kernel's
    chunks one live segment of `hot` > 128 x 32 entries runs through two
    levels above the first; the plain version agrees bit for bit."""
    rng = np.random.default_rng(n)
    rows = 50
    ids = rng.integers(-3, rows + 1, size=n)
    ids[rng.permutation(n)[:hot]] = 7  # one long live segment
    ids[rng.permutation(n)[:n // 20]] = rows  # the sentinel run
    order = np.argsort(ids, kind="stable")
    sid = ids[order]
    seg = np.cumsum(np.r_[0, (sid[1:] != sid[:-1]).astype(np.int64)]).astype(np.int32)
    lo = len(np.unique(sid[sid < 0]))
    live = len(np.unique(sid[(sid >= 0) & (sid < rows)]))
    grads = rng.integers(-4, 5, size=(n, 8)).astype(np.float32)
    sums, stored = _tree_sums(seg, grads, live, chunk0, chunk_n, order=order, lo=lo)
    assert (stored == 1).all()
    want = np.zeros((live, 8), np.float32)
    np.add.at(want, seg[(seg >= lo) & (seg < lo + live)] - lo,
              grads[order][(seg >= lo) & (seg < lo + live)])
    np.testing.assert_array_equal(sums, want)
    if chunk0 == ss.CHUNK0:
        assert (seg == seg[np.searchsorted(sid, 7)]).sum() > ss.CHUNK0 * ss.CHUNK_N
        assert ss.scratch_rows(n) > 2 * -(-n // ss.CHUNK0)  # a second level above the first
    plain = ss.scatter_segment_sum_reference(
        torch.from_numpy(order), torch.from_numpy(seg.astype(np.int64)),
        torch.from_numpy(grads), lo, live)
    np.testing.assert_array_equal(plain.numpy(), want)

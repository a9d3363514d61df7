"""The port's touched-row apply (plain versions, CPU) vs the JAX streamed
apply (`streamed_rowwise_apply`, `streamed_rowwise_adam_apply`, Pallas
interpret mode), on the same uids and bf16 gradient sums, at the widths
and live counts kernels 4-5 split their work on (the register route at
128 and 640 lanes, the chunked route at 2560; no live slot, a partial
prefix, every slot live); and the bucketed apply of the sharded step
(`bucketed_rowwise_apply`, `bucketed_rowwise_adam_apply`) on the same
overlapping buckets, with and without the per-row clip (kernel 7's plain
version).

f32 tables: rtol 1e-6, atol 1e-7 (mean(S^2) sums in another order).
bf16 tables round to nearest in both (the JAX interpret mode has no
stochastic rounding): equal, or one bf16 ulp apart where the f32 sums
straddle a rounding boundary. Rows outside uids: bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cffm_tpu.ops import streamed_update as jax_su
from cffm_tpu_torch.ops import streamed_update as su

W = 128


def _inputs(v, n_touched, seed, table_dtype=np.float32, w=W):
    rng = np.random.default_rng(seed)
    uids = np.sort(rng.choice(v, size=n_touched, replace=False)).astype(np.int32)
    m = su.padded_entries(n_touched, su.pick_tile(v))
    assert m == jax_su.padded_entries(n_touched, jax_su.pick_tile(v))
    uids_s = np.full((m,), v, np.int32)
    uids_s[:n_touched] = uids
    gsum = np.zeros((m, w), np.float32)
    gsum[:n_touched] = rng.normal(size=(n_touched, w)) * 0.1
    gsum = np.asarray(jnp.asarray(gsum).astype(jnp.bfloat16))
    table = rng.normal(size=(v, w)).astype(np.float32) * 0.1
    if table_dtype != np.float32:
        table = np.asarray(jnp.asarray(table).astype(jnp.bfloat16))
    return table, uids_s, gsum, uids


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _untouched_equal(got, before, uids):
    keep = np.ones(before.shape[0], bool)
    keep[uids] = False
    np.testing.assert_array_equal(got[keep], before[keep])


@pytest.mark.parametrize("mode", ["adagrad", "sgd"])
@pytest.mark.parametrize("v", [1024, 1100])  # 1100: a partial final tile of 512
def test_adagrad_sgd_match_jax(mode, v):
    table, uids_s, gsum, uids = _inputs(v, 300, seed=v)
    acc = np.random.default_rng(1).uniform(0.1, 1.0, size=(v, 1)).astype(np.float32)
    jacc = jnp.asarray(acc) if mode == "adagrad" else None
    t_want, a_want = jax_su.streamed_rowwise_apply(
        jnp.asarray(table), jacc, jnp.asarray(uids_s), jnp.asarray(gsum), 0.05, 1e-8)
    tacc = _t(acc) if mode == "adagrad" else None
    t_got, a_got = su.streamed_rowwise_apply(_t(table), tacc, _t(uids_s), _t(gsum), 0.05, 1e-8)
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_want), rtol=1e-6, atol=1e-7)
    _untouched_equal(t_got.numpy(), table, uids)
    if mode == "adagrad":
        np.testing.assert_allclose(a_got.numpy(), np.asarray(a_want), rtol=1e-6)
        _untouched_equal(a_got.numpy(), acc, uids)


def test_rowwise_adam_matches_jax():
    v = 1100
    table, uids_s, gsum, uids = _inputs(v, 300, seed=5)
    rng = np.random.default_rng(6)
    m = (rng.normal(size=(v, W)) * 0.01).astype(np.float32)
    vv = rng.uniform(1e-5, 1e-3, size=(v, 1)).astype(np.float32)
    t_want, m_want, v_want = jax_su.streamed_rowwise_adam_apply(
        jnp.asarray(table), jnp.asarray(m), jnp.asarray(vv), jnp.asarray(uids_s),
        jnp.asarray(gsum), 0.01, 1e-8, 0.9, 0.999, jnp.int32(3))
    t_got, m_got, v_got = su.streamed_rowwise_adam_apply(
        _t(table), _t(m), _t(vv), _t(uids_s), _t(gsum), 0.01, 1e-8, 0.9, 0.999,
        torch.tensor(3, dtype=torch.int32))
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m_got.numpy(), np.asarray(m_want), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(v_got.numpy(), np.asarray(v_want), rtol=1e-6)
    for got, before in ((t_got, table), (m_got, m), (v_got, vv)):
        _untouched_equal(got.numpy(), before, uids)


def test_all_sentinels_is_a_no_op():
    v = 1024
    table, uids_s, gsum, _ = _inputs(v, 300, seed=7)
    uids_s[:] = v
    acc = np.full((v, 1), 0.1, np.float32)
    t_got, a_got = su.streamed_rowwise_apply(_t(table), _t(acc), _t(uids_s), _t(gsum),
                                             0.05, 1e-8)
    np.testing.assert_array_equal(t_got.numpy(), table)
    np.testing.assert_array_equal(a_got.numpy(), acc)


def test_bf16_table_nearest_matches_jax():
    v = 1024
    table, uids_s, gsum, uids = _inputs(v, 300, seed=8, table_dtype="bf16")
    acc = np.full((v, 1), 0.1, np.float32)
    t_want, _ = jax_su.streamed_rowwise_apply(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(uids_s), jnp.asarray(gsum),
        0.05, 1e-8)
    t_got, _ = su.streamed_rowwise_apply(_t(table), _t(acc), _t(uids_s), _t(gsum), 0.05, 1e-8)
    assert t_got.dtype == torch.bfloat16
    got, want = t_got.float().numpy(), np.asarray(t_want, np.float32)
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(want), 1e-30))[1] - 8)
    assert (np.abs(got - want) <= ulp).all()
    assert (got == want).mean() > 0.999
    _untouched_equal(got, np.asarray(table, np.float32), uids)


def test_stochastic_bf16_stays_within_one_ulp_of_nearest():
    v = 1024
    table, uids_s, gsum, uids = _inputs(v, 300, seed=9, table_dtype="bf16")
    acc = np.full((v, 1), 0.1, np.float32)
    near, _ = su.streamed_rowwise_apply(_t(table), _t(acc), _t(uids_s), _t(gsum), 0.05, 1e-8)
    sr, _ = su.streamed_rowwise_apply(_t(table), _t(acc), _t(uids_s), _t(gsum), 0.05, 1e-8,
                                      sr_seed=11)
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(near.float().numpy()), 1e-30))[1] - 8)
    assert (np.abs(sr.float().numpy() - near.float().numpy()) <= ulp).all()
    assert (sr != near).any()
    _untouched_equal(sr.float().numpy(), np.asarray(table, np.float32), uids)


# live rows of V_ROUTES whose padded slots (640 at tile 512) hold none, some or all
V_ROUTES = 700
LIVE = {"none": 0, "partial": 300, "all": 640}


@pytest.mark.parametrize("table_dtype", ["float32", "bf16"])
@pytest.mark.parametrize("mode", ["adagrad", "sgd", "rowwise_adam"])
@pytest.mark.parametrize("live", sorted(LIVE))
@pytest.mark.parametrize("w", [128, 640, 2560])
def test_routes_match_jax(w, live, mode, table_dtype):
    """Each route's widths (kernels 4-5 hold 128 and 640 lanes in registers
    and take 2560 in chunks) and live counts, against the JAX kernel: f32
    at rtol 1e-6, atol 1e-7; bf16 (nearest) within one ulp, equal for all
    but 0.1%, plus 4 f32 ulps of the value before the step where the step
    cancels it (the two round lr * S apart in f32); the optimizer state as
    the f32 table; rows outside bit-equal."""
    v, n = V_ROUTES, LIVE[live]
    table, uids_s, gsum, uids = _inputs(v, n, seed=w + n, table_dtype=np.float32
                                        if table_dtype == "float32" else "bf16", w=w)
    assert uids_s.shape == (640,) and su.streamed_route(w) == {128: 4, 640: 10, 2560: 0}[w]
    rng = np.random.default_rng(3)
    j = jnp.asarray
    if mode == "rowwise_adam":
        m = (rng.normal(size=(v, w)) * 0.01).astype(np.float32)
        vv = rng.uniform(1e-5, 1e-3, size=(v, 1)).astype(np.float32)
        want = jax_su.streamed_rowwise_adam_apply(j(table), j(m), j(vv), j(uids_s), j(gsum), 0.01,
                                                  1e-8, 0.9, 0.999, jnp.int32(3))
        got = su.streamed_rowwise_adam_apply(_t(table), _t(m), _t(vv), _t(uids_s), _t(gsum), 0.01,
                                             1e-8, 0.9, 0.999, torch.tensor(3, dtype=torch.int32))
        befores = (table, m, vv)
    else:
        acc = rng.uniform(0.1, 1.0, size=(v, 1)).astype(np.float32)
        jacc, tacc = (j(acc), _t(acc)) if mode == "adagrad" else (None, None)
        want = jax_su.streamed_rowwise_apply(j(table), jacc, j(uids_s), j(gsum), 0.05, 1e-8)
        got = su.streamed_rowwise_apply(_t(table), tacc, _t(uids_s), _t(gsum), 0.05, 1e-8)
        befores = (table, acc) if mode == "adagrad" else (table,)
    for k, (got_x, want_x, before) in enumerate(zip(got, want, befores)):
        got_x = got_x.float().numpy()
        want_x, before = np.asarray(want_x, np.float32), np.asarray(before, np.float32)
        if k == 0 and table_dtype == "bf16":
            ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(want_x), 1e-30))[1] - 8)
            assert (np.abs(got_x - want_x) <= ulp + 2.0**-22 * np.abs(before)).all()
            assert (got_x == want_x).mean() > 0.999
        else:
            np.testing.assert_allclose(got_x, want_x, rtol=1e-6, atol=1e-7)
        _untouched_equal(got_x, before, uids)
        if n == 0:
            np.testing.assert_array_equal(got_x, before)


def test_gates_match_jax():
    for v in (10, 64, 100, 300, 600, 2_600_832):
        assert su.pick_tile(v) == jax_su.pick_tile(v)
        for m in (1, 128, 129, 5000):
            r = su.pick_tile(v) or 64
            assert su.padded_entries(m, r) == jax_su.padded_entries(m, r)


# ---------------------------------------------------------------------------
# Kernel 7: the bucketed apply of the sharded step
# ---------------------------------------------------------------------------

C = 256  # bucket capacity: passes bucketed_tile with a 128-row tile


def _buckets(v, nb, seed, garbage=0.5):
    """nb ascending unique buckets of up to C rows of [0, v), overlapping
    (a hot block of rows sits in every bucket), sentinel v in the tails,
    `garbage` in the sentinel slots' grads; bf16 grads."""
    rng = np.random.default_rng(seed)
    ids = np.full((nb, C), v, np.int32)
    g = rng.normal(size=(nb, C, W)).astype(np.float32) * 0.1
    hot = rng.choice(v, size=40, replace=False)
    for o in range(nb):
        rows = np.union1d(hot, rng.choice(v, size=rng.integers(60, 180), replace=False))
        ids[o, :len(rows)] = np.sort(rows)
        g[o, len(rows):] = garbage
    return ids, np.asarray(jnp.asarray(g).astype(jnp.bfloat16))


def _touched(ids, v):
    return np.unique(ids[ids < v])


@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("nb", [1, 3, 4])
@pytest.mark.parametrize("mode", ["adagrad", "sgd", "rowwise_adam"])
def test_bucketed_matches_jax(mode, nb, clip):
    v = 1100  # a partial final tile of 128
    assert su.bucketed_tile(v, W, nb, C) == jax_su.bucketed_tile(v, W, nb, C) == 128
    ids, g = _buckets(v, nb, seed=nb)
    table, _, _, _ = _inputs(v, 1, seed=20 + nb)
    rng = np.random.default_rng(21)
    acc = rng.uniform(0.1, 1.0, size=(v, 1)).astype(np.float32)
    m = (rng.normal(size=(v, W)) * 0.01).astype(np.float32)
    vv = rng.uniform(1e-5, 1e-3, size=(v, 1)).astype(np.float32)
    j = jnp.asarray
    if mode == "rowwise_adam":
        want = jax_su.bucketed_rowwise_adam_apply(j(table), j(m), j(vv), j(ids), j(g), 0.01, 1e-8,
                                                  0.9, 0.999, jnp.int32(3), clip=clip)
        got = su.bucketed_rowwise_adam_apply(_t(table), _t(m), _t(vv), _t(ids), _t(g), 0.01,
                                             1e-8, 0.9, 0.999, torch.tensor(3, dtype=torch.int32),
                                             clip=clip)
        befores = (table, m, vv)
    else:
        jacc, tacc = (j(acc), _t(acc)) if mode == "adagrad" else (None, None)
        want = jax_su.bucketed_rowwise_apply(j(table), jacc, j(ids), j(g), 0.05, 1e-8, clip=clip)
        got = su.bucketed_rowwise_apply(_t(table), tacc, _t(ids), _t(g), 0.05, 1e-8, clip=clip)
        befores = (table, acc) if mode == "adagrad" else (table,)
    touched = _touched(ids, v)
    for got_x, want_x, before in zip(got, want, befores):
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-6, atol=1e-7)
        _untouched_equal(got_x.numpy(), before, touched)


@pytest.mark.parametrize("mode", ["adagrad", "sgd", "rowwise_adam"])
def test_bucketed_bf16_nearest_matches_jax(mode):
    v, nb = 1100, 4
    ids, g = _buckets(v, nb, seed=30)
    table, _, _, _ = _inputs(v, 1, seed=31, table_dtype="bf16")
    acc = np.full((v, 1), 0.1, np.float32)
    m = np.zeros((v, W), np.float32)
    vv = np.zeros((v, 1), np.float32)
    j = jnp.asarray
    if mode == "rowwise_adam":
        want = jax_su.bucketed_rowwise_adam_apply(j(table), j(m), j(vv), j(ids), j(g), 0.01, 1e-8,
                                                  0.9, 0.999, jnp.int32(1), clip=0.5)[0]
        got = su.bucketed_rowwise_adam_apply(_t(table), _t(m), _t(vv), _t(ids), _t(g), 0.01,
                                             1e-8, 0.9, 0.999, torch.tensor(1, dtype=torch.int32),
                                             clip=0.5)[0]
    else:
        jacc, tacc = (j(acc), _t(acc)) if mode == "adagrad" else (None, None)
        want = jax_su.bucketed_rowwise_apply(j(table), jacc, j(ids), j(g), 0.05, 1e-8,
                                             clip=0.5)[0]
        got = su.bucketed_rowwise_apply(_t(table), tacc, _t(ids), _t(g), 0.05, 1e-8, clip=0.5)[0]
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(want), 1e-30))[1] - 8)
    assert (np.abs(got - want) <= ulp).all()
    assert (got == want).mean() > 0.999
    _untouched_equal(got, np.asarray(table, np.float32), _touched(ids, v))


def test_bucketed_sums_buckets_before_the_update_and_drops_nan_garbage():
    """One row in all four buckets with partials 1, 2, 3, 4 (bf16-exact) and
    NaN in every sentinel slot: adagrad sees S = 10 once, every other row
    stays bit-equal."""
    v, nb = 1100, 4
    ids = np.full((nb, C), v, np.int32)
    g = np.full((nb, C, W), np.nan, np.float32)
    for o in range(nb):
        ids[o, :2] = [7, 100 + o]
        g[o, 0] = o + 1.0
        g[o, 1] = 1.0
    table = np.zeros((v, W), np.float32)
    acc = np.full((v, 1), 0.1, np.float32)
    t_got, a_got = su.bucketed_rowwise_apply(_t(table), _t(acc), _t(ids), _t(g), 0.05, 1e-8)
    a7 = np.float32(0.1) + np.float32(100.0)
    np.testing.assert_allclose(a_got[7].numpy(), [a7], rtol=1e-7)
    np.testing.assert_allclose(t_got[7].numpy(), -0.05 * 10.0 / (np.sqrt(a7) + 1e-8), rtol=1e-6)
    assert np.isfinite(t_got.numpy()).all()
    _untouched_equal(t_got.numpy(), table, np.array([7, 100, 101, 102, 103]))
    _untouched_equal(a_got.numpy(), acc, np.array([7, 100, 101, 102, 103]))


# ---------------------------------------------------------------------------
# Kernel 7's partition: every live id has one owner, its partials in bucket order
# ---------------------------------------------------------------------------


@st.composite
def _bucket_sets(draw):
    nb = draw(st.sampled_from([1, 2, 4, 8]))
    v = draw(st.integers(1, 300))
    c = draw(st.integers(1, 40))
    ids = np.full((nb, c), v, np.int64)
    for o in range(nb):
        live = draw(st.lists(st.integers(0, v - 1), max_size=c, unique=True))
        ids[o, :len(live)] = sorted(live)
        ids[o, len(live):] = v + draw(st.integers(0, 3))  # any value >= v is a sentinel
    return ids, v, draw(st.integers(1, 12)), draw(st.sampled_from([nb, 2 * nb, 16, 64]))


@settings(max_examples=200, deadline=None)
@given(_bucket_sets())
def test_bucketed_owners_one_owner_per_live_id_in_bucket_order(case):
    ids, v, groups, window = case
    owned = su.bucketed_owners(ids, v, groups, window)
    assert len(owned) == groups
    seen_ids, seen_slots = [], []
    for rows in owned:
        assert [x for x, _ in rows] == sorted({x for x, _ in rows})  # ascending, one run each
        for x, parts in rows:
            buckets = [b for b, _ in parts]
            assert buckets == sorted(set(buckets))  # bucket order, one partial per bucket
            assert all(ids[b, j] == x for b, j in parts)
            seen_ids.append(x)
            seen_slots += parts
    live = [(b, j) for b in range(ids.shape[0]) for j in range(ids.shape[1]) if ids[b, j] < v]
    assert sorted(seen_ids) == sorted(set(ids[ids < v].tolist()))  # exactly one owner
    assert sorted(seen_slots) == live  # every live slot read once, no sentinel


def test_bucketed_edges_match_jax():
    """A row in all NB=8 buckets, a row at V-1 and an all-sentinel bucket,
    against JAX in interpret mode (garbage in the sentinel slots' grads)."""
    v, nb = 1100, 8
    ids, g = _buckets(v, nb, seed=40)
    ids[:, 0] = 0  # row 0 in every bucket (the hot rows make 0 absent otherwise)
    ids[:, :] = np.sort(np.where(ids == v, v, ids), axis=1)
    ids[5] = v  # bucket 5: all sentinel
    ids[2, np.argmax(ids[2] == v) - 1] = v - 1
    ids[2] = np.sort(ids[2])
    assert all(len(np.unique(r[r < v])) == int((r < v).sum()) for r in ids)
    g = np.where((ids >= v)[..., None], np.float32(0.5), g.astype(np.float32))
    g = np.asarray(jnp.asarray(g).astype(jnp.bfloat16))
    table, _, _, _ = _inputs(v, 1, seed=41)
    acc = np.random.default_rng(42).uniform(0.1, 1.0, size=(v, 1)).astype(np.float32)
    want = jax_su.bucketed_rowwise_apply(jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids),
                                         jnp.asarray(g), 0.05, 1e-8, clip=0.5)
    got = su.bucketed_rowwise_apply(_t(table), _t(acc), _t(ids), _t(g), 0.05, 1e-8, clip=0.5)
    touched = _touched(ids, v)
    assert 0 in touched and v - 1 in touched
    for got_x, want_x, before in zip(got, want, (table, acc)):
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-6, atol=1e-7)
        _untouched_equal(got_x.numpy(), before, touched)

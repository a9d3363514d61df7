"""The port's touched-row apply (plain version, CPU) vs the JAX streamed
apply (`streamed_rowwise_apply`, `streamed_rowwise_adam_apply`, Pallas
interpret mode), on the same uids and bf16 gradient sums.

f32 tables: rtol 1e-6, atol 1e-7 (mean(S^2) sums in another order).
bf16 tables round to nearest in both (the JAX interpret mode has no
stochastic rounding): equal, or one bf16 ulp apart where the f32 sums
straddle a rounding boundary. Rows outside uids: bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu.ops import streamed_update as jax_su
from cffm_tpu_torch.ops import streamed_update as su

W = 128


def _inputs(v, n_touched, seed, table_dtype=np.float32):
    rng = np.random.default_rng(seed)
    uids = np.sort(rng.choice(v, size=n_touched, replace=False)).astype(np.int32)
    m = su.padded_entries(n_touched, su.pick_tile(v))
    assert m == jax_su.padded_entries(n_touched, jax_su.pick_tile(v))
    uids_s = np.full((m,), v, np.int32)
    uids_s[:n_touched] = uids
    gsum = np.zeros((m, W), np.float32)
    gsum[:n_touched] = rng.normal(size=(n_touched, W)) * 0.1
    gsum = np.asarray(jnp.asarray(gsum).astype(jnp.bfloat16))
    table = rng.normal(size=(v, W)).astype(np.float32) * 0.1
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


def test_gates_match_jax():
    for v in (10, 64, 100, 300, 600, 2_600_832):
        assert su.pick_tile(v) == jax_su.pick_tile(v)
        for m in (1, 128, 129, 5000):
            r = su.pick_tile(v) or 64
            assert su.padded_entries(m, r) == jax_su.padded_entries(m, r)

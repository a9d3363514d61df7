"""The port's per-row optimizers and dense chain vs `cffm_tpu.optim.rowwise`
and optax, on the same numpy inputs (CPU; the JAX Pallas kernels of the
streamed route run in interpret mode).

Tolerances: f32 state and tables rtol 1e-5, atol 1e-7 (sum orders). The
streamed route rounds each row's summed gradient to bf16 in both
packages, after f32 sums in another order, so one element of a summed
row can sit one bf16 ulp apart: its table steps are held at atol 1% of
the largest step and its state at rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cffm_tpu.config import OptimizerConfig as JaxOpt
from cffm_tpu.optim import rowwise as jax_rw
from cffm_tpu_torch.config import OptimizerConfig
from cffm_tpu_torch.optim import rowwise as rw

V, W = 1024, 128


def _mk(seed, n_ids=600):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, W)).astype(np.float32)
    ids = rng.integers(0, V, size=n_ids).astype(np.int32)
    ids[::13] = -1                                  # sentinels
    ids[5] = ids[6] = ids[7]                        # duplicates
    ids[10:40] = rng.integers(0, 8, size=30)        # hot rows
    ids[50:60] = V - 1                              # the last row
    grads = (rng.normal(size=(n_ids, W)) * 0.1).astype(np.float32)
    return table, ids, grads


def _opts(**kw):
    return JaxOpt(**kw), OptimizerConfig(**kw)


def _jax_state_np(state):
    return {k: np.asarray(v) for k, v in state.items()}


def _run_both(jopt, opt, table, ids, grads, **kw):
    js = jax_rw.rowwise_init(jnp.asarray(table), jopt)
    jt, js = jax_rw.rowwise_update(jnp.asarray(table), js, jnp.asarray(ids),
                                   jnp.asarray(grads), jopt, **kw)
    tt = torch.from_numpy(table.copy())
    ts = rw.rowwise_init(tt, opt)
    got_t, got_s = rw.rowwise_update(tt, ts, torch.from_numpy(ids), torch.from_numpy(grads),
                                     opt, **kw)
    assert got_t is tt  # in place
    return np.asarray(jt), _jax_state_np(js), got_t.numpy(), {
        k: v.numpy() for k, v in got_s.items()}


CASES = [("adagrad", "off"), ("adam", "off"), ("rowwise_adam", "off"), ("sgd", "off"),
         ("adagrad", "on"), ("rowwise_adam", "on"), ("sgd", "on")]


@pytest.mark.parametrize("optimizer,stream", CASES)
def test_rowwise_update_matches_jax(optimizer, stream):
    table, ids, grads = _mk(0)
    jopt, opt = _opts(sparse_optimizer=optimizer, sparse_lr=0.05, streamed_update=stream)
    assert rw._should_stream(torch.zeros(V, W), opt, len(ids), None) == (stream == "on")
    jt, js, tt, ts = _run_both(jopt, opt, table, ids, grads)
    d_want, d_got = jt - table, tt - table
    if stream == "on":
        np.testing.assert_allclose(d_got, d_want, atol=0.01 * np.abs(d_want).max())
    else:
        np.testing.assert_allclose(d_got, d_want, rtol=1e-5, atol=1e-7)
    touched = np.zeros(V, bool)
    touched[ids[ids >= 0]] = True
    np.testing.assert_array_equal(tt[~touched], table[~touched])
    assert sorted(ts) == sorted(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-3 if stream == "on" else 1e-5,
                                   atol=1e-7)


def test_per_field_sorted_route_matches_jax():
    """Field-major (F, B) ids with field offsets: the per-field sort of the
    streamed route, no sentinel masking (ids in range)."""
    rng = np.random.default_rng(3)
    f, b = 4, 96
    offs = (0, 200, 500, 700)
    sizes = (200, 300, 200, 324)
    ids = np.stack([o + np.minimum(rng.zipf(1.3, size=b) - 1, s - 1)
                    for o, s in zip(offs, sizes)]).astype(np.int32)
    table = rng.normal(size=(V, W)).astype(np.float32)
    grads = (rng.normal(size=(f * b, W)) * 0.1).astype(np.float32)
    jopt, opt = _opts(sparse_optimizer="adagrad", sparse_lr=0.05, streamed_update="on")
    kw = dict(field_offsets=offs, mask_sentinels=False, field_major=True,
              max_unique=f * b + 1)
    jt, js, tt, ts = _run_both(jopt, opt, table, ids.reshape(-1), grads, **kw)
    np.testing.assert_allclose(tt - table, jt - table, atol=0.01 * np.abs(jt - table).max())
    np.testing.assert_allclose(ts["accum"], js["accum"], rtol=1e-3)


def test_bf16_table_nearest_scatter_matches_jax():
    table, ids, grads = _mk(1)
    table = np.asarray(jnp.asarray(table).astype(jnp.bfloat16))
    jopt, opt = _opts(sparse_optimizer="adagrad", sparse_lr=0.05, streamed_update="off",
                      table_rounding="nearest")
    js = jax_rw.rowwise_init(jnp.asarray(table), jopt)
    jt, _ = jax_rw.rowwise_update(jnp.asarray(table), js, jnp.asarray(ids),
                                  jnp.asarray(grads), jopt)
    tt = torch.from_numpy(table.view(np.int16).copy()).view(torch.bfloat16)
    rw.rowwise_update(tt, rw.rowwise_init(tt, opt), torch.from_numpy(ids),
                      torch.from_numpy(grads), opt)
    want = np.asarray(jt, np.float32)
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(want), 1e-30))[1] - 8)
    assert (np.abs(tt.float().numpy() - want) <= ulp).all()


def test_bf16_stochastic_needs_a_key_on_the_streamed_route():
    table = torch.zeros((V, W), dtype=torch.bfloat16)
    opt = OptimizerConfig(streamed_update="on")
    with pytest.raises(ValueError, match="sr_key"):
        rw.rowwise_update(table, rw.rowwise_init(table, opt), torch.arange(8),
                          torch.ones(8, W), opt)
    key, _ = rw.sr_keys("bfloat16", opt, step=3, seed=0)
    rw.rowwise_update(table, rw.rowwise_init(table, opt), torch.arange(8),
                      torch.ones(8, W), opt, sr_key=key)
    assert (table[:8] != 0).all() and (table[8:] == 0).all()


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_dense_rowwise_apply_matches_jax(optimizer, clip):
    rng = np.random.default_rng(4)
    table = rng.normal(size=(64, W)).astype(np.float32)
    g = (rng.normal(size=(64, W)) * 0.1).astype(np.float32)
    g[::3] = 0.0  # untouched rows
    jopt, opt = _opts(sparse_optimizer=optimizer, sparse_lr=0.05, clip_norm=clip)
    js = jax_rw.rowwise_init(jnp.asarray(table), jopt)
    jt, js = jax_rw.dense_rowwise_apply(jnp.asarray(table), js, jnp.asarray(g), jopt,
                                        lr_scale=jnp.float32(0.5))
    ts = rw.rowwise_init(torch.from_numpy(table), opt)
    tt, ts = rw.dense_rowwise_apply(torch.from_numpy(table), ts, torch.from_numpy(g), opt,
                                    lr_scale=torch.tensor(0.5))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tt.numpy()[::3], table[::3])
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-6)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear"])
def test_schedule_factor_matches_jax(schedule):
    jopt, opt = _opts(lr_schedule=schedule, warmup_steps=5, decay_steps=50,
                      end_lr_factor=0.1)
    for step in (0, 3, 5, 17, 49, 50, 80):
        want = float(jax_rw.schedule_factor(jopt, jnp.int32(step), 100))
        got = rw.schedule_factor(opt, step, 100)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_clip_rows_matches_jax():
    rng = np.random.default_rng(5)
    g = (rng.normal(size=(32, W)) * rng.uniform(0.01, 3, size=(32, 1))).astype(np.float32)
    jopt, opt = _opts(clip_norm=1.0)
    np.testing.assert_allclose(rw.clip_rows(torch.from_numpy(g), opt).numpy(),
                               np.asarray(jax_rw.clip_rows(jnp.asarray(g), jopt)),
                               rtol=1e-6)
    off = torch.from_numpy(g)
    assert rw.clip_rows(off, OptimizerConfig()) is off  # clip_norm 0: untouched


def _dense_tree(rng):
    return {"conv": [{"w": rng.normal(size=(4, 6, 3)).astype(np.float32),
                      "b": rng.normal(size=(4,)).astype(np.float32)}],
            "tower": [{"w": rng.normal(size=(8, 1)).astype(np.float32),
                       "b": rng.normal(size=(1,)).astype(np.float32)}],
            "linear_bias": np.float32(rng.normal())}


def _flatten_optax(state):
    out = {}

    def walk(x):
        if hasattr(x, "mu"):
            out.update(count=x.count, mu=x.mu, nu=x.nu)
        elif hasattr(x, "sum_of_squares"):
            out.update(sum=x.sum_of_squares)
        elif isinstance(x, tuple):
            for y in x:
                walk(y)

    walk(state)
    return out


@pytest.mark.parametrize("optimizer", ["adam", "adagrad", "sgd"])
@pytest.mark.parametrize("wd,clip", [(0.0, 0.0), (0.01, 0.0), (0.01, 0.3)])
def test_dense_chain_matches_optax(optimizer, wd, clip):
    rng = np.random.default_rng(6)
    params = _dense_tree(rng)
    jopt, opt = _opts(dense_optimizer=optimizer, dense_lr=0.01, weight_decay=wd,
                      clip_norm=clip)
    tx = jax_rw.make_dense_optimizer(jopt)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    tp = rw.tree_map(lambda a: torch.tensor(a), params)
    dtx = rw.make_dense_optimizer(opt)
    ts = dtx.init(tp)
    for step in range(3):
        grads = jax.tree.map(lambda a: (rng.normal(size=np.shape(a)) * 0.5).astype(np.float32),
                             params)
        ju, js = tx.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = dtx.update(rw.tree_map(lambda a: torch.tensor(a), grads), ts, tp)
        tp = rw.tree_map(lambda p, u: p + u, tp, tu)
        for got, want in zip(rw.tree_leaves(tu), jax.tree.leaves(ju)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    for got, want in zip(rw.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    flat = _flatten_optax(js)
    assert sorted(flat) == sorted(ts)
    for k in flat:
        for got, want in zip(rw.tree_leaves(ts[k]), jax.tree.leaves(flat[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-8)


def test_unique_bound_and_tree_order_match_jax():
    assert rw.unique_bound((64, 100_000), 4096) == jax_rw.unique_bound((64, 100_000), 4096)
    tree = _dense_tree(np.random.default_rng(7))
    assert [np.shape(x) for x in rw.tree_leaves(tree)] == [
        np.shape(x) for x in jax.tree.leaves(tree)]
    again = rw.tree_unflatten(tree, rw.tree_leaves(tree))
    assert list(again) == list(tree)

"""The port's row-sharded embedding engine on 4 gloo processes vs
`cffm_tpu.parallel.sharded_embedding` under shard_map on a 4-device
mesh (the JAX segment-sum kernel in Pallas interpret mode), on the same
numpy ids, table and row grads.

Routing (recv_ids, start, idx_of_pos, overflow) and the looked-up rows
must be exact. The returned gradient buckets are sums in another order:
on valid slots, within one bf16 ulp of the larger value for bf16 grads
(each package rounds its f32 sum once), rtol 1e-6 for f32 grads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_sharded_worker as worker
from cffm_tpu.parallel import sharded_embedding as jse
from cffm_tpu.parallel.mesh import make_mesh
from cffm_tpu_torch.parallel import sharded_embedding as se

T = 4
V = 3000
VS = V // T


def _jax(ids, storage, drows, capacity, max_unique):
    def body(ids, table, g):
        r = jse.build_routing(ids, capacity, "data", rows_per_shard=VS)
        rows = jse.routed_lookup(table, r, "data")
        row_ids, grads = jse.grad_return(g, r, "data", max_unique=max_unique)
        return tuple(x[None] for x in (r.recv_ids, r.start, r.idx_of_pos, r.overflow,
                                       rows, row_ids, grads))

    fn = shard_map(body, mesh=make_mesh(T),
                   in_specs=(P("data"), P("data", None), P("data", None)),
                   out_specs=P("data"), check_vma=False)
    names = ("recv_ids", "start", "idx_of_pos", "overflow", "rows", "row_ids", "grads")
    out = jax.jit(fn)(jnp.asarray(ids), jnp.asarray(storage), drows)
    return dict(zip(names, (np.asarray(x, np.float32) if x.dtype == jnp.bfloat16
                            else np.asarray(x) for x in out)))


def _port(tmp_path, ids, storage, drows, capacity, max_unique):
    g = np.asarray(drows)
    if g.dtype.name == "bfloat16":
        g = g.view(np.int16)
    ranks = worker.run(worker.routing, tmp_path, T, ids=ids, table_storage=storage, drows=g,
                       capacity=capacity, rows_per_shard=VS, max_unique=max_unique)
    return {k: np.stack([r[k].numpy() for r in ranks]) for k in ranks[0]}


@pytest.mark.parametrize("case", ["bf16_no_overflow", "f32_forced_overflow"])
def test_routing_lookup_and_grad_return_match_jax(tmp_path, case):
    rng = np.random.default_rng(0)
    if case == "bf16_no_overflow":
        n, w = 512, 128  # zipf ids: hot rows requested by every shard
        ids = np.minimum(rng.zipf(1.3, size=n * T) - 1, V - 1).astype(np.int32)
        capacity = se.pick_capacity(n, T, 2.0, rows_per_shard=VS, max_unique=n)
        drows = jnp.asarray(rng.normal(size=(n * T, w)).astype(np.float32)).astype(jnp.bfloat16)
    else:
        n, w = 1024, 8  # uniform ids: ~217 distinct per owner against C=128
        ids = rng.integers(0, V, size=n * T).astype(np.int32)
        capacity = 128
        drows = jnp.asarray(rng.normal(size=(n * T, w)).astype(np.float32))
    storage = np.asarray(jse.to_mod_sharded(
        jnp.asarray(rng.normal(size=(V, w)).astype(np.float32)), T))
    want = _jax(ids, storage, drows, capacity, n)
    got = _port(tmp_path, ids, storage, drows, capacity, n)

    for k in ("recv_ids", "start", "idx_of_pos", "overflow", "row_ids"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["rows"], want["rows"])
    total = int(want["overflow"].sum())
    assert (total > 0) == (case == "f32_forced_overflow")
    if total:
        assert (want["rows"][want["idx_of_pos"] < 0] == 0).all()

    valid = want["recv_ids"] < VS
    g_got, g_want = got["grads"][valid], want["grads"][valid]
    if case == "bf16_no_overflow":
        big = np.maximum(np.abs(g_got), np.abs(g_want))
        ulp = np.ldexp(1.0, np.frexp(np.maximum(big, 1e-30))[1] - 8)
        assert (np.abs(g_got - g_want) <= ulp).all()
    else:
        np.testing.assert_allclose(g_got, g_want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("v,t", [(3000, 4), (1001, 8), (7, 3)])
def test_mod_sharded_layout_round_trips_and_matches_jax(v, t):
    table = np.random.default_rng(v).normal(size=(v, 5)).astype(np.float32)
    storage = se.to_mod_sharded(torch.from_numpy(table), t)
    np.testing.assert_array_equal(storage.numpy(),
                                  np.asarray(jse.to_mod_sharded(jnp.asarray(table), t)))
    np.testing.assert_array_equal(se.from_mod_sharded(storage, t, v).numpy(), table)


def test_pick_capacity_matches_jax():
    for args in [(1_703_936, 1, 2.0, 2_600_832, 1_703_937), (638_976, 4, 2.0, 650_208, 400_000),
                 (960, 4, 2.0, 3056, 929), (100, 4, 2.0, None, None), (5000, 8, 1.5, 100, 70)]:
        assert se.pick_capacity(*args) == jse.pick_capacity(*args)
    assert se.pick_capacity(5000, 4, cap_rows=300) == jse.pick_capacity(5000, 4, cap_rows=300)

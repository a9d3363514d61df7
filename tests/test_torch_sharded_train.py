"""The gold test of the port's sharded step: two steps of
`cffm_tpu_torch.parallel.sharded_train.make_sharded_train_step` on 4 gloo
processes vs `cffm_tpu.parallel.sharded_train.make_sharded_train_step` on
a 4-device mesh (Pallas kernels in interpret mode, bt=8), from the same
state (`convert.sharded_state_from_jax`) and the same global batches, on
every route (the sharded eval: test_torch_sharded_eval.py).

The bucketed update is forced (streamed_update "on", vocabularies whose
shards pass `bucketed_tile`) and the route asserted. Tolerances, as in
test_torch_train.py: loss rtol 1e-5; dense params rtol 1e-4, atol 1e-6
(1e-5 in bf16 compute, where the two packages round activations to bf16
at other places: 4e-6 seen on a conv bias after two steps); table steps
(new - initial) atol 1e-2 of the largest step, since each package
rounds the bucket sums to bf16 after f32 sums in another order; sparse
state rtol 1e-3, atol 1e-3 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_worker as worker
from cffm_tpu import metrics as jax_metrics
from cffm_tpu.config import DataConfig as JData
from cffm_tpu.config import ModelConfig as JModel
from cffm_tpu.config import OptimizerConfig as JOpt
from cffm_tpu.config import ShardingConfig as JShard
from cffm_tpu.config import TrainConfig as JTrain
from cffm_tpu.models.cffm import field_offsets
from cffm_tpu.ops import streamed_update as jax_su
from cffm_tpu.ops.interaction_conv import make_interaction_fn as jax_make_fn
from cffm_tpu.parallel import sharded_embedding as jse
from cffm_tpu.parallel import sharded_train as jst
from cffm_tpu.parallel.mesh import make_mesh
from cffm_tpu_torch import config, train
from cffm_tpu_torch.convert import natural_from_shards
from cffm_tpu_torch.ops import streamed_update as su
from cffm_tpu_torch.parallel.mesh import Mesh
from cffm_tpu_torch.parallel.sharded_train import _make_flat_router

T = 4
MIXED = (32, 64, 128) + (1000,) * 12          # F=15: fused column, 3 small fields
EIGHT = (610, 400, 20, 80, 220, 350, 190, 130)  # F=8, W=128: a separate linear table


def _cfgs(vocabs=MIXED, sparse="adagrad", dtype="float32", clip=0.0, cap_rows=0, **model_kw):
    mk = dict(num_fields=len(vocabs), vocab_sizes=vocabs, embed_dim=16,
              cross="field_aware", conv_channels=(16,), tower_hidden=(32,),
              compute_dtype=dtype, **model_kw)
    ok = dict(sparse_optimizer=sparse, dense_optimizer="adam", streamed_update="on",
              clip_norm=clip)
    sk = dict(table_sharded=True, cap_rows=cap_rows)
    jcfg = JTrain(name="t", model=JModel(**mk), optim=JOpt(**ok),
                  data=JData(batch_size=256), sharding=JShard(**sk))
    cfg = config.TrainConfig(name="t", model=config.ModelConfig(**mk),
                             optim=config.OptimizerConfig(**ok),
                             data=config.DataConfig(batch_size=256),
                             sharding=config.ShardingConfig(**sk))
    return jcfg, cfg


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    b = cfg.data.batch_size
    ids = np.stack([np.minimum(rng.zipf(1.3, size=b) - 1, v - 1)
                    for v in cfg.model.vocab_sizes], axis=1).astype(np.int32)
    ids += field_offsets(cfg.model)[None, :].astype(np.int32)
    return ids, (rng.random(b) < 0.4).astype(np.float32)


def _flatten_optax(state):
    out = {}

    def walk(x):
        if hasattr(x, "mu"):
            out.update(count=x.count, mu=x.mu, nu=x.nu)
        elif isinstance(x, tuple):
            for y in x:
                walk(y)

    walk(state)
    return out


def _np_state(s):
    return jax.tree.map(np.asarray, {
        "step": s.step, "params": s.params,
        "dense_opt_state": _flatten_optax(s.dense_opt_state),
        "sparse_opt_state": s.sparse_opt_state})


def _natural(np_state, v, t=T):
    """A JAX sharded state as numpy (t shards), its row-sharded leaves in
    natural order."""
    def nat(a):
        a = np.asarray(a)
        return np.asarray(jse.from_mod_sharded(jnp.asarray(a), t, v)) if a.ndim == 2 else a

    out = dict(np_state, params=dict(np_state["params"]))
    out["params"]["embed"] = {"table": nat(np_state["params"]["embed"]["table"])}
    if "table" in np_state["params"]["linear"]:
        out["params"]["linear"] = dict(np_state["params"]["linear"],
                                       table=nat(np_state["params"]["linear"]["table"]))
    out["sparse_opt_state"] = jax.tree.map(nat, np_state["sparse_opt_state"])
    return out


def _run_jax(jcfg, batches, use_kernel, eval_batches=()):
    mesh = make_mesh(T)
    jfn = jax_make_fn(use_pallas=True, bt=8, interpret=True) if use_kernel else None
    state = jst.create_sharded_state(jcfg, jax.random.key(0), mesh)
    initial = _np_state(state)  # the step donates its input
    step = jst.make_sharded_train_step(jcfg, mesh, jfn)
    losses = []
    for ids, labels in batches:
        state, m = step(state, jnp.asarray(ids), None, jnp.asarray(labels))
        assert int(m["overflow"]) == 0
        losses.append(float(m["loss"]))
    evals = []
    if eval_batches:
        ev = jst.make_sharded_eval_step(jcfg, mesh, jfn)
        for ids, labels in eval_batches:
            evals.append(jax.tree.map(np.asarray, ev(state, jax_metrics.auc_state_init(),
                                                     jnp.asarray(ids), None,
                                                     jnp.asarray(labels))))
    return initial, _np_state(state), losses, evals


def _run_port(tmp_path, cfg, np_state, batches, use_kernel, eval_batches=()):
    return worker.run(worker.train, tmp_path, T, cfg=cfg, np_state=np_state, batches=batches,
                      use_kernel=use_kernel, eval_batches=eval_batches)


def _gathered(ranks, group, key, v):
    return natural_from_shards([r["state"].params[group][key] for r in ranks], v).numpy()


def _assert_close(initial, want, ranks, cfg, bf16, t=T):
    """The ranks' states against JAX's want from initial (t table shards:
    the first t ranks' shards are gathered)."""
    v = cfg.model.total_vocab
    initial, want = _natural(initial, v, t), _natural(want, v, t)
    dense_tol = dict(rtol=1e-4, atol=1e-5 if bf16 else 1e-6)
    got0 = ranks[0]["state"]
    for r in ranks[1:]:  # dense params stay identical on every rank
        for a, b in zip(train.tree_leaves(train.split_dense_params(got0.params)),
                        train.tree_leaves(train.split_dense_params(r["state"].params))):
            assert torch.equal(a, b)
    for name in ("conv", "tower"):
        for lw, lg in zip(want["params"][name], got0.params[name]):
            for k in lw:
                np.testing.assert_allclose(lg[k].numpy(), lw[k], **dense_tol)
    tables = [("embed", "table")] + ([("linear", "table")]
                                     if "table" in want["params"]["linear"] else [])
    for group, key in tables:
        step_want = want["params"][group][key] - initial["params"][group][key]
        step_got = _gathered(ranks[:t], group, key, v) - initial["params"][group][key]
        np.testing.assert_allclose(step_got, step_want, atol=1e-2 * np.abs(step_want).max())
        untouched = (step_want == 0).all(axis=1)
        np.testing.assert_array_equal(step_got[untouched], 0.0)
    for group, st in want["sparse_opt_state"].items():
        for k, w in st.items():
            if np.ndim(w) == 0:
                assert all(int(r["state"].sparse_opt_state[group][k]) == int(w) for r in ranks)
                continue
            got = natural_from_shards([r["state"].sparse_opt_state[group][k]
                                       for r in ranks[:t]], v)
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-3, atol=1e-3 * np.abs(w).max())


ROUTES = {
    # name: (config kwargs, use_kernel, plain versions the step must reach per step)
    "hybrid_f32": (dict(), True, {"bucketed": 1}),
    "hybrid_bf16": (dict(dtype="bfloat16"), True, {"bucketed": 1, "by_seg": 1}),
    "batch_major_linear": (dict(vocabs=EIGHT), True, {"bucketed": 1}),
    "rowwise_adam": (dict(sparse="rowwise_adam"), True, {"bucketed": 1}),
    "sgd_clip": (dict(sparse="sgd", clip=0.05), True, {"bucketed": 1}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_two_steps_match_jax(tmp_path, route):
    kw, use_kernel, reached = ROUTES[route]
    jcfg, cfg = _cfgs(**kw)
    if route == "batch_major_linear":
        assert not cfg.model.fused_linear and cfg.model.table_width == 128
    # the bucketed update runs in both packages
    router = _make_flat_router(cfg, Mesh(None, 0, T, torch.device("cpu"), False))
    vs, w = router.rows_per_shard, cfg.model.table_width
    assert su.bucketed_tile(vs, w, T, router.capacity) > 0
    assert jax_su.bucketed_tile(vs, w, T, router.capacity) > 0
    batches = [_batch(cfg, seed) for seed in range(2)]
    initial, want, losses, _ = _run_jax(jcfg, batches, use_kernel)
    ranks = _run_port(tmp_path, cfg, initial, batches, use_kernel)
    bf16 = kw.get("dtype") == "bfloat16"
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        assert r["overflows"] == [0, 0]
        assert r["calls"] == {k: 2 * n for k, n in reached.items()}, r["calls"]
    _assert_close(initial, want, ranks, cfg, bf16)

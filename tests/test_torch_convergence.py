"""Many-step quality twins of the JAX package's convergence tests, on the CPU.

- Golden twin (`tests/test_golden_e2e.py`'s config exactly: 6 fields x 128,
  d = 8, conv (16,), tower (32,), B = 512, 500 steps, seed 7): the port's
  `train.run` from JAX's initial state (carried across by `convert`) on
  the same synthetic stream reaches the JAX run's eval AUC and logloss
  within 2e-3, and both runs lie in the JAX test's pinned band.
- Convergence twin (`tests/test_oracle_convergence.py`'s config, 250
  steps): the port and JAX trained from the same init on the same batches
  agree on held-out AUC within 0.005 (the JAX test's bound), both > 0.57.
- The port's own init: `train.run` from its own draw at the golden config
  clears the JAX test's cross-seed floor 0.546 (mean - 3 sd over five
  seeds), and each init leaf's mean and std, pooled over 16 seeds, lie
  within five standard errors of JAX's `init_params` at the same shapes.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu import metrics as jax_metrics
from cffm_tpu import train as jax_train
from cffm_tpu.config import DataConfig as JData
from cffm_tpu.config import ModelConfig as JModel
from cffm_tpu.config import OptimizerConfig as JOpt
from cffm_tpu.config import TrainConfig as JTrain
from cffm_tpu.models.cffm import init_params as jax_init_params
from cffm_tpu_torch import config, metrics, train
from cffm_tpu_torch.convert import state_from_jax
from cffm_tpu_torch.data.synthetic import SyntheticCTR
from cffm_tpu_torch.models import cffm as model_lib
from cffm_tpu_torch.optim.rowwise import tree_leaves
from test_torch_train import _np_state

# tests/test_golden_e2e.py: the seed-7 endpoint and its margin
GOLDEN_AUC, GOLDEN_LOGLOSS, GOLDEN_MARGIN = 0.5827, 0.6731, 0.006
CROSS_SEED_FLOOR = 0.546
GOLDEN_MODEL = dict(num_fields=6, vocab_sizes=(128,) * 6, embed_dim=8, cross="field_aware",
                    conv_channels=(16,), tower_hidden=(32,), compute_dtype="float32",
                    use_pallas=False)


def _golden_cfgs(seed=7):
    data = dict(batch_size=512, num_train_steps=500, eval_batches=8, seed=seed)
    jcfg = JTrain(name="golden", model=JModel(**GOLDEN_MODEL), data=JData(**data),
                  optim=dataclasses.replace(JOpt(), sparse_lr=0.1, dense_lr=3e-3), log_every=0)
    cfg = config.TrainConfig(name="golden", model=config.ModelConfig(**GOLDEN_MODEL),
                             data=config.DataConfig(**data),
                             optim=config.OptimizerConfig(sparse_lr=0.1, dense_lr=3e-3),
                             log_every=0)
    return jcfg, cfg


def _carried(jstate):
    """JAX's TrainState as the port's (numpy in between)."""
    return state_from_jax(_np_state(jstate))


def _in_golden_band(result):
    return (result["auc"] > GOLDEN_AUC - GOLDEN_MARGIN
            and result["logloss"] < GOLDEN_LOGLOSS + GOLDEN_MARGIN)


def test_golden_twin_matches_jax_from_its_init(monkeypatch):
    jcfg, cfg = _golden_cfgs()
    want = jax_train.run(jcfg, log_fn=lambda s: None)
    # train.run draws its state through create_state: hand it JAX's draw
    jstate = jax_train.create_state(jcfg, jax.random.key(jcfg.data.seed))
    monkeypatch.setattr(train, "create_state", lambda cfg, gen: _carried(jstate))
    got = train.run(cfg, device="cpu", log_fn=lambda s: None)
    assert _in_golden_band(want), want
    assert _in_golden_band(got), got
    assert abs(got["auc"] - want["auc"]) < 2e-3, (got, want)
    assert abs(got["logloss"] - want["logloss"]) < 2e-3, (got, want)
    assert got["count"] == want["count"] == 8 * 512


def test_convergence_twin_agrees_with_jax_on_held_out_auc():
    model = dict(num_fields=6, vocab_sizes=(64, 96, 128, 64, 48, 32), embed_dim=8,
                 cross="field_aware", conv_channels=(16,), conv_pool=2, tower_hidden=(32,),
                 compute_dtype="float32", use_pallas=False)
    opt = dict(dense_optimizer="adam", sparse_optimizer="adagrad", dense_lr=1e-3,
               sparse_lr=2e-2)
    jcfg = JTrain(name="oracle_conv", model=JModel(**model), optim=JOpt(**opt),
                  data=JData(batch_size=512))
    cfg = config.TrainConfig(name="oracle_conv", model=config.ModelConfig(**model),
                             optim=config.OptimizerConfig(**opt),
                             data=config.DataConfig(batch_size=512))
    offsets = model_lib.field_offsets(cfg.model)[None, :].astype(np.int32)
    stream = SyntheticCTR(cfg.model, 512, seed=0, stream_seed=1)
    jstate = jax_train.create_state(jcfg, jax.random.key(0))
    state = _carried(jstate)
    for _ in range(250):
        ids, _dense, labels = stream.next_batch()
        gids = (ids + offsets).astype(np.int32)
        jstate, _ = jax_train.train_step(jstate, jnp.asarray(gids), None, jnp.asarray(labels),
                                         jcfg)
        state, _ = train.train_step(state, torch.from_numpy(gids), None,
                                    torch.from_numpy(labels), cfg)
    ids, _dense, labels = SyntheticCTR(cfg.model, 4096, seed=0, stream_seed=104729).next_batch()
    gids = (ids + offsets).astype(np.int32)
    from cffm_tpu.models.cffm import forward as jax_forward

    auc_jax = float(jax_metrics.auc_exact(
        np.asarray(jax_forward(jstate.params, jnp.asarray(gids), None, jcfg.model)), labels))
    with torch.no_grad():
        logits = model_lib.forward(state.params, torch.from_numpy(gids), None, cfg.model)
    auc_port = float(metrics.auc_exact(logits, torch.from_numpy(labels)))
    assert auc_jax > 0.57, auc_jax
    assert auc_port > 0.57, auc_port
    assert abs(auc_jax - auc_port) < 0.005, (auc_jax, auc_port)


def test_own_init_clears_the_cross_seed_floor():
    _, cfg = _golden_cfgs()
    got = train.run(cfg, device="cpu", log_fn=lambda s: None)
    assert got["auc"] > CROSS_SEED_FLOOR, got
    assert math.isfinite(got["logloss"])


INIT_SEEDS = 16


def _leaves_by_name(params, prefix=""):
    if isinstance(params, dict):
        for k, v in params.items():
            yield from _leaves_by_name(v, f"{prefix}{k}.")
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from _leaves_by_name(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(params, np.float64)


@pytest.mark.parametrize("model", ["golden", "criteo_kaggle_narrow"])
def test_own_init_leaf_statistics_match_jax(model):
    mk = dict(GOLDEN_MODEL, use_first_order=True)
    if model != "golden":
        # criteo_kaggle's layers (conv 64, 64; tower 256, 128; 13 dense) at 8 fields
        ck = config.get_config("criteo_kaggle").model
        mk = dict(num_fields=8, vocab_sizes=(64,) * 8, embed_dim=ck.embed_dim,
                  cross=ck.cross, conv_channels=ck.conv_channels, conv_kernel=ck.conv_kernel,
                  tower_hidden=ck.tower_hidden, num_dense=ck.num_dense,
                  compute_dtype="float32")
    jm, pm = JModel(**mk), config.ModelConfig(**mk)
    jax_leaves, port_leaves = {}, {}
    for seed in range(INIT_SEEDS):
        for name, a in _leaves_by_name(jax_init_params(jax.random.key(seed), jm)):
            jax_leaves.setdefault(name, []).append(a.ravel())
        port = model_lib.init_params(pm, torch.Generator().manual_seed(seed))
        for name, a in _leaves_by_name(port):
            port_leaves.setdefault(name, []).append(a.ravel())
    assert sorted(jax_leaves) == sorted(port_leaves)
    assert len(tree_leaves(port)) == len(jax_leaves)
    for name in jax_leaves:
        j, p = np.concatenate(jax_leaves[name]), np.concatenate(port_leaves[name])
        assert j.shape == p.shape, name
        if not j.any():
            assert not p.any(), name  # biases start at zero in both
            continue
        n, sd = j.size, j.std()
        # five standard errors of the difference of two samples of n draws
        assert abs(p.mean() - j.mean()) < 5 * sd * math.sqrt(2 / n), name
        assert abs(p.std() - sd) < 5 * sd / math.sqrt(n), name

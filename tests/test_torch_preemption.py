"""Preemption-safe shutdown in the port (`cffm_tpu_torch.utils.preemption`,
`train.run`), the twin of tests/test_preemption.py: a stop request mid-run
saves a checkpoint at an agreed step, and the resumed run ends exactly as
an uninterrupted control does; the JAX run keeps the same checkpoints.
On 2 gloo ranks a request on one rank stops both at the same step."""

import dataclasses
import os
import signal

import numpy as np
import pytest

import torch_sharded_worker as worker
from cffm_tpu import train as jax_train
from cffm_tpu.config import DataConfig as JData
from cffm_tpu.config import ModelConfig as JModel
from cffm_tpu.config import OptimizerConfig as JOpt
from cffm_tpu.config import TrainConfig as JTrain
from cffm_tpu.utils.preemption import PreemptionGuard as JaxGuard
from cffm_tpu_torch import config, train
from cffm_tpu_torch.utils.preemption import PreemptionGuard


def _cfgs(steps, ckpt_dir=None, sharded=False):
    mk = dict(num_fields=4, vocab_sizes=(64, 64, 64, 64), embed_dim=8, cross="field_aware",
              conv_channels=(8,), tower_hidden=(16,), compute_dtype="float32",
              use_pallas=False)
    dk = dict(batch_size=256, num_train_steps=steps, eval_batches=2, seed=0)
    common = dict(name="preempt_test", checkpoint_dir=ckpt_dir,
                  checkpoint_every=100,  # periodic saves alone would miss step 4
                  log_every=2)           # the guard is checked every log_every steps
    jcfg = JTrain(model=JModel(**mk), data=JData(**dk),
                  optim=JOpt(sparse_optimizer="adagrad"), **common)
    cfg = config.TrainConfig(model=config.ModelConfig(**mk), data=config.DataConfig(**dk),
                             optim=config.OptimizerConfig(sparse_optimizer="adagrad"),
                             sharding=config.ShardingConfig(table_sharded=sharded), **common)
    return jcfg, cfg


def _preempt_and_resume(run, cfg_at, guard_cls, logs):
    """Run with a stop requested as step 4 is logged, then resume."""
    guard = guard_cls(install=False)

    def log(line):
        logs.append(line)
        if '"step": 4,' in line:
            guard.request()

    first = run(cfg_at, log, guard)
    second = run(cfg_at, lambda s: None, guard_cls(install=False))
    return first, second


def test_preempt_saves_and_resume_is_bit_identical(tmp_path):
    jcfg, cfg = _cfgs(8, str(tmp_path / "port"))

    def port_run(c, log, guard):
        return train.run(c, device="cpu", log_fn=log, preemption_guard=guard)

    control = port_run(_cfgs(8)[1], lambda s: None, PreemptionGuard(install=False))
    logs = []
    first, resumed = _preempt_and_resume(port_run, cfg, PreemptionGuard, logs)
    assert first["preempted_at_step"] == 4
    assert any('"preempted_at_step": 4' in line for line in logs)
    assert "preempted_at_step" not in resumed
    for key in ("auc", "logloss", "calibration", "final_train_loss", "count"):
        assert resumed[key] == control[key], key

    # the JAX run keeps the same checkpoints: the stop step, then the end
    jlogs = []
    jfirst, _ = _preempt_and_resume(
        lambda c, log, guard: jax_train.run(c, log_fn=log, preemption_guard=guard),
        dataclasses.replace(jcfg, checkpoint_dir=str(tmp_path / "jax")), JaxGuard, jlogs)
    assert jfirst["preempted_at_step"] == first["preempted_at_step"]
    steps = [sorted(int(n) for n in os.listdir(tmp_path / d) if n.isdigit())
             for d in ("port", "jax")]
    assert steps[0] == steps[1] == [4, 8]


def test_guard_signal_handler_roundtrip():
    """The real SIGTERM path: the handler sets the flag; close() restores."""
    guard = PreemptionGuard()
    if not guard._installed:
        pytest.skip("not the main thread")
    assert not guard.requested
    os.kill(os.getpid(), signal.SIGTERM)
    assert guard.requested
    assert guard.sync()  # one process: no collective
    guard.close()
    assert signal.getsignal(signal.SIGTERM) is not guard._on_signal
    again = PreemptionGuard()
    assert not again.requested
    again.close()


def test_request_on_one_rank_stops_every_rank(tmp_path):
    """2 gloo ranks, the sharded run: rank 1 (which does not log) asks to
    stop at its second check (step 4); both ranks stop there, save one
    checkpoint of 2 shards, and agree on the eval."""
    _, cfg = _cfgs(8, str(tmp_path / "ckpt"), sharded=True)
    (tmp_path / "w").mkdir()
    ranks = worker.run(worker.run_preempted, tmp_path / "w", 2, cfg=cfg, request_rank=1,
                       at_sync=2)
    results = [r["result"] for r in ranks]
    assert [r["preempted_at_step"] for r in results] == [4, 4]
    assert results[0] == results[1]
    assert np.isfinite(results[0]["auc"])
    assert sorted(os.listdir(tmp_path / "ckpt" / "4")) == ["dense.pt", "meta.json",
                                                           "shard00000.pt", "shard00001.pt"]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["4"]

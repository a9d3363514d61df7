"""The port's TensorBoard writer (`utils/tb.py`) and collective probes
(`utils/debugging.py`), the twin of tests/test_observability.py. Event
files are read back with tensorboard's protobuf and the TFRecord framing,
without TensorFlow. The probes: on 4 gloo ranks every rank prints the
tags JAX's sharded step prints (on a 4-device mesh), and the step is
bit-equal with them on and off."""

import dataclasses
import glob
import json
import os
import struct

import jax
import numpy as np
import pytest

import torch_sharded_worker as worker
from cffm_tpu.config import DataConfig as JData
from cffm_tpu.config import ModelConfig as JModel
from cffm_tpu.config import OptimizerConfig as JOpt
from cffm_tpu.config import ShardingConfig as JShard
from cffm_tpu.config import TrainConfig as JTrain
from cffm_tpu.models.cffm import field_offsets
from cffm_tpu.parallel.mesh import make_mesh
from cffm_tpu.parallel.sharded_train import create_sharded_state, make_sharded_train_step
from cffm_tpu_torch import config, train
from cffm_tpu_torch.utils.tb import ScalarWriter

T = 4


def _cfgs(**kw):
    mk = dict(num_fields=4, vocab_sizes=(32, 64, 48, 16), embed_dim=8, cross="hadamard",
              conv_channels=(8,), conv_pool=2, tower_hidden=(16,), compute_dtype="float32",
              use_pallas=False)
    ok = dict(sparse_optimizer="adagrad", dense_optimizer="adam")
    dk = dict(batch_size=128, num_train_steps=3, val_every=0, eval_batches=2)
    jcfg = JTrain(name="test", model=JModel(**mk), optim=JOpt(**ok), data=JData(**dk),
                  sharding=JShard(table_sharded=True), log_every=1, **kw)
    cfg = config.TrainConfig(name="test", model=config.ModelConfig(**mk),
                             optim=config.OptimizerConfig(**ok), data=config.DataConfig(**dk),
                             sharding=config.ShardingConfig(table_sharded=True), log_every=1,
                             **kw)
    return jcfg, cfg


def _events(logdir):
    """{(step, tag): value} of the scalars in logdir's event files."""
    from tensorboard.compat.proto import event_pb2

    seen = {}
    for path in glob.glob(os.path.join(logdir, "events.out.tfevents.*")):
        with open(path, "rb") as f:
            data = f.read()
        i = 0
        while i < len(data):
            # TFRecord: u64 length, u32 crc, payload, u32 crc
            (n,) = struct.unpack("<Q", data[i:i + 8])
            ev = event_pb2.Event.FromString(data[i + 12:i + 12 + n])
            i += 12 + n + 4
            for v in ev.summary.value:
                seen[(ev.step, v.tag)] = v.simple_value
    return seen


def test_scalar_writer_writes_event_files(tmp_path):
    d = str(tmp_path / "tb")
    w = ScalarWriter(d)
    w.scalars(1, {"train/loss": 0.7, "train/examples_per_s": 1000.0})
    w.scalars(2, {"train/loss": 0.6, "skip/str": "not-a-scalar"})
    w.close()
    seen = _events(d)
    assert seen[(1, "train/loss")] == pytest.approx(0.7)
    assert seen[(2, "train/loss")] == pytest.approx(0.6)
    assert seen[(1, "train/examples_per_s")] == 1000.0
    assert not any(tag == "skip/str" for _, tag in seen)


def test_scalar_writer_noop_without_dir_or_off_rank_0(tmp_path):
    for w in (ScalarWriter(None), ScalarWriter(str(tmp_path / "tb"), rank=1)):
        w.scalars(1, {"x": 1.0})  # must not raise
        w.close()
    assert not (tmp_path / "tb").exists()


def test_run_writes_tensorboard(tmp_path):
    """train.run mirrors its JSON scalars into the event files."""
    _, cfg = _cfgs(tensorboard_dir=str(tmp_path / "tb"))
    cfg = dataclasses.replace(cfg, sharding=config.ShardingConfig(table_sharded=False))
    logs = []
    res = train.run(cfg, device="cpu", log_fn=lambda s: logs.append(json.loads(s)))
    seen = _events(str(tmp_path / "tb"))
    losses = [rec["loss"] for rec in logs if "loss" in rec]
    assert [seen[(s, "train/loss")] for s in (1, 2, 3)] == pytest.approx(losses)
    assert (2, "train/examples_per_s") in seen
    assert seen[(3, "eval/auc")] == pytest.approx(res["auc"])


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b = cfg.data.batch_size
    ids = np.stack([rng.integers(0, v, size=b) for v in cfg.model.vocab_sizes],
                   axis=1).astype(np.int32)
    ids += field_offsets(cfg.model)[None, :].astype(np.int32)
    return ids, (rng.random(b) < 0.4).astype(np.float32)


def test_debug_barriers_probe_and_preserve_results(tmp_path, capfd):
    jcfg, cfg = _cfgs()
    ids, labels = _batch(jcfg)
    mesh = make_mesh(T)
    jstate = create_sharded_state(dataclasses.replace(jcfg, debug_barriers=True),
                                  jax.random.key(0), mesh)
    np_state = jax.tree.map(np.asarray, {
        "step": jstate.step, "params": jstate.params,
        "dense_opt_state": {"count": jstate.dense_opt_state[0].count,
                            "mu": jstate.dense_opt_state[0].mu,
                            "nu": jstate.dense_opt_state[0].nu},
        "sparse_opt_state": jstate.sparse_opt_state})
    capfd.readouterr()
    make_sharded_train_step(dataclasses.replace(jcfg, debug_barriers=True), mesh)(
        jstate, ids, None, labels)
    jax.effects_barrier()
    jax_lines = [x for x in capfd.readouterr().out.splitlines() if x.startswith("[collective]")]
    jax_tags = {x.split()[1] for x in jax_lines}
    assert len(jax_tags) == 8

    ranks = worker.run(worker.probed_step, tmp_path, T, cfg=cfg, np_state=np_state,
                       ids=ids, labels=labels)
    for r, out in enumerate(ranks):
        assert out[False]["printed"] == ""
        lines = out[True]["printed"].splitlines()
        assert {x.split()[1] for x in lines} == jax_tags
        assert all(x.endswith(f" shard={r}") for x in lines)
        assert out[True]["loss"] == out[False]["loss"]
        assert (out[True]["table"] == out[False]["table"]).all()

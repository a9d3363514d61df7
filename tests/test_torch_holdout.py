"""The held-out split and the full-pass eval of the port: chunk selection
as in JAX, disjoint train and val rows, val_every=0 reusing the train
stream, and `train.run` with eval_batches=0 on a file evaluating every
held-out row once (the partial tail padded with mask 0), equal to JAX's
run from the same initial state."""

import dataclasses
import json

import jax
import numpy as np
import pytest

import torch_data_files as files
from cffm_tpu import train as jax_train
from cffm_tpu.data.readers import _chunk_selector as jax_chunk_selector
from cffm_tpu_torch import train
from cffm_tpu_torch.checkpoint import CheckpointManager
from cffm_tpu_torch.config import ModelConfig, get_config
from cffm_tpu_torch.convert import state_from_jax
from cffm_tpu_torch.data import native
from cffm_tpu_torch.data.prehash import convert
from cffm_tpu_torch.data.readers import _chunk_selector, criteo_batches, movielens_batches
from cffm_tpu_torch.scripts.bench_input import _write_criteo


@pytest.mark.parametrize("val_every,shards", [(0, 1), (5, 2), (4, 3), (10, 1)])
def test_chunk_selector_bit_equal_jax_and_partitions(val_every, shards):
    n = 100
    takes = {}
    for split in ("train", "val"):
        for shard in range(shards):
            mine = _chunk_selector(split, val_every, shard, shards)
            theirs = jax_chunk_selector(split, val_every, shard, shards)
            takes[split, shard] = {i for i in range(n) if mine(i)}
            assert takes[split, shard] == {i for i in range(n) if theirs(i)}
    for split in ("train", "val"):
        got = [takes[split, s] for s in range(shards)]
        assert sum(map(len, got)) == len(set().union(*got))  # shards disjoint
        assert max(map(len, got)) - min(map(len, got)) <= 1  # and balanced
    val = set().union(*(takes["val", s] for s in range(shards)))
    train_ = set().union(*(takes["train", s] for s in range(shards)))
    if val_every:
        assert len(val) == n // val_every and not (val & train_)
        assert val | train_ == set(range(n))
    else:
        assert val == train_ == set(range(n))  # both streams see every chunk


def _row_keys(batches):
    return {tuple(int(x) for x in r[13:]) for ids, _, _ in batches for r in ids}


def test_criteo_split_disjoint(tmp_path):
    p = str(tmp_path / "c.tsv")
    files.write_criteo_messy(p, seed=7)
    cfg = get_config("criteo_kaggle").model
    kw = dict(repeat=False, val_every=5)
    train_ = _row_keys(criteo_batches(p, cfg, 30, split="train", **kw))
    val = _row_keys(criteo_batches(p, cfg, 30, split="val", **kw))
    every = _row_keys(criteo_batches(p, cfg, 30, repeat=False))
    assert train_ and val and not (train_ & val)
    assert train_ | val == every
    assert len(val) == 60  # chunks 4 and 9 of 10 chunks of 30 rows


def test_movielens_split_disjoint(tmp_path):
    files.write_movielens(tmp_path)
    cfg = ModelConfig(num_fields=7, vocab_sizes=(64, 64, 2, 8, 22, 64, 19), embed_dim=4,
                      conv_channels=(4,), tower_hidden=(8,), use_pallas=False)

    def pairs(split):
        return {(int(a), int(b)) for ids, _, _ in movielens_batches(
            str(tmp_path), cfg, 20, repeat=False, split=split, val_every=10)
            for a, b in ids[:, :2]}

    train_, val = pairs("train"), pairs("val")
    assert len(val) == 40 and len(train_) == 360  # 400 rows, every 10th held out
    assert not (train_ & val)


def test_val_every_zero_reuses_train_stream(tmp_path):
    tsv = str(tmp_path / "c0.tsv")
    _write_criteo(tsv, 512)
    cfg = get_config("criteo_kaggle").model
    tr = list(criteo_batches(tsv, cfg, 128, repeat=False, split="train", val_every=0))
    va = list(criteo_batches(tsv, cfg, 128, repeat=False, split="val", val_every=0))
    assert len(va) == len(tr) == 4
    for a, b in zip(tr, va):
        np.testing.assert_array_equal(a[0], b[0])


def _narrow(path, **data):
    return files.cfg_pair("criteo_kaggle", model=files.NARROW_CRITEO, path=path,
                          dataset="criteo", **data)


@pytest.mark.parametrize("source", ["tsv", "cfb"])
def test_full_pass_eval_counts_every_held_out_row(tmp_path, monkeypatch, source):
    """3000 rows, batches of 256, every 4th chunk (Python reader) or block
    (.cfb) held out: chunks 3, 7 and 11 = 256 + 256 + the 184-row tail,
    which is padded to 256 with mask 0."""
    monkeypatch.setattr(native, "available", lambda: False)
    path = str(tmp_path / "c.tsv")
    _write_criteo(path, 3000)
    if source == "cfb":
        cfb = str(tmp_path / "c.cfb")
        assert convert(path, cfb, get_config("criteo_kaggle").model, "criteo", chunk=500) == 3000
        path = cfb
    _, cfg = _narrow(path, batch_size=256, num_train_steps=2, val_every=4, eval_batches=0)
    res = train.run(cfg, device="cpu", log_fn=lambda s: None)
    assert res["count"] == 696, res
    assert np.isfinite([res["auc"], res["logloss"], res["final_train_loss"]]).all()


def test_full_pass_eval_equals_jax_run(tmp_path):
    """train.run on a written TSV (native multi-threaded route in both,
    2 steps, then one full pass over the val split) from JAX's initial
    state, handed to the port as a step-0 checkpoint: the same rows are
    counted, and AUC, logloss, calibration and the final loss agree to
    1e-5 (f32, reference interaction)."""
    path = str(tmp_path / "c.tsv")
    _write_criteo(path, 12_000)
    jcfg, cfg = _narrow(path, batch_size=1024, num_train_steps=2, val_every=3,
                        eval_batches=0)
    cfg = dataclasses.replace(cfg, log_every=1, checkpoint_dir=str(tmp_path / "ckpt"))
    jstate = jax_train.create_state(jcfg, jax.random.key(jcfg.data.seed))
    mgr = CheckpointManager(cfg.checkpoint_dir)
    mgr.save(0, state_from_jax(files.jax_state_as_numpy(jstate)), cfg, wait=True)
    mgr.close()
    want = jax_train.run(dataclasses.replace(jcfg, log_every=1), log_fn=lambda s: None)
    logs = []
    got = train.run(cfg, device="cpu", log_fn=logs.append)
    assert json.loads(logs[0])["resumed_from_step"] == 0
    assert got["count"] == want["count"] > 1024  # more than one batch
    assert got["count"] % 1024  # and a padded tail
    for key in ("auc", "logloss", "calibration", "final_train_loss"):
        assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-5), key


def test_full_pass_on_a_path_that_matches_nothing_takes_the_window(tmp_path):
    """A data.path that matches no file falls to the endless synthetic
    stream (as in JAX); eval_batches=0 then evaluates the 32-batch window
    instead of a pass that would never end."""
    _, cfg = _narrow(str(tmp_path / "missing.tsv"), batch_size=64, num_train_steps=1,
                     eval_batches=0)
    res = train.run(cfg, device="cpu", log_fn=lambda s: None)
    assert res["count"] == 32 * 64

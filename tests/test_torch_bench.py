"""The port's bench (`cffm_tpu_torch.bench`) on the CPU at a tiny config:
the staged, score and sharded feeds run end to end (sharded on a gloo
group of one, rendezvous through a file in tmp_path), the staged batch is
`bench.py`'s recipe, the reader feeds run from written files, the ladder retries only on
out-of-memory, and without a card `main()` prints its JSON line with an
error and returns nonzero."""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cffm_tpu.config import get_config as jax_get_config
from cffm_tpu.models.cffm import field_offsets as jax_field_offsets
from cffm_tpu_torch import bench, config

MIXED = (32, 64, 128) + (1000,) * 12          # F=15: fused column, 3 small fields


def _tiny(batch=64):
    return config.TrainConfig(
        name="t", model=config.ModelConfig(
            num_fields=15, vocab_sizes=MIXED, embed_dim=16, conv_channels=(16,),
            tower_hidden=(32,), num_dense=3, compute_dtype="float32"),
        data=config.DataConfig(batch_size=batch))


def _bench_py_batch(cfg, batch):
    """bench.py:61-68, with the JAX package's field offsets."""
    rng = np.random.default_rng(0)
    ids_local = np.stack(
        [rng.integers(0, v, size=batch) for v in cfg.model.vocab_sizes], axis=1
    ).astype(np.int32)
    ids = ids_local + jax_field_offsets(cfg.model)[None, :].astype(np.int32)
    dense = rng.normal(size=(batch, cfg.model.num_dense)).astype(np.float32)
    labels = (rng.random(batch) < 0.3).astype(np.float32)
    return ids, dense, labels


def test_staged_batch_is_bench_py_recipe():
    jcfg = jax_get_config("criteo_kaggle")
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, batch_size=512))
    cfg = bench.bench_config("criteo_kaggle", 512)
    assert cfg.model.vocab_sizes == jcfg.model.vocab_sizes
    got = bench.staged_batch(cfg)
    for name, want in zip(("ids", "dense", "labels"), _bench_py_batch(jcfg, 512)):
        assert got[name].dtype == want.dtype
        np.testing.assert_array_equal(got[name], want)


def test_bench_config_overrides():
    cfg = bench.bench_config("criteo_kaggle", 1024, "float32", "rowwise_adam")
    assert cfg.data.batch_size == 1024
    assert cfg.model.table_dtype == "float32"
    assert cfg.optim.sparse_optimizer == "rowwise_adam"
    assert bench.bench_config().model.table_dtype == "bfloat16"


@pytest.mark.parametrize("feed", ["staged", "score"])
def test_feed_runs_on_the_cpu(feed):
    assert bench.run_feed(_tiny(), feed, device="cpu", n=2) > 0


def test_sharded_feed_on_a_gloo_group_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}", rank=0,
                            world_size=1)
    try:
        assert bench.run_feed(_tiny(), "sharded", device="cpu", n=2) > 0
        assert dist.is_initialized()  # the bench leaves a group it did not make
    finally:
        dist.destroy_process_group()


def test_sharded_feed_makes_and_closes_its_own_group():
    """With no default group the feed makes a group of one on a free
    localhost port, and destroys it when done."""
    assert not dist.is_initialized()
    assert bench.run_feed(_tiny(), "sharded", device="cpu", n=1) > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("feed", ["reader", "prehashed"])
def test_reader_feeds_wait_on_the_data_layer(feed):
    """The file feeds run on the CPU at a narrow criteo-shaped config: a
    written TSV (converted to .cfb for prehashed) through the reader, the
    packed wire, device_prefetch and train_step_wire."""
    cfg = dataclasses.replace(bench.bench_config("criteo_kaggle", 64, "float32"),
                              model=config.ModelConfig(
                                  num_fields=39, vocab_sizes=(64,) * 13 + (1000,) * 26,
                                  embed_dim=4, conv_channels=(8,), tower_hidden=(16,),
                                  num_dense=13, compute_dtype="float32"))
    assert bench.run_feed(cfg, feed, device="cpu", n=2) > 0


def test_main_without_a_card_fails_with_its_json_line(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench.main(["--feed=score", "--timeout=60"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1
    assert out["value"] == 0.0 and "no CUDA device" in out["error"]
    assert out["metric"] == "criteo_kaggle_score_examples_per_s_per_chip"
    assert "vs_baseline" not in out


def test_ladder():
    assert bench.ladder(65536) == [65536, 49152, 32768, 16384, 8192, 4096]
    assert bench.ladder(1000) == [1000]
    assert bench.ladder(40000)[:2] == [40000, 32768]


def _fake_card(monkeypatch):
    monkeypatch.setattr(bench, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "NVIDIA H100 80GB HBM3")


def test_ladder_retries_only_on_out_of_memory(capsys, monkeypatch):
    tried = []

    def fake_run(cfg, feed):
        tried.append(cfg.data.batch_size)
        if cfg.data.batch_size > 32768:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return 123.0

    monkeypatch.setattr(bench, "run_feed", fake_run)
    _fake_card(monkeypatch)
    rc = bench.main(["--feed=staged", "--timeout=0"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and tried == [65536, 49152, 32768]
    assert out["value"] == 123.0 and out["batch"] == 32768 and "error" not in out
    assert out["card"].startswith("NVIDIA H100") and out["table_dtype"] == "bfloat16"


def test_other_errors_end_the_ladder(capsys, monkeypatch):
    tried = []

    def fake_run(cfg, feed):
        tried.append(cfg.data.batch_size)
        raise ValueError("broken")

    monkeypatch.setattr(bench, "run_feed", fake_run)
    _fake_card(monkeypatch)
    rc = bench.main(["--feed=sharded", "--timeout=0"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and tried == [65536]
    assert out["error"] == "ValueError: broken" and out["feed"] == "sharded"

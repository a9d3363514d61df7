"""The port's synthetic stream is bit-equal to the JAX package's, its
config copy matches the JAX package's config field for field, and
device_prefetch hands batches over unchanged on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from cffm_tpu import config as jax_config
from cffm_tpu.data.loader import make_dataset as jax_make_dataset
from cffm_tpu_torch import config
from cffm_tpu_torch.data.loader import device_prefetch, make_dataset
from cffm_tpu_torch.data.wire import host_tensor


def _cfgs(num_dense, batch=64, seed=3):
    def build(mod):
        return mod.TrainConfig(
            name="data_test",
            model=mod.ModelConfig(num_fields=5, vocab_sizes=(7, 64, 1000, 3, 50),
                                  num_dense=num_dense),
            data=mod.DataConfig(batch_size=batch, seed=seed))
    return build(jax_config), build(config)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("num_dense", [0, 4])
def test_synthetic_batches_bit_equal_jax(split, num_dense):
    jcfg, cfg = _cfgs(num_dense)
    want = jax_make_dataset(jcfg, split=split, skip_batches=1)
    got = make_dataset(cfg, split=split, skip_batches=1, prefetch=2)
    for _ in range(3):
        a, b = next(got), next(want)
        assert set(a) == set(b) == {"ids", "dense", "labels"}
        for key in ("ids", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
        if num_dense:
            np.testing.assert_array_equal(a.dense, b.dense)
        else:
            assert a.dense is None and b.dense is None


def test_unported_streams_raise(tmp_path):
    """The streams this test once saw refused are taken now, as JAX takes
    them: a data.path that matches no file falls to the synthetic stream,
    and a downsampled train stream equals JAX's."""
    jcfg, cfg = _cfgs(0)
    for data in (dict(path=str(tmp_path / "nonexistent.tsv"), dataset="criteo"),
                 dict(neg_downsample=0.5)):
        j = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, **data))
        t = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data))
        want, got = jax_make_dataset(j, prefetch=0), make_dataset(t, prefetch=0)
        for _ in range(3):
            a, b = next(got), next(want)
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("packed", [False, True])
def test_device_prefetch_on_the_cpu_hands_batches_over_unchanged(packed):
    """On the CPU device_prefetch yields the input as tensors, bit for bit:
    (ids, dense, labels) for raw batches, the wire dict for packed ones."""
    _, cfg = _cfgs(4)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, wire_format="packed" if packed else "raw"))
    host = [b for b, _ in zip(make_dataset(cfg, prefetch=0), range(3))]
    staged = list(device_prefetch(iter(host), "cpu"))
    assert len(staged) == 3
    for b, item in zip(host, staged):
        if packed:
            assert set(item) == set(b.wire)
            for k, v in b.wire.items():
                assert item[k].device.type == "cpu"
                np.testing.assert_array_equal(item[k].numpy(), host_tensor(v).numpy())
                assert item[k].numpy().tobytes() == v.tobytes()
        else:
            for t, a in zip(item, (b.ids, b.dense, b.labels)):
                assert t.device.type == "cpu" and t.dtype == torch.from_numpy(a).dtype
                np.testing.assert_array_equal(t.numpy(), a)


def test_producer_errors_reach_the_consumer(tmp_path):
    """An error on the prefetch thread is raised at the consumer, not
    turned into a quiet end of the stream."""
    p = tmp_path / "c.tsv"
    p.write_text("")
    _, cfg = _cfgs(0)
    cfg = dataclasses.replace(cfg, model=config.get_config("criteo_kaggle").model,
                              data=dataclasses.replace(cfg.data, path=str(p), dataset="criteo"))
    with pytest.raises(ValueError, match="never yield"):
        next(make_dataset(cfg, prefetch=2))


@pytest.mark.parametrize("name", jax_config.list_configs())
def test_named_configs_match_jax(name):
    assert config.list_configs() == jax_config.list_configs()
    want, got = jax_config.get_config(name), config.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("num_pairs", "row_width", "table_width", "fused_linear",
                 "total_vocab", "small_field_prefix", "small_rows", "conv_out_dim"):
        assert getattr(got.model, prop) == getattr(want.model, prop), prop

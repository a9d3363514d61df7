"""The port's synthetic stream is bit-equal to the JAX package's, and its
config copy matches the JAX package's config field for field."""

import dataclasses

import numpy as np
import pytest

from cffm_tpu import config as jax_config
from cffm_tpu.data.loader import make_dataset as jax_make_dataset
from cffm_tpu_torch import config
from cffm_tpu_torch.data.loader import make_dataset


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


def test_unported_streams_raise():
    _, cfg = _cfgs(0)
    with pytest.raises(NotImplementedError, match="data slice"):
        make_dataset(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, path="/nonexistent.tsv")))
    with pytest.raises(NotImplementedError, match="data slice"):
        make_dataset(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, neg_downsample=0.5)))


@pytest.mark.parametrize("name", jax_config.list_configs())
def test_named_configs_match_jax(name):
    assert config.list_configs() == jax_config.list_configs()
    want, got = jax_config.get_config(name), config.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("num_pairs", "row_width", "table_width", "fused_linear",
                 "total_vocab", "small_field_prefix", "small_rows", "conv_out_dim"):
        assert getattr(got.model, prop) == getattr(want.model, prop), prop

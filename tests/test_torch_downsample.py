"""Negative downsampling and the shuffle buffer of the port are the JAX
package's bit for bit, and a downsampled run stays calibrated through
the eval's calibration offset."""

import dataclasses
import math

import numpy as np
import pytest

from cffm_tpu.data.loader import downsampled_batches as jax_downsampled
from cffm_tpu.data.loader import shuffled_batches as jax_shuffled
from cffm_tpu.metrics import calibration_offset as jax_calibration_offset
from cffm_tpu_torch import train
from cffm_tpu_torch.config import get_config
from cffm_tpu_torch.data.loader import downsampled_batches, shuffled_batches
from cffm_tpu_torch.metrics import calibration_offset


def _stream(n_batches, b=128, pos_rate=0.25, dense=True, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        labels = (rng.random(b) < pos_rate).astype(np.float32)
        # ids encode the label, so row alignment is checkable after the filter
        ids = np.stack([labels.astype(np.int32) + 10,
                        rng.integers(0, 50, b).astype(np.int32)], axis=1)
        d = rng.normal(size=(b, 3)).astype(np.float32) if dense else None
        yield ids, d, labels


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("rate", [0.25, 0.5, 0.999999])
def test_downsample_bit_equal_jax(rate, dense):
    want = list(jax_downsampled(_stream(60, dense=dense), rate, seed=1))
    got = list(downsampled_batches(_stream(60, dense=dense), rate, seed=1))
    assert len(got) == len(want) > 0
    for (a, b, c), (x, y, z) in zip(want, got):
        np.testing.assert_array_equal(a, x)
        np.testing.assert_array_equal(c, z)
        assert (b is None) == (y is None) == (not dense)
        if dense:
            np.testing.assert_array_equal(b, y)
        assert len(z) == 128
        np.testing.assert_array_equal(x[:, 0], z.astype(np.int32) + 10)  # rows aligned


def test_downsample_keeps_positives_drops_negatives():
    out = list(downsampled_batches(_stream(200), 0.25, seed=1))
    labels = np.concatenate([o[2] for o in out])
    ratio = (len(labels) - labels.sum()) / labels.sum()
    assert 0.55 < ratio < 1.0, ratio  # 3:1 negatives in the stream, ~0.75:1 kept


@pytest.mark.parametrize("buffer_rows", [1, 64, 256, 1000])
def test_shuffle_buffer_bit_equal_jax(buffer_rows):
    b, nb = 64, 32
    ids = np.arange(b * nb, dtype=np.int32).reshape(-1, 1)
    lab = np.arange(b * nb, dtype=np.float32)
    raw = [(ids[i * b:(i + 1) * b], None, lab[i * b:(i + 1) * b]) for i in range(nb)]
    want = list(jax_shuffled(iter(raw), buffer_rows=buffer_rows, seed=3))
    got = list(shuffled_batches(iter(raw), buffer_rows=buffer_rows, seed=3))
    assert len(got) == len(want) == nb
    for (a, _, c), (x, y, z) in zip(want, got):
        np.testing.assert_array_equal(a, x)
        np.testing.assert_array_equal(c, z)
        assert y is None
    rows = np.concatenate([x[:, 0] for x, _, _ in got])
    np.testing.assert_array_equal(np.sort(rows), ids[:, 0])  # every row once
    assert not np.array_equal(rows, ids[:, 0])  # and reordered


def test_calibration_offset_math():
    cfg = get_config("movielens")
    assert calibration_offset(cfg.data) == 0.0
    d = dataclasses.replace(cfg.data, neg_downsample=0.25)
    assert abs(calibration_offset(d) - math.log(0.25)) < 1e-12
    assert calibration_offset(d) == jax_calibration_offset(d)


def test_downsampled_training_stays_calibrated():
    """Train on a 0.35-downsampled synthetic stream: the corrected eval
    stays calibrated against the true val stream and still ranks."""
    cfg = get_config("movielens")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, use_pallas=False),
        data=dataclasses.replace(cfg.data, dataset="synthetic", batch_size=512,
                                 num_train_steps=150, eval_batches=8, neg_downsample=0.35),
        log_every=1000)
    out = train.run(cfg, device="cpu", log_fn=lambda s: None)
    assert out["auc"] > 0.55, out
    # uncorrected, the calibration would sit near 1 / 0.35
    assert 0.75 < out["calibration"] < 1.3, out

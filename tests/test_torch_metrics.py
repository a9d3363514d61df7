"""The port's metrics vs `cffm_tpu.metrics` on identical numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu import metrics as jax_metrics
from cffm_tpu_torch import metrics


def _logits_labels(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=n) * 3).astype(np.float32)
    labels = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return logits, labels


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_bce_and_logloss_match_jax():
    logits, labels = _logits_labels()
    logits[:3] = [80.0, -80.0, 0.0]  # stable at the extremes
    t, y = torch.from_numpy(logits), torch.from_numpy(labels)
    _close(metrics.sigmoid_bce_with_logits(t, y),
           jax_metrics.sigmoid_bce_with_logits(jnp.asarray(logits), jnp.asarray(labels)))
    _close(metrics.logloss(t, y),
           jax_metrics.logloss(jnp.asarray(logits), jnp.asarray(labels)))


@pytest.mark.parametrize("ties", [False, True])
def test_auc_exact_matches_jax(ties):
    scores, labels = _logits_labels(500, seed=1)
    if ties:
        scores = np.round(scores)  # large tie groups
    got = metrics.auc_exact(torch.from_numpy(scores), torch.from_numpy(labels))
    want = jax_metrics.auc_exact(jnp.asarray(scores), jnp.asarray(labels))
    _close(got, want)
    assert np.isnan(float(metrics.auc_exact(torch.ones(4), torch.ones(4))))


def test_auc_state_update_merge_finalize_match_jax():
    logits, labels = _logits_labels(2048, seed=2)
    mask = (np.arange(2048) < 1900).astype(np.float32)
    halves = [slice(0, 1024), slice(1024, 2048)]
    t_states, j_states = [], []
    for s in halves:
        t_states.append(metrics.auc_state_update(
            metrics.auc_state_init(), torch.from_numpy(logits[s]),
            torch.from_numpy(labels[s]), mask=torch.from_numpy(mask[s])))
        j_states.append(jax_metrics.auc_state_update(
            jax_metrics.auc_state_init(), jnp.asarray(logits[s]),
            jnp.asarray(labels[s]), mask=jnp.asarray(mask[s])))
    t = metrics.auc_state_merge(*t_states)
    j = jax_metrics.auc_state_merge(*j_states)
    for key in ("pos", "neg", "count"):
        np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]))
    _close(t["loss_sum"], j["loss_sum"], rtol=1e-5)
    _close(t["p_sum"], j["p_sum"], rtol=1e-5)
    got = metrics.auc_state_finalize(t)
    want = jax_metrics.auc_state_finalize(j)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])
    assert float(got["count"]) == 1900.0


def test_auc_state_one_class_gives_nan():
    state = metrics.auc_state_update(metrics.auc_state_init(), torch.zeros(8),
                                     torch.zeros(8))
    out = metrics.auc_state_finalize(state)
    assert np.isnan(float(out["auc"])) and np.isnan(float(out["calibration"]))


def test_calibration_offset_matches_jax():
    from cffm_tpu.config import DataConfig as JaxDataConfig
    from cffm_tpu_torch.config import DataConfig

    for r in (1.0, 0.25, 0.0):
        assert metrics.calibration_offset(DataConfig(neg_downsample=r)) == \
            jax_metrics.calibration_offset(JaxDataConfig(neg_downsample=r))

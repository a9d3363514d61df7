"""The port's score (CPU) vs the JAX package's evaluate on the same params
and the same val batches; entry points refuse to fall back to the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu import config as jax_config
from cffm_tpu import train as jax_train
from cffm_tpu.data.loader import make_dataset as jax_make_dataset
from cffm_tpu.models.cffm import init_params as jax_init_params
from cffm_tpu_torch import config, score as score_lib
from cffm_tpu_torch.convert import params_from_jax
from cffm_tpu_torch.ops import interaction_conv as ic
from cffm_tpu_torch.train import TrainState, evaluate

N_BATCHES = 3


def _cfgs():
    def build(mod):
        return mod.TrainConfig(
            name="score_test",
            model=mod.ModelConfig(
                num_fields=15, vocab_sizes=(8,) * 4 + (600,) * 11, embed_dim=16,
                conv_channels=(8,), tower_hidden=(16,), num_dense=2,
                compute_dtype="float32"),
            data=mod.DataConfig(batch_size=32, seed=1))
    return build(jax_config), build(config)


def _jax_side():
    jcfg, cfg = _cfgs()
    params = jax_init_params(jax.random.key(2), jcfg.model)
    state = jax_train.TrainState(step=jnp.int32(0), params=params,
                                 dense_opt_state=None, sparse_opt_state={})
    ds = jax_make_dataset(jcfg, split="val")
    batches = [next(ds) for _ in range(N_BATCHES)]
    want = jax_train.evaluate(state, batches, jcfg,
                              jax_train.default_interaction_fn(jcfg))
    return cfg, params_from_jax(jax.tree.map(np.asarray, params)), batches, want


def test_score_matches_jax_evaluate(tmp_path):
    cfg, params, _, want = _jax_side()
    out = tmp_path / "probs.txt"
    got = score_lib.score(cfg, params, num_batches=N_BATCHES, output=str(out),
                          device="cpu", log_fn=lambda s: None)
    assert got["count"] == want["count"] == N_BATCHES * 32
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=1e-6)
    np.testing.assert_allclose(got["logloss"], want["logloss"], rtol=1e-5)
    np.testing.assert_allclose(got["calibration"], want["calibration"], rtol=1e-5)
    probs = np.loadtxt(out)
    assert probs.shape == (N_BATCHES * 32,) and ((probs > 0) & (probs < 1)).all()


def test_evaluate_matches_jax_evaluate():
    cfg, params, batches, want = _jax_side()
    ic.reset_launches()
    got = evaluate(TrainState(0, params, {}, {}), batches, cfg, ic.make_interaction_fn())
    assert sum(fn.launches for fn in ic.ENTRIES) == 0  # CPU: plain version
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)


def test_score_without_cuda_raises(monkeypatch):
    _, cfg = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        score_lib.score(cfg, {}, num_batches=1, log_fn=lambda s: None)


def test_score_cli_needs_a_checkpoint_it_cannot_restore_yet():
    with pytest.raises(SystemExit, match="checkpoint_dir is required"):
        score_lib.main(["--config=criteo_kaggle"])
    with pytest.raises(SystemExit, match="checkpoint slice"):
        score_lib.main(["--config=criteo_kaggle", "--checkpoint_dir=/x"])
    with pytest.raises(SystemExit, match="unknown config field"):
        score_lib.main(["--config=criteo_kaggle", "--data.bogus=1"])

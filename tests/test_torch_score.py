"""The port's score (CPU) vs the JAX package's evaluate on the same params
and the same val batches; entry points refuse to fall back to the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu import config as jax_config
from cffm_tpu import train as jax_train
from cffm_tpu.data.loader import make_dataset as jax_make_dataset
from cffm_tpu.models.cffm import init_params as jax_init_params
from cffm_tpu_torch import config, score as score_lib, train
from cffm_tpu_torch.cli import _apply_override
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


def test_score_cli_needs_a_checkpoint_it_cannot_restore_yet(tmp_path, capsys):
    """The CLI needs --checkpoint_dir, restores it and scores (the name
    predates the port's checkpoints)."""
    with pytest.raises(SystemExit, match="checkpoint_dir is required"):
        score_lib.main(["--config=criteo_kaggle"])
    with pytest.raises(SystemExit, match="unknown config field"):
        score_lib.main(["--config=criteo_kaggle", "--data.bogus=1"])
    ckpt = str(tmp_path / "ckpt")
    overrides = ["--model.vocab_sizes=8,8,8,8,600,600,600", "--model.num_fields=7",
                 "--model.conv_channels=8", "--model.tower_hidden=16",
                 "--data.batch_size=32", f"--checkpoint_dir={ckpt}"]
    cfg = config.get_config("movielens")
    for item in overrides + ["--data.num_train_steps=2", "--data.eval_batches=1"]:
        cfg = _apply_override(cfg, *item[2:].split("=", 1))
    train.run(cfg, device="cpu", log_fn=lambda s: None)
    capsys.readouterr()
    out = tmp_path / "probs.txt"
    assert score_lib.main(["--config=movielens", "--platform=cpu", "--num_batches=2",
                           f"--output={out}", *overrides]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["step"] == 2 and lines[0]["restored"]["config_name"] == "movielens"
    assert lines[1]["score"]["count"] == 2 * 32
    assert np.loadtxt(out).shape == (2 * 32,)


def test_score_from_checkpoint_matches_jax_score(tmp_path):
    """score() restoring a port checkpoint equals cffm_tpu.score.score
    restoring the JAX checkpoint of the same state, converted across (the
    tolerances of test_score_matches_jax_evaluate)."""
    import dataclasses

    from cffm_tpu.checkpoint import CheckpointManager as JaxManager
    from cffm_tpu.score import score as jax_score
    from cffm_tpu_torch.checkpoint import CheckpointManager
    from cffm_tpu_torch.convert import state_from_jax

    jcfg, cfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, checkpoint_dir=str(tmp_path / "jax"))
    cfg = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / "port"))
    jstate = jax_train.create_state(jcfg, jax.random.key(2))
    mgr = JaxManager(jcfg.checkpoint_dir)
    mgr.save(5, jstate, jcfg, wait=True)
    mgr.close()
    want = jax_score(jcfg, num_batches=N_BATCHES, log_fn=lambda s: None)

    adam = jstate.dense_opt_state[0]
    np_state = jax.tree.map(np.asarray, {
        "step": jstate.step, "params": jstate.params,
        "dense_opt_state": {"count": adam.count, "mu": adam.mu, "nu": adam.nu},
        "sparse_opt_state": jstate.sparse_opt_state})
    mgr = CheckpointManager(cfg.checkpoint_dir)
    mgr.save(5, state_from_jax(np_state), cfg, wait=True)
    mgr.close()
    logs = []
    got = score_lib.score(cfg, num_batches=N_BATCHES, device="cpu", log_fn=logs.append)
    assert json.loads(logs[0]) == {"restored": mgr.restore_meta(), "step": 0}
    assert got["count"] == want["count"] == N_BATCHES * 32
    np.testing.assert_allclose(got["auc"], want["auc"], rtol=1e-6)
    np.testing.assert_allclose(got["logloss"], want["logloss"], rtol=1e-5)
    np.testing.assert_allclose(got["calibration"], want["calibration"], rtol=1e-5)

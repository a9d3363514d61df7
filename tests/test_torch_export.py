"""Serving export of the port (`cffm_tpu_torch.export`), the twin of
tests/test_export.py: the artifact's round trip at several batch sizes
from one trace, dense features, garbage rejected, the command line from
a checkpoint, and the port's `scoring_fn` against JAX's on the same
params (1e-5). The artifact is held to the eager function at JAX's
export tolerance, rtol = atol = 1e-6."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu.config import get_config as jax_get_config
from cffm_tpu.export import scoring_fn as jax_scoring_fn
from cffm_tpu.models.cffm import field_offsets
from cffm_tpu.models.cffm import init_params as jax_init_params
from cffm_tpu_torch import config, train
from cffm_tpu_torch.checkpoint import CheckpointManager
from cffm_tpu_torch.cli import _apply_override
from cffm_tpu_torch.convert import params_from_jax
from cffm_tpu_torch.export import (export_scoring, load_artifact, load_scoring_fn, main,
                                   save_artifact, scoring_fn)

TINY = dict(num_fields=4, vocab_sizes=(32, 64, 48, 40), embed_dim=8, conv_channels=(8,),
            tower_hidden=(16,))


def _cfgs(name="movielens", **model_kw):
    def build(get):
        cfg = get(name)
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, use_pallas=False, **model_kw))
    return build(jax_get_config), build(config.get_config)


def _ids(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    return (np.stack([rng.integers(0, v, size=b) for v in cfg.model.vocab_sizes], axis=1)
            + field_offsets(cfg.model)[None, :]).astype(np.int32)


def _params(jcfg, seed):
    """JAX's init params, as numpy and as the port's tensors."""
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.key(seed), jcfg.model))
    return params, params_from_jax(params)


@pytest.mark.parametrize("batches", [(32, 128), (1, 5)])
def test_export_roundtrip_parity(tmp_path, batches):
    """One artifact serves every batch size (1 included: the trace at 8
    does not pin it)."""
    _, cfg = _cfgs(**TINY)
    state = train.create_state(cfg, torch.Generator().manual_seed(0))
    path = os.path.join(tmp_path, "m.cffm")
    save_artifact(path, export_scoring(cfg, state.params, "cpu"), cfg, step=0, device="cpu")
    meta, _ = load_artifact(path)
    assert meta["config"] == "movielens" and meta["num_dense"] == 0
    assert meta["device"] == "cpu" and meta["torch"] == torch.__version__
    fn = load_scoring_fn(path)
    for b in batches:
        ids = torch.from_numpy(_ids(cfg, b, seed=b))
        got = fn(state.params, ids)
        want = scoring_fn(cfg)(state.params, ids)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        assert got.shape == (b,) and bool(((got > 0) & (got < 1)).all())


def test_export_with_dense_features(tmp_path):
    _, cfg = _cfgs("criteo_kaggle", vocab_sizes=tuple([16] * 13 + [64] * 26), embed_dim=8,
                   conv_channels=(8,), tower_hidden=(16,))
    state = train.create_state(cfg, torch.Generator().manual_seed(1))
    path = os.path.join(tmp_path, "c.cffm")
    save_artifact(path, export_scoring(cfg, state.params, "cpu"), cfg, device="cpu")
    fn = load_scoring_fn(path)
    ids = torch.from_numpy(_ids(cfg, 64))
    dense = torch.from_numpy(np.random.default_rng(2).normal(size=(64, 13)).astype(np.float32))
    torch.testing.assert_close(fn(state.params, ids, dense),
                               scoring_fn(cfg)(state.params, ids, dense), rtol=1e-6, atol=1e-6)


def test_export_rejects_garbage(tmp_path):
    p = os.path.join(tmp_path, "bad.cffm")
    with open(p, "wb") as f:
        f.write(b"not an artifact")
    with pytest.raises(ValueError, match="not a CFFM export"):
        load_artifact(p)


def test_export_cli_with_checkpoint(tmp_path, capsys):
    ckpt = os.path.join(tmp_path, "ckpt")
    overrides = ["--model.vocab_sizes=32,64,48,40,16,8,24", "--model.conv_channels=8",
                 "--model.tower_hidden=16", "--model.use_pallas=False"]
    cfg = config.get_config("movielens")
    for item in overrides:
        cfg = _apply_override(cfg, *item[2:].split("=", 1))
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=128, num_train_steps=3,
                                      eval_batches=1),
        checkpoint_dir=ckpt, checkpoint_every=0, log_every=100)
    train.run(cfg, device="cpu", log_fn=lambda s: None)
    capsys.readouterr()

    out = os.path.join(tmp_path, "m.cffm")
    with pytest.raises(SystemExit, match="names one device"):
        main(["--config=movielens", f"--out={out}", "--platforms=cuda,cpu"])
    rc = main(["--config=movielens", f"--out={out}", "--platforms=cpu",
               f"--checkpoint_dir={ckpt}", *overrides])
    assert rc == 0 and os.path.exists(out)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["step"] == 3 and line["bytes"] < 1 << 20  # the params are not in it
    meta, _ = load_artifact(out)
    assert meta["step"] == 3
    mgr = CheckpointManager(ckpt)
    state, _ = mgr.restore_auto(train.create_state(cfg, torch.Generator()), cfg, 1)
    mgr.close()
    ids = torch.from_numpy(_ids(cfg, 16))
    probs = load_scoring_fn(out)(state.params, ids)
    torch.testing.assert_close(probs, scoring_fn(cfg)(state.params, ids), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["movielens", "criteo_kaggle"])
def test_scoring_fn_matches_jax(name):
    kw = dict(TINY) if name == "movielens" else dict(
        vocab_sizes=tuple([16] * 13 + [64] * 26), embed_dim=8, conv_channels=(8,),
        tower_hidden=(16,))
    jcfg, cfg = _cfgs(name, **kw)
    np_params, params = _params(jcfg, 3)
    ids = _ids(cfg, 48, seed=4)
    args, jargs = (torch.from_numpy(ids),), (jnp.asarray(ids),)
    if cfg.model.num_dense:
        dense = np.random.default_rng(5).normal(size=(48, cfg.model.num_dense))
        args += (torch.from_numpy(dense.astype(np.float32)),)
        jargs += (jnp.asarray(dense, jnp.float32),)
    want = np.asarray(jax_scoring_fn(jcfg)(np_params, *jargs))
    np.testing.assert_allclose(scoring_fn(cfg)(params, *args).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_export_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config=movielens", f"--out={tmp_path / 'm.cffm'}"])

"""The port's sharded step on 4 gloo processes vs its own single-device
train_step; its sharded eval vs `cffm_tpu.parallel.sharded_train.
make_sharded_eval_step` on a 4-device mesh, with and without id overflow
(helpers and tolerances: test_torch_sharded_train.py); and `train.run`
on the sharded path.

The AUC states: count exact, loss_sum and p_sum rtol 1e-5, and at most
two examples in another histogram bin (a logit on a bin edge may fall
either side).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_worker as worker

from cffm_tpu import metrics as jax_metrics
from cffm_tpu.models.cffm import field_offsets
from cffm_tpu.parallel import sharded_train as jst
from cffm_tpu.parallel.mesh import make_mesh
from cffm_tpu_torch import config, train
from cffm_tpu_torch.convert import natural_from_shards, state_from_jax
from cffm_tpu_torch.ops.interaction_conv import make_interaction_fn
from test_torch_sharded_train import (T, _batch, _cfgs, _gathered, _natural, _np_state,
                                      _run_jax, _run_port)


def test_sharded_step_equals_single_device_step_and_eval_matches_jax(tmp_path):
    """Hybrid adagrad, f32: the 4-rank step against the port's own
    single-device train_step from the same natural-layout state, then one
    sharded eval batch against JAX's (no overflow)."""
    jcfg, cfg = _cfgs()
    batches = [_batch(cfg, seed) for seed in range(2)]
    evals = [_batch(cfg, 100)]
    initial, want, losses, jevals = _run_jax(jcfg, batches, True, evals)
    ranks = _run_port(tmp_path, cfg, initial, batches, True, evals)
    v = cfg.model.total_vocab

    single = state_from_jax(_natural(initial, v))
    fn = make_interaction_fn()
    for (ids, labels), loss in zip(batches, ranks[0]["losses"]):
        single, m = train.train_step(single, torch.from_numpy(ids), None,
                                     torch.from_numpy(labels), cfg, fn)
        np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-5)
    for a, b in zip(train.tree_leaves(train.split_dense_params(single.params)),
                    train.tree_leaves(train.split_dense_params(ranks[0]["state"].params))):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-6)
    start = _natural(initial, v)["params"]["embed"]["table"]
    step_single = single.params["embed"]["table"].numpy() - start
    step_sharded = _gathered(ranks, "embed", "table", v) - start
    np.testing.assert_allclose(step_sharded, step_single, atol=1e-2 * np.abs(step_single).max())
    np.testing.assert_allclose(
        natural_from_shards([r["state"].sparse_opt_state["embed"]["accum"] for r in ranks],
                            v).numpy(),
        single.sparse_opt_state["embed"]["accum"].numpy(), rtol=1e-3, atol=1e-5)

    (auc, overflow), = ranks[0]["evals"]
    assert overflow == 0
    _assert_auc_close(auc, jevals[0])


def _assert_auc_close(got, want):
    assert float(got["count"]) == float(want["count"])
    np.testing.assert_allclose(got["loss_sum"], want["loss_sum"], rtol=1e-5)
    np.testing.assert_allclose(got["p_sum"], want["p_sum"], rtol=1e-5)
    # a logit on a bin edge may fall either side
    assert np.abs(got["pos"] - want["pos"]).sum() <= 2
    assert np.abs(got["neg"] - want["neg"]).sum() <= 2


def test_sharded_eval_reports_overflow(tmp_path):
    """Capacity forced to 128 rows per peer: the port's eval returns the
    group's count of dropped distinct ids (JAX's drops it) and scores them
    as zero rows, as JAX does."""
    jcfg, cfg = _cfgs(cap_rows=128)
    rng = np.random.default_rng(7)
    b = cfg.data.batch_size
    ids = np.stack([rng.integers(0, v, size=b) for v in cfg.model.vocab_sizes], axis=1)
    ids = (ids + field_offsets(cfg.model)[None, :]).astype(np.int32)
    labels = (rng.random(b) < 0.4).astype(np.float32)
    expected = 0
    for r in range(T):  # distinct ids per (rank, owner) beyond the capacity
        mine = np.unique(ids[r * b // T:(r + 1) * b // T])
        expected += int(np.maximum(np.bincount(mine % T, minlength=T) - 128, 0).sum())
    assert expected > 0

    mesh = make_mesh(T)
    state = jst.create_sharded_state(jcfg, jax.random.key(0), mesh)
    np_state = _np_state(state)
    want = jax.tree.map(np.asarray, jst.make_sharded_eval_step(jcfg, mesh, None)(
        state, jax_metrics.auc_state_init(), jnp.asarray(ids), None, jnp.asarray(labels)))
    ranks = _run_port(tmp_path, cfg, np_state, [], False, [(ids, labels)])
    for r in ranks:
        (auc, overflow), = r["evals"]
        assert overflow == expected
        _assert_auc_close(auc, want)


def test_run_takes_the_sharded_path_in_a_group(tmp_path):
    """train.run on 2 gloo ranks with table_sharded: each rank trains on its
    half of every batch, the eval counts the whole group's examples, and
    only rank 0 logs."""
    cfg = config.get_config("movielens")
    cfg = dataclasses.replace(
        cfg, log_every=1, sharding=dataclasses.replace(cfg.sharding, table_sharded=True),
        data=dataclasses.replace(cfg.data, batch_size=128, num_train_steps=3, eval_batches=2))
    ranks = worker.run(worker.run_train, tmp_path, 2, cfg=cfg)
    for r in ranks:
        res = r["result"]
        assert res["count"] == 2 * 128
        assert np.isfinite([res["auc"], res["logloss"], res["final_train_loss"]]).all()
        assert res == ranks[0]["result"]
    steps = [json.loads(x) for x in ranks[0]["logs"] if '"step"' in x]
    assert [s["step"] for s in steps] == [1, 2, 3]
    assert all(s["id_overflow"] == 0 for s in steps)
    assert ranks[1]["logs"] == []


@pytest.mark.parametrize("axis", ["hier", "intra_host"])
def test_run_refuses_the_exchanges_of_the_next_slice(axis, monkeypatch):
    """The hierarchical and intra-host engines now run (tests/test_torch_hier.py);
    what train.run still refuses on them is a group that is no whole number
    of hosts: 2 ranks of 4-card hosts, raised before any rendezvous."""
    cfg = config.get_config("movielens")
    cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(
        cfg.sharding, table_sharded=True, table_axis=axis))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="whole number of hosts"):
        train.run(cfg, device="cpu")


def test_two_rank_full_pass_eval_equals_one_rank(tmp_path):
    """A full-pass eval on 2 gloo ranks whose val splits are uneven (rank
    0 holds two of the three held-out chunks, so rank 1 feeds all-masked
    batches to keep the collectives in step) equals the one-rank eval of
    the same params over the whole split; and train.run on the 2 ranks
    with eval_batches=0 counts every held-out row once."""
    import torch_data_files as files
    from cffm_tpu_torch.metrics import auc_state_finalize, auc_state_init
    from cffm_tpu_torch.scripts.bench_input import _write_criteo

    path = str(tmp_path / "c.tsv")
    _write_criteo(path, 3000)
    _, one = files.cfg_pair("criteo_kaggle", model=files.NARROW_CRITEO, path=path,
                            dataset="criteo", batch_size=128, val_every=4, eval_batches=0,
                            reader_threads=1, num_train_steps=1)
    two = dataclasses.replace(one, data=dataclasses.replace(one.data, batch_size=256),
                              sharding=dataclasses.replace(one.sharding, table_sharded=True))
    state = train.create_state(one, torch.Generator().manual_seed(0))

    def eval_fn(auc_state, ids, dense, labels, mask=None):
        return train.eval_step(state, auc_state, ids, dense, labels, one, mask=mask)

    want = auc_state_finalize(train._full_pass_eval(one, eval_fn, auc_state_init(), 0, 1,
                                                    torch.device("cpu")))
    ranks = worker.run(worker.full_pass, tmp_path, 2, cfg=two, params=state.params,
                       run_cfg=dataclasses.replace(two, log_every=0))
    rows = [r["rows"] for r in ranks]
    assert len(rows[0]) == len(rows[1]) and sum(rows[0]) > sum(rows[1]) > 0
    assert rows[1][-1] == 0  # rank 1 ran out first and fed an all-masked batch
    for r in ranks:
        got = auc_state_finalize(r["auc"])
        assert float(got["count"]) == float(want["count"]) == sum(map(sum, rows))
        for key in ("auc", "logloss", "calibration"):
            assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5), key
        assert r["result"]["count"] == float(want["count"])
        assert np.isfinite(r["result"]["auc"])

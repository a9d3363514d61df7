"""The port's checkpoints (`cffm_tpu_torch.checkpoint`), the twin of
tests/test_checkpoint.py: a bit-equal round trip and further step; the
table resharding against JAX's `reshard_tables`; restore across shard
counts on gloo groups (`tests/torch_sharded_worker.py`); the commit, the
retention and the vocabulary check; and JAX checkpoints carried across
(`cffm_tpu.checkpoint` restored on the JAX side, then
`convert.state_from_jax` / `sharded_state_from_jax`) and continued.

The model is the JAX tests' tiny one (4 fields, d=8, C1=8, f32, the
reference interaction). The vocabulary (161 rows) pads differently for
2, 4 and 8 shards. Tolerances of a port step against a JAX step are
test_torch_train.py's: loss rtol 1e-5, dense params rtol 1e-5 atol 1e-6,
table steps atol 1e-2 of the largest step, sparse state rtol 1e-3 with
atol 1e-3 of its largest entry. Port against port: bit-equal, except the
loss of a 2-rank step against the single-device step (rtol 2e-5, as
tests/test_checkpoint.py holds JAX's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_worker as worker
from cffm_tpu import checkpoint as jax_ckpt
from cffm_tpu import train as jax_train
from cffm_tpu.config import DataConfig as JData
from cffm_tpu.config import ModelConfig as JModel
from cffm_tpu.config import OptimizerConfig as JOpt
from cffm_tpu.config import ShardingConfig as JShard
from cffm_tpu.config import TrainConfig as JTrain
from cffm_tpu.models.cffm import field_offsets
from cffm_tpu.parallel import sharded_embedding as jse
from cffm_tpu.parallel import sharded_train as jst
from cffm_tpu.parallel.mesh import make_mesh
from cffm_tpu_torch import checkpoint, config, train
from cffm_tpu_torch.convert import natural_from_shards, state_from_jax

VOCABS = (32, 64, 48, 17)
V = sum(VOCABS)


def _cfgs(sparse="adagrad", sharded=False):
    mk = dict(num_fields=4, vocab_sizes=VOCABS, embed_dim=8, cross="field_aware",
              conv_channels=(8,), tower_hidden=(16,), compute_dtype="float32",
              use_pallas=False)
    ok = dict(sparse_optimizer=sparse, dense_optimizer="adam")
    jcfg = JTrain(name="ckpt_test", model=JModel(**mk), optim=JOpt(**ok),
                  data=JData(batch_size=64), sharding=JShard(table_sharded=sharded))
    cfg = config.TrainConfig(name="ckpt_test", model=config.ModelConfig(**mk),
                             optim=config.OptimizerConfig(**ok),
                             data=config.DataConfig(batch_size=64),
                             sharding=config.ShardingConfig(table_sharded=sharded))
    return jcfg, cfg


def _batch(seed, b=64):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, v, size=b) for v in VOCABS], axis=1).astype(np.int32)
    ids += field_offsets(_cfgs()[0].model)[None, :].astype(np.int32)
    return ids, (rng.random(b) < 0.4).astype(np.float32)


def _flatten_optax(state):
    out = {}

    def walk(x):
        if hasattr(x, "mu"):
            out.update(count=x.count, mu=x.mu, nu=x.nu)
        elif isinstance(x, tuple):
            for y in x:
                walk(y)

    walk(state)
    return out


def _np_state(s):
    return jax.tree.map(np.asarray, {
        "step": s.step, "params": s.params,
        "dense_opt_state": _flatten_optax(s.dense_opt_state),
        "sparse_opt_state": s.sparse_opt_state})


def _jax_state(jcfg, steps=1, seed=0):
    state = jax_train.create_state(jcfg, jax.random.key(seed))
    for s in range(steps):
        ids, labels = _batch(100 + s)
        state, _ = jax_train.train_step(state, jnp.asarray(ids), None, jnp.asarray(labels),
                                        jcfg)
    return state


def _port_step(state, cfg, seed):
    ids, labels = (torch.from_numpy(a) for a in _batch(seed))
    return train.train_step(state, ids, None, labels, cfg)


def _assert_bit_equal(a, b):
    fa, fb = checkpoint.state_leaves(a), checkpoint.state_leaves(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and fa[k].device == fb[k].device, k
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def _clone(state):
    return checkpoint._state_from_flat(state, checkpoint.state_leaves(state))


@pytest.mark.parametrize("sparse", ["adagrad", "rowwise_adam"])
def test_save_restore_roundtrip_and_further_step(tmp_path, sparse):
    _, cfg = _cfgs(sparse)
    state = train.create_state(cfg, torch.Generator().manual_seed(0))
    for s in range(2):
        state, _ = _port_step(state, cfg, s)
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    assert mgr.save(2, state, cfg, wait=True)
    assert mgr.latest_step() == 2
    template = train.create_state(cfg, torch.Generator().manual_seed(99))
    restored, meta = mgr.restore(template)
    mgr.close()
    assert meta == {"config_name": "ckpt_test", "num_table_shards": 1, "total_vocab": V,
                    "table_width": cfg.model.table_width}
    _assert_bit_equal(restored, state)
    assert restored.dense_opt_state["count"].device.type == "cpu"  # as convert.py keeps it
    a, m_a = _port_step(_clone(state), cfg, 5)
    b, m_b = _port_step(restored, cfg, 5)
    assert torch.equal(m_a["loss"], m_b["loss"])
    _assert_bit_equal(a, b)


@pytest.mark.parametrize("sparse", ["adagrad", "adam", "rowwise_adam"])
def test_reshard_tables_matches_jax(sparse):
    """1 -> 4 -> 8 -> 1 shards: each layout bit-equal to JAX's
    reshard_tables on the same state, and back to the natural table."""
    jcfg, cfg = _cfgs(sparse)
    jstate = _jax_state(jcfg)
    state = state_from_jax(_np_state(jstate))
    j, p = jstate, state
    for a, b in ((1, 4), (4, 8), (8, 1)):
        j = jax_ckpt.reshard_tables(j, jcfg, a, b)
        p = checkpoint.reshard_tables(p, cfg, a, b)
        want = _np_state(j)
        np.testing.assert_array_equal(p.params["embed"]["table"].numpy(),
                                      want["params"]["embed"]["table"])
        for k, v in p.sparse_opt_state["embed"].items():
            np.testing.assert_array_equal(v.numpy(), want["sparse_opt_state"]["embed"][k])
    _assert_bit_equal(p, state)


def test_restore_auto_across_shard_counts(tmp_path):
    """4 gloo ranks step and save; 2 ranks and a single device restore.
    The natural tables and per-row state equal the saved ones; the 2-rank
    step's loss matches the single-device step's (rtol 2e-5)."""
    jcfg, cfg = _cfgs(sharded=True)
    jstate = jst.create_sharded_state(jcfg, jax.random.key(0), make_mesh(4))
    np_state = _np_state(jstate)
    ckpt = str(tmp_path / "ckpt")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    four = worker.run(worker.ckpt_cycle, tmp_path / "a", 4, cfg=cfg, ckpt_dir=ckpt,
                      np_state=np_state, save_batches=[_batch(1)])
    two = worker.run(worker.ckpt_cycle, tmp_path / "b", 2, cfg=cfg, ckpt_dir=ckpt,
                     restore_batches=[_batch(2)])
    saved_table = natural_from_shards([r["saved"].params["embed"]["table"] for r in four], V)
    saved_accum = natural_from_shards(
        [r["saved"].sparse_opt_state["embed"]["accum"] for r in four], V)
    for group in (four, two):
        assert all(r["meta"]["num_table_shards"] == 4 for r in group)
        assert all(r["restored"]["step"] == 1 for r in group)
        assert torch.equal(natural_from_shards([r["restored"]["table"] for r in group], V),
                           saved_table)
        assert torch.equal(natural_from_shards(
            [r["restored"]["sparse"]["accum"] for r in group], V), saved_accum)

    mgr = checkpoint.CheckpointManager(ckpt)
    single, meta = mgr.restore_auto(train.create_state(_cfgs()[1], torch.Generator()),
                                    _cfgs()[1], num_shards=1)
    assert meta["num_table_shards"] == 4 and single.step == 1
    assert torch.equal(single.params["embed"]["table"], saved_table)
    assert torch.equal(single.sparse_opt_state["embed"]["accum"], saved_accum)
    _, m = _port_step(single, _cfgs()[1], 2)
    assert two[0]["losses"] == two[1]["losses"]
    np.testing.assert_allclose(two[0]["losses"][0], float(m["loss"]), rtol=2e-5)


def test_partial_step_is_ignored(tmp_path, monkeypatch):
    """A step whose write failed, or was cut, is never the latest one."""
    _, cfg = _cfgs()
    state = train.create_state(cfg, torch.Generator().manual_seed(0))
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(1, state, cfg, wait=True)
    (tmp_path / "7.partial").mkdir()
    (tmp_path / "7.partial" / "dense.pt").write_bytes(b"cut short")

    def fail(path, obj):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "_write", fail)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, state, cfg, wait=True)
    assert mgr.latest_step() == 1 and mgr.all_steps() == [1]
    restored, _ = mgr.restore(train.create_state(cfg, torch.Generator().manual_seed(5)))
    assert restored.step == 0 and torch.equal(restored.params["embed"]["table"],
                                              state.params["embed"]["table"])


def test_max_to_keep_and_older_steps(tmp_path):
    _, cfg = _cfgs()
    state = train.create_state(cfg, torch.Generator().manual_seed(0))
    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        assert mgr.save(step, state, cfg)  # committed by the next save
    mgr.close()
    assert mgr.all_steps() == [2, 3]
    assert not mgr.save(3, state, cfg, wait=True)  # not newer: skipped, as orbax does
    assert sorted(p.name for p in tmp_path.iterdir()) == ["2", "3"]


def test_wrong_total_vocab_raises(tmp_path):
    _, cfg = _cfgs()
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(1, train.create_state(cfg, torch.Generator()), cfg, wait=True)
    other = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, vocab_sizes=(32, 64, 48, 18)))
    with pytest.raises(ValueError, match="total_vocab"):
        mgr.restore_auto(train.create_state(other, torch.Generator()), other, 1)


def _assert_step_like_jax(p_state, p_loss, j_state, j_loss, initial):
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=1e-5)
    want = _np_state(j_state)
    for got, exp in zip(train.tree_leaves(train.split_dense_params(p_state.params)),
                        jax.tree.leaves(jax.tree.map(np.asarray, {
                            "conv": want["params"]["conv"], "tower": want["params"]["tower"],
                            "linear_bias": want["params"]["linear"]["bias"]}))):
        np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-6)
    delta = want["params"]["embed"]["table"] - initial
    np.testing.assert_allclose(p_state.params["embed"]["table"].numpy() - initial, delta,
                               atol=1e-2 * np.abs(delta).max())
    acc = want["sparse_opt_state"]["embed"]["accum"]
    np.testing.assert_allclose(p_state.sparse_opt_state["embed"]["accum"].numpy(), acc,
                               rtol=1e-3, atol=1e-3 * np.abs(acc).max())


def test_jax_checkpoint_carried_across_and_continued(tmp_path):
    """A JAX state saved by cffm_tpu.checkpoint, restored on the JAX side,
    converted, round-tripped through the port's manager and stepped once
    matches JAX's step from the restored state."""
    jcfg, cfg = _cfgs()
    jmgr = jax_ckpt.CheckpointManager(str(tmp_path / "jax"))
    jmgr.save(1, _jax_state(jcfg), jcfg, wait=True)
    jrestored, _ = jmgr.restore(jax_train.create_state(jcfg, jax.random.key(9)))
    jmgr.close()
    np_state = _np_state(jrestored)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "port"))
    mgr.save(1, state_from_jax(np_state), cfg, wait=True)
    state, _ = mgr.restore(train.create_state(cfg, torch.Generator().manual_seed(9)))
    mgr.close()
    assert state.step == 1
    ids, labels = _batch(7)
    jstate, jm = jax_train.train_step(jrestored, jnp.asarray(ids), None,
                                      jnp.asarray(labels), jcfg)
    state, m = _port_step(state, cfg, 7)
    _assert_step_like_jax(state, m["loss"], jstate, jm["loss"],
                          np_state["params"]["embed"]["table"])


def test_jax_sharded_checkpoint_carried_across_and_continued(tmp_path):
    """The same for a JAX sharded state on 4 devices: restored on the JAX
    side, each gloo rank's share saved by the port (4 shards), restored
    onto 4 ranks and stepped once, against JAX's sharded step."""
    jcfg, cfg = _cfgs(sharded=True)
    mesh = make_mesh(4)
    jmgr = jax_ckpt.CheckpointManager(str(tmp_path / "jax"))
    jmgr.save(0, jst.create_sharded_state(jcfg, jax.random.key(0), mesh), jcfg,
              num_shards=4, wait=True)
    template = jst.create_sharded_state(jcfg, jax.random.key(9), mesh)
    jrestored, _ = jmgr.restore_auto(template, jcfg, num_shards=4)
    jmgr.close()
    np_state = _np_state(jrestored)
    initial = np.asarray(jse.from_mod_sharded(
        jnp.asarray(np_state["params"]["embed"]["table"]), 4, V))
    (tmp_path / "w").mkdir()
    ids, labels = _batch(3)
    ranks = worker.run(worker.ckpt_cycle, tmp_path / "w", 4, cfg=cfg,
                       ckpt_dir=str(tmp_path / "port"), np_state=np_state,
                       restore_batches=[(ids, labels)])
    jstate, jm = jst.make_sharded_train_step(jcfg, mesh)(jrestored, jnp.asarray(ids), None,
                                                         jnp.asarray(labels))
    want = _np_state(jstate)
    np.testing.assert_allclose(ranks[0]["losses"][0], float(jm["loss"]), rtol=1e-5)
    got = natural_from_shards([r["state"].params["embed"]["table"] for r in ranks], V)
    delta = np.asarray(jse.from_mod_sharded(
        jnp.asarray(want["params"]["embed"]["table"]), 4, V)) - initial
    np.testing.assert_allclose(got.numpy() - initial, delta, atol=1e-2 * np.abs(delta).max())
    for r in ranks:
        for got, exp in zip(train.tree_leaves(train.split_dense_params(r["state"].params)),
                            jax.tree.leaves({"conv": want["params"]["conv"],
                                             "tower": want["params"]["tower"],
                                             "linear_bias": want["params"]["linear"]["bias"]})):
            np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """4 gloo ranks as 2 hosts of 2 cards (`worker.grid_ckpt`): a hier
    save restored into the flat engine and back, and an intra-host save
    under 2 shards restored on every rank."""
    _, cfg = _cfgs(sharded=True)
    out = tmp_path_factory.mktemp("grid")
    return worker.run(worker.grid_ckpt, out, 4, num_hosts=2, cfg=cfg, cfg_2d=cfg,
                      ckpt_dir=str(out / "ckpt"), batches=[_batch(s) for s in (1, 2, 3)])


def test_hier_checkpoint_restores_into_flat_and_back(grid):
    """The twin of tests/test_hier_checkpoint.py: the hier state is the
    flat state, so a hier checkpoint restores into the flat engine bit for
    bit, and the flat step from it matches the hier step from the saved
    state (JAX's tolerances there); the flat engine's next save restores
    into a hier state bit for bit."""
    for r in grid:
        assert r["hier_meta"]["num_table_shards"] == 4
        for k in ("table", "accum"):
            assert torch.equal(r["flat_restored"][k], r["hier_saved"][k])
            assert torch.equal(r["hier_restored"][k], r["flat_next"][k])
        assert r["flat_restored"]["step"] == 2 and r["hier_restored"]["step"] == 3
        np.testing.assert_allclose(*r["losses_next"], rtol=1e-6)
        np.testing.assert_allclose(r["flat_next"]["table"].numpy(),
                                   r["hier_next"]["table"].numpy(), rtol=1e-5, atol=1e-6)


def test_2d_checkpoint_saved_on_two_hosts_restores_on_every_rank(grid):
    """An intra-host state (tables over 2 chips, replicated on 2 hosts)
    saves 2 shard files, host 0's; rank h*2 + c restores shard c, and the
    same files reshard onto the 4-rank flat layout."""
    _, cfg = _cfgs(sharded=True)
    v = cfg.model.total_vocab
    assert grid[0]["2d_files"] == ["dense.pt", "meta.json", "shard00000.pt", "shard00001.pt"]
    for r in grid:
        assert r["2d_meta"]["num_table_shards"] == 2 and r["2d_restored"]["step"] == 2
        for k in ("table", "accum"):
            assert torch.equal(r["2d_restored"][k], r["2d_saved"][k])
    for k in ("table", "accum"):
        saved = natural_from_shards([r["2d_saved"][k] for r in grid[:2]], v)
        assert torch.equal(natural_from_shards([r["2d_as_flat"][k] for r in grid], v), saved)

"""The port's scaling scripts on the CPU against the JAX package's:
`cffm_tpu_torch.scripts.measure_id_stats` against `scripts/measure_id_stats.py`
on the same synthetic stream (every number of JAX's equal, the
hierarchical capacities added), and `cffm_tpu_torch.scripts.bench_scaling`
on 4 gloo ranks as 2 hosts of 2: the single-card, flat and hier steps
from one state on the script's batch, each first loss against JAX's
single-device train_step there (rtol 1e-5). Nothing here is a time of
the card."""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_sharded_worker as worker
from cffm_tpu import config as jax_config
from cffm_tpu import train as jax_train
from cffm_tpu_torch import config
from cffm_tpu_torch.parallel.hier_embedding import pick_capacities_hier
from cffm_tpu_torch.scripts import bench_scaling, measure_id_stats
from test_torch_sharded_train import _cfgs, _flatten_optax

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["criteo_full", "multihost"])
def test_measure_id_stats_matches_jax(name):
    topologies = [(1, 1), (1, 8), (2, 8), (2, 4), (2, 2)]
    want = _jax_script("measure_id_stats").measure(jax_config.get_config(name), 2048, 2,
                                                    topologies)
    cfg = config.get_config(name)
    got = measure_id_stats.measure(cfg, 2048, 2, topologies)
    assert got["head_overlap"] == want["head_overlap"]
    assert got["head_overlap_topology"] == want["head_overlap_topology"]
    assert list(got["topologies"]) == list(want["topologies"])
    for topo, w in want["topologies"].items():
        g = got["topologies"][topo]
        assert {k: g[k] for k in w} == w, topo
        if "hier_cap1" in g:
            h, c = (int(x) for x in topo.split("x"))
            s = cfg.sharding
            v_pad = -(-cfg.model.total_vocab // (h * c)) * (h * c)
            assert (g["hier_cap1"], g["hier_cap2"]) == pick_capacities_hier(
                g["n_local"], h, c, s.id_capacity_factor, v_pad // (h * c),
                g["unique_bound_chip"], g["unique_bound_host"], s.cap_rows, s.cap_rows_host)
            assert g["hier_s1_overflows"] == (g["hier_s1_bucket_max"] > g["hier_cap1"])


def test_measure_id_stats_main_prints_the_table(capsys, tmp_path):
    out = tmp_path / "stats.json"
    assert measure_id_stats.main(["--config=multihost", "--batch=1024", "--steps=1",
                                  "--topologies=1x1,2x2", f"--json={out}"]) == 0
    text = capsys.readouterr().out
    assert "== 2x2" in text and "against cap1" in text and out.exists()


def test_bench_scaling_steps_agree_with_jax(tmp_path):
    jcfg, cfg = _cfgs(use_pallas=False)
    batch = cfg.data.batch_size
    state = jax_train.create_state(jcfg, jax.random.key(0))
    np_state = jax.tree.map(np.asarray, {
        "step": state.step, "params": state.params,
        "dense_opt_state": _flatten_optax(state.dense_opt_state),
        "sparse_opt_state": state.sparse_opt_state})
    ids, dense, labels = bench_scaling.make_batch(cfg, batch)
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, batch_size=batch))
    _, m = jax_train.train_step(state, jnp.asarray(ids), None, jnp.asarray(labels), jcfg)
    ranks = worker.run(worker.bench_scaling, tmp_path, 4, cfg=cfg, batch=batch, hier=(2, 2),
                       np_state=np_state)
    for r in ranks:
        assert [(x["exchange"], x["devices"]) for x in r] == [
            ("single", 1), ("flat", 4), ("hier", 4)]
        assert r[2]["mesh"] == "2x2" and all(x["value"] > 0 for x in r)
        for x in r:
            np.testing.assert_allclose(x["first_loss"], float(m["loss"]), rtol=1e-5)

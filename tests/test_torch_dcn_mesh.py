"""The port's intra-host engine (`parallel/dcn_mesh.py`: tables sharded
over a host's cards, replicated across hosts) on 4 gloo processes as a
grid of 2 hosts of 2 cards, against `cffm_tpu.parallel.dcn_mesh` on
`make_mesh_2d(2, 2)` over 4 of the 8 virtual CPU devices (Pallas kernels
in interpret mode, bt=8), from the same numpy inputs and state; and the
(host, chip) grid of `parallel/mesh.py`.

Tolerances: the train steps at `test_torch_sharded_train.py`'s, the eval
at `test_torch_sharded_eval.py`'s; the two hosts' replicas bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_worker as worker
from cffm_tpu import metrics as jax_metrics
from cffm_tpu.ops.interaction_conv import make_interaction_fn as jax_make_fn
from cffm_tpu.parallel import dcn_mesh as jdm
from cffm_tpu_torch.parallel import dcn_mesh
from cffm_tpu_torch.parallel.mesh import Mesh, Mesh2D, grid_shape, make_mesh_2d
from test_torch_sharded_eval import _assert_auc_close
from test_torch_sharded_train import EIGHT, _assert_close, _batch, _cfgs, _np_state

H, C = 2, 2
T = H * C


def _run_jax_2d(jcfg, batches, use_kernel, eval_batches=()):
    mesh = jdm.make_mesh_2d(H, C)
    jfn = jax_make_fn(use_pallas=True, bt=8, interpret=True) if use_kernel else None
    state = jdm.create_sharded_state_2d(jcfg, jax.random.key(0), mesh)
    initial = _np_state(state)  # the step donates its input
    step = jdm.make_sharded_train_step_2d(jcfg, mesh, jfn)
    losses, overflows = [], []
    for ids, labels in batches:
        state, m = step(state, jnp.asarray(ids), None, jnp.asarray(labels))
        losses.append(float(m["loss"]))
        overflows.append(int(m["overflow"]))
    evals = []
    if eval_batches:
        ev = jdm.make_sharded_eval_step_2d(jcfg, mesh, jfn)
        for ids, labels in eval_batches:
            evals.append(jax.tree.map(np.asarray, ev(state, jax_metrics.auc_state_init(),
                                                     jnp.asarray(ids), None,
                                                     jnp.asarray(labels))))
    return {"initial": initial, "final": _np_state(state), "losses": losses,
            "overflows": overflows, "evals": evals}


ROUTES = {
    # name: (cfg pair, steps); the hybrid route is not taken on this engine,
    # as in JAX. bf16 compute takes one step: after it the table is bit-equal
    # to JAX's and the dense params within 1e-9, but the second step's Adam
    # update of a conv bias entry whose gradient nearly vanishes magnifies
    # the packages' different bf16 roundings to 2.2e-5 (4.2e-6 on the flat
    # engine's fm route), past the 1e-5 the sharded tests hold.
    "fm_f32": (lambda: _cfgs(), 2),
    "fm_bf16": (lambda: _cfgs(dtype="bfloat16"), 1),
    "separate_linear_sgd": (lambda: _cfgs(vocabs=EIGHT, sparse="sgd", clip=0.05), 2),
}


def _sr_cfg():
    """A bf16 table with stochastic rounding (the port's own init)."""
    _, cfg = _cfgs()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              table_dtype="bfloat16"))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    want, jobs, cfgs = {}, {}, {}
    for name, (make, n) in ROUTES.items():
        jcfg, cfg = make()
        batches = [_batch(cfg, seed) for seed in range(n)]
        evals = [_batch(cfg, 100)] if name == "fm_f32" else []
        want[name] = _run_jax_2d(jcfg, batches, True, evals)
        jobs[name] = {"engine": "2d", "cfg": cfg, "np_state": want[name]["initial"],
                      "batches": [(i, None, lab) for i, lab in batches], "use_kernel": True,
                      "eval_batches": [(i, None, lab) for i, lab in evals]}
        cfgs[name] = cfg
    cfg = _sr_cfg()
    jobs["sr_bf16_table"] = {"engine": "2d", "cfg": cfg, "np_state": None,
                             "batches": [(i, None, lab) for i, lab in
                                         (_batch(cfg, s) for s in range(2))],
                             "use_kernel": True}
    ranks = worker.run(worker.grid_train, tmp_path_factory.mktemp("steps"), T, num_hosts=H,
                       jobs=jobs)
    return want, {name: [r[name] for r in ranks] for name in jobs}, cfgs


def _assert_replicas_equal(ranks):
    """Rank h*C + c holds host h's replica of shard c."""
    for c in range(C):
        a, b = ranks[c]["state"], ranks[C + c]["state"]
        assert torch.equal(a.params["embed"]["table"], b.params["embed"]["table"])
        for k, v in a.sparse_opt_state["embed"].items():
            assert torch.equal(v, b.sparse_opt_state["embed"][k])


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_2d_steps_match_jax(steps, route):
    want, got, cfgs = steps
    for r in got[route]:
        np.testing.assert_allclose(r["losses"], want[route]["losses"], rtol=1e-5)
        assert r["overflows"] == want[route]["overflows"] == [0] * ROUTES[route][1]
    _assert_close(want[route]["initial"], want[route]["final"], got[route], cfgs[route],
                  route == "fm_bf16", t=C)
    _assert_replicas_equal(got[route])


def test_2d_eval_matches_jax(steps):
    want, got, _ = steps
    (jauc,) = want["fm_f32"]["evals"]
    for r in got["fm_f32"]:
        (auc, overflow), = r["evals"]
        assert overflow == 0
        _assert_auc_close(auc, jauc)


def test_2d_bf16_stochastic_rounding_keeps_the_replicas_equal(steps):
    """The dither is keyed by the chip index alone: after two steps on a
    bf16 table the two hosts' replicas are still bit-equal, and the table
    moved."""
    _, got, _ = steps
    ranks = got["sr_bf16_table"]
    for c in range(C):
        assert torch.equal(ranks[c]["initial_table"], ranks[C + c]["initial_table"])
        assert not torch.equal(ranks[c]["initial_table"],
                               ranks[c]["state"].params["embed"]["table"])
    _assert_replicas_equal(ranks)
    assert all(np.isfinite(r["losses"]).all() for r in ranks)


def _grid(h=H, c=C):
    flat = Mesh(None, 0, h * c, torch.device("cpu"), False)
    return Mesh2D(flat, Mesh(None, 0, c, flat.device, False),
                  Mesh(None, 0, h, flat.device, False))


@pytest.mark.parametrize("sparse", ["rowwise_adam", "adam"])
def test_2d_refuses_optimizers_without_a_dense_form(sparse):
    _, cfg = _cfgs(sparse=sparse)
    with pytest.raises(ValueError, match="dense-form"):
        dcn_mesh.make_sharded_train_step_2d(cfg, _grid())


def test_dense_table_grad_sums_buckets_in_peer_order():
    """Unique ascending ids per bucket, sentinel slots with garbage: the
    dense gradient equals numpy's f32 sums in the same order, bit for bit,
    and the spare rows past the shard alone take the garbage."""
    rng = np.random.default_rng(0)
    vs, w, t, c = 50, 8, 3, 20
    ids = np.full((t, c), vs, np.int32)
    for p in range(t):
        rows = np.sort(rng.choice(vs, size=15, replace=False))
        ids[p, :15] = rows
    g = rng.normal(size=(t, c, w)).astype(np.float32)
    g[ids >= vs] = 1e30
    want = np.zeros((vs, w), np.float32)
    for p in range(t):
        valid = ids[p] < vs
        want[ids[p][valid]] += g[p][valid]
    got = dcn_mesh._dense_table_grad(torch.from_numpy(ids), torch.from_numpy(g), vs)
    assert got.shape == (vs + dcn_mesh.SPARE_ROWS, w)
    np.testing.assert_array_equal(got[:vs].numpy(), want)
    garbage = np.float32(1e30) * np.float32(3)  # slots 15-19 of each of the 3 buckets
    assert (got[vs + 15:vs + c].numpy() == garbage).all()
    assert (got[vs:vs + 15].numpy() == 0).all() and (got[vs + c:].numpy() == 0).all()


def test_grid_shape():
    assert grid_shape(4, 2, 2) == (2, 2)
    assert grid_shape(8, num_hosts=2) == (2, 4)
    assert grid_shape(8, chips_per_host=8) == (1, 8)
    with pytest.raises(ValueError, match="whole number of hosts"):
        grid_shape(6, chips_per_host=4)
    with pytest.raises(ValueError, match="whole number of hosts"):
        grid_shape(4, num_hosts=2, chips_per_host=4)


def test_grid_shape_reads_torchruns_local_world_size(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert grid_shape(8) == (2, 4)
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert grid_shape(8) == (1, 8)


def test_make_mesh_2d_refuses_a_partial_host_before_joining(monkeypatch):
    """6 ranks of 4-card hosts: raised before any rendezvous is tried."""
    monkeypatch.setenv("WORLD_SIZE", "6")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="whole number of hosts"):
        make_mesh_2d(backend="gloo", device="cpu")


def test_create_sharded_state_2d_shards_over_the_chips():
    """The shard of chip c over C shards, whatever the host: the flat
    state of the chip sub-mesh."""
    _, cfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    state = dcn_mesh.create_sharded_state_2d(cfg, gen, _grid())
    assert state.params["embed"]["table"].shape[0] == -(-cfg.model.total_vocab // C)

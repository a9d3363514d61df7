"""The rows' route of every shipped config and of the test configs that
reach the other branches, on the CPU: for scoring, eval, the one-card
train step, the sharded train step and the sharded eval step (a group of
one, the config's own engine), the `models.cffm.Route` that reaches
`forward_from_rows` and the `ops/interaction_conv` entry called.

The shipped configs are cut to size by capping every vocabulary above the
small-field threshold at 520 rows, which keeps each config's small-field
prefix. The expected routes and entries are the port's behaviour before
the route was decided in one place; the sharded eval step stays
batch-major.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cffm_tpu_torch import train
from cffm_tpu_torch.config import get_config
from cffm_tpu_torch.models import cffm as model
from cffm_tpu_torch.ops import interaction_conv as ic
from cffm_tpu_torch.parallel import dcn_mesh
from cffm_tpu_torch.parallel import sharded_train as st
from cffm_tpu_torch.parallel.mesh import close_mesh, free_port, make_mesh, make_mesh_2d

B = 8
CAP = 520
ENTRIES = ("cross_conv1", "cross_conv1_lin", "cross_conv1_lin_fm", "cross_conv1_lin_fm2")
PATHS = ("score", "eval", "train", "sharded_train", "sharded_eval")

# name -> (shipped config, overrides by section)
CASES = {
    "avazu": ("avazu", {}),
    "criteo_full": ("criteo_full", {}),
    "criteo_kaggle": ("criteo_kaggle", {}),
    "movielens": ("movielens", {}),
    "multihost": ("multihost", {}),
    "no_prefix": ("criteo_kaggle", {"model": {"small_field_threshold": 0}}),
    "rowwise_adam": ("criteo_kaggle", {"optim": {"sparse_optimizer": "rowwise_adam"}}),
    "even_k": ("criteo_kaggle", {"model": {"conv_kernel": 4}}),
    "intra_host": ("criteo_kaggle", {"sharding": {"table_sharded": True,
                                                  "table_axis": "intra_host"}}),
}

SLICED = model.Route(full_rows=False, field_major=False, prefix=0)
FLAT = model.Route(full_rows=True, field_major=False, prefix=0)
FM = model.Route(full_rows=True, field_major=True, prefix=0)


def _hybrid(fs):
    return model.Route(full_rows=True, field_major=True, prefix=fs)


def _paths(score, train, sharded_train, sharded_eval):
    """{path: (route, entry called)}; eval is scoring's. Entry None: the
    reference layer 1, no entry."""
    return dict(score=score, eval=score, train=train, sharded_train=sharded_train,
                sharded_eval=sharded_eval)


FM2 = (_hybrid(13), "cross_conv1_lin_fm2")
WANT = {
    "avazu": _paths(*[(_hybrid(2), "cross_conv1_lin_fm2")] * 3, (FLAT, "cross_conv1_lin")),
    "criteo_full": _paths(FM2, FM2, FM2, (FLAT, "cross_conv1_lin")),
    "criteo_kaggle": _paths(FM2, FM2, FM2, (FLAT, "cross_conv1_lin")),
    "movielens": _paths(*[(SLICED, "cross_conv1")] * 4),
    "multihost": _paths(FM2, FM2, FM2, (FLAT, "cross_conv1_lin")),
    "no_prefix": _paths((FLAT, "cross_conv1_lin"), (FM, "cross_conv1_lin_fm"),
                        (FM, "cross_conv1_lin_fm"), (FLAT, "cross_conv1_lin")),
    "rowwise_adam": _paths(FM2, (FM, "cross_conv1_lin_fm"), (FM, "cross_conv1_lin_fm"),
                           (FLAT, "cross_conv1_lin")),
    "even_k": _paths(*[(SLICED, None)] * 4),
    "intra_host": _paths(FM2, FM2, (FM, "cross_conv1_lin_fm"), (FLAT, "cross_conv1_lin")),
}


def _config(case):
    name, over = CASES[case]
    cfg = get_config(name)
    mcfg = cfg.model
    cut = tuple(v if v <= mcfg.small_field_threshold else CAP for v in mcfg.vocab_sizes)
    sections = {"model": dict(vocab_sizes=cut), "data": dict(batch_size=B)}
    for section, fields in over.items():
        sections.setdefault(section, {}).update(fields)
    cfg = dataclasses.replace(cfg, **{k: dataclasses.replace(getattr(cfg, k), **v)
                                      for k, v in sections.items()})
    assert cfg.model.small_field_prefix == (0 if case == "no_prefix"
                                            else mcfg.small_field_prefix)
    return cfg


def _batch(cfg):
    mcfg = cfg.model
    rng = np.random.default_rng(0)
    ids = np.stack([rng.integers(0, v, size=B) for v in mcfg.vocab_sizes], axis=1)
    ids = torch.from_numpy((ids + model.field_offsets(mcfg)[None, :]).astype(np.int32))
    dense = (torch.from_numpy(rng.normal(size=(B, mcfg.num_dense)).astype(np.float32))
             if mcfg.num_dense else None)
    return ids, dense, torch.from_numpy((rng.random(B) < 0.3).astype(np.float32))


@pytest.fixture(scope="module")
def group_of_one():
    mesh = make_mesh(init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
                     backend="gloo", device="cpu")
    yield mesh
    close_mesh(mesh)


def _sharded_steps(cfg, mesh, fn):
    """(state, train step, eval step) of the config's own engine."""
    gen = torch.Generator().manual_seed(0)
    axis = cfg.sharding.table_axis
    if axis == "global":
        return (st.create_sharded_state(cfg, gen, mesh), st.make_sharded_train_step(cfg, mesh, fn),
                st.make_sharded_eval_step(cfg, mesh, fn))
    grid = make_mesh_2d(1, 1, device=mesh.device)
    if axis == "hier":
        return (st.create_sharded_state(cfg, gen, mesh),
                st.make_sharded_train_step_hier(cfg, grid, fn),
                st.make_sharded_eval_step_hier(cfg, grid, fn))
    return (dcn_mesh.create_sharded_state_2d(cfg, gen, grid),
            dcn_mesh.make_sharded_train_step_2d(cfg, grid, fn),
            dcn_mesh.make_sharded_eval_step_2d(cfg, grid, fn))


def _routes_taken(cfg, mesh, monkeypatch):
    """{path: (route, entry names called)} over the five paths: the route
    that reached `models.cffm.forward_from_rows`, and the entries."""
    calls, routes = [], []
    for name in ENTRIES:
        real = getattr(ic, name)

        def spy(*a, _name=name, _real=real):
            calls.append(_name)
            return _real(*a)

        monkeypatch.setattr(ic, name, spy)
    real_from_rows = model.forward_from_rows

    def from_rows(params, route, *a, **k):
        routes.append(route)
        return real_from_rows(params, route, *a, **k)

    monkeypatch.setattr(model, "forward_from_rows", from_rows)
    fn = train.default_interaction_fn(cfg)
    ids, dense, labels = _batch(cfg)
    state = train.create_state(cfg, torch.Generator().manual_seed(0))
    sh_state, sh_train, sh_eval = _sharded_steps(cfg, mesh, fn)
    auc = lambda: train.metrics.auc_state_init()  # noqa: E731
    run = {
        "score": lambda: torch.inference_mode()(model.forward)(
            state.params, ids, dense, cfg.model, interaction_fn=fn),
        "eval": lambda: train.eval_step(state, auc(), ids, dense, labels, cfg, fn),
        "train": lambda: train.train_step(state, ids, dense, labels, cfg, fn),
        "sharded_train": lambda: sh_train(sh_state, ids, dense, labels),
        "sharded_eval": lambda: sh_eval(sh_state, auc(), ids, dense, labels),
    }
    out = {}
    for path in PATHS:
        calls.clear()
        routes.clear()
        run[path]()
        assert len(routes) == 1, path
        out[path] = (routes[0], list(calls))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_each_path_takes_the_parents_route_and_entry(case, group_of_one, monkeypatch):
    cfg = _config(case)
    got = _routes_taken(cfg, group_of_one, monkeypatch)
    assert got == {p: (r, [] if e is None else [e]) for p, (r, e) in WANT[case].items()}

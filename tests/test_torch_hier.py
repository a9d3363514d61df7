"""The port's hierarchical engine (`parallel/hier_embedding.py`, the
`HierRouter` steps of `parallel/sharded_train.py`) on 4 gloo processes as
a grid of 2 hosts of 2 cards, against the JAX package's on
`make_mesh_2d(2, 2)` over 4 of the 8 virtual CPU devices (Pallas kernels
in interpret mode, bt=8), from the same numpy inputs and state; and
`train.run` with table_axis "hier" and "intra_host" on 4 gloo ranks.

The children (`tests/torch_sharded_worker.py`) spawn once per group of
cases. Tolerances: routing, rows and row ids exact; the returned grads
on valid slots at rtol 1e-6 (f32) or one bf16 ulp (bf16: each package
rounds its f32 sums once at each of the two stages); the train steps at
`test_torch_sharded_train.py`'s tolerances; hier against flat inside the
port at JAX's own (loss rtol 1e-6, tables rtol 1e-5, atol 1e-6); the eval
at `test_torch_sharded_eval.py`'s.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_sharded_worker as worker
from cffm_tpu import config as jax_config
from cffm_tpu import metrics as jax_metrics
from cffm_tpu.models.cffm import field_offsets
from cffm_tpu.ops.interaction_conv import make_interaction_fn as jax_make_fn
from cffm_tpu.parallel import hier_embedding as jhe
from cffm_tpu.parallel import sharded_embedding as jse
from cffm_tpu.parallel import sharded_train as jst
from cffm_tpu.parallel.dcn_mesh import make_mesh_2d
from cffm_tpu.parallel.mesh import make_mesh
from cffm_tpu_torch import config, train
from cffm_tpu_torch.parallel import hier_embedding as he
from cffm_tpu_torch.parallel import sharded_embedding as se
from test_torch_sharded_eval import _assert_auc_close
from test_torch_sharded_train import EIGHT, _assert_close, _batch, _cfgs, _np_state

H, C = 2, 2
T = H * C
HOST, CHIP = "host", "chip"
BOTH = P((HOST, CHIP))


def _bf16_ulp_close(got, want):
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.ldexp(1.0, np.frexp(np.maximum(big, 1e-30))[1] - 8)
    assert (np.abs(got - want) <= ulp).all()


# ---------------------------------------------------------------------------
# The engine: build_routing(keys=), the two-stage routing, lookup and grads
# ---------------------------------------------------------------------------

STRIDE = 300
V = 4096
VS = V // T


def _keyed_inputs():
    """Per rank 512 keys owner * STRIDE + local: owner 0 hot (it
    overflows a 128 capacity), and a tail of sentinel entries (owner T),
    most of them at exactly T * STRIDE, as the hier stage 2 makes them."""
    rng = np.random.default_rng(3)
    n, tail = 512, 96
    blocks = []
    for _ in range(T):
        owner = rng.choice(T, size=n - tail, p=[0.55, 0.15, 0.15, 0.15])
        local = rng.integers(0, STRIDE, size=n - tail)
        sent = np.where(rng.random(tail) < 0.8, 0, rng.integers(0, STRIDE, size=tail))
        keys = np.concatenate([owner * STRIDE + local, T * STRIDE + sent])
        blocks.append(rng.permutation(keys))
    return np.concatenate(blocks).astype(np.int32)


def _hier_cases():
    rng = np.random.default_rng(1)
    n = 512
    zipf = np.minimum(rng.zipf(1.5, size=n * T) - 1, V - 1).astype(np.int32)
    uniform = rng.integers(0, V, size=n * T).astype(np.int32)
    caps = jhe.pick_capacities_hier(n, H, C, 2.0, VS, batch_unique=n + 1,
                                    host_unique=C * n + 1)
    cases = {}
    for name, ids, w, dtype, cap in (("f32", zipf, 16, np.float32, caps),
                                     ("bf16", zipf, 128, "bf16", caps),
                                     ("overflow", uniform, 16, np.float32, (128, 128))):
        table = rng.normal(size=(V, w)).astype(np.float32)
        g = jnp.asarray(rng.normal(size=(n * T, w)).astype(np.float32))
        if dtype == "bf16":
            g = g.astype(jnp.bfloat16)
        cases[name] = {"ids": ids, "table": table, "drows": g, "cap1": cap[0],
                       "cap2": cap[1], "max_unique": (n, C * n)}
    return cases


def _jax_engine(keys, cases):
    flat = make_mesh(T)

    def keyed(k):
        r = jse.build_routing(k, 128, "data", rows_per_shard=STRIDE, keys=k)
        return tuple(x[None] for x in (r.order, r.seg, r.idx_of_pos, r.start, r.recv_ids,
                                       r.overflow))

    out = jax.jit(shard_map(keyed, mesh=flat, in_specs=(P("data"),), out_specs=P("data"),
                            check_vma=False))(jnp.asarray(keys))
    want = {"keyed": dict(zip(("order", "seg", "idx_of_pos", "start", "recv_ids", "overflow"),
                              map(np.asarray, out)))}
    mesh2d = make_mesh_2d(H, C)
    for name, case in cases.items():
        def body(ids, table, g, case=case):
            hr = jhe.build_routing_hier(ids, case["cap1"], case["cap2"], HOST, CHIP, VS)
            rows = jhe.hier_routed_lookup(table, hr, HOST, CHIP)
            row_ids, grads = jhe.hier_grad_return(g, hr, HOST, CHIP, *case["max_unique"])
            return tuple(x[None] for x in (hr.r1.recv_ids, hr.r2.recv_ids, hr.r1.idx_of_pos,
                                           hr.r2.idx_of_pos, jhe.hier_overflow(hr), rows,
                                           row_ids, grads.astype(jnp.float32)))

        fn = shard_map(body, mesh=mesh2d, in_specs=(BOTH, P((HOST, CHIP), None),
                                                    P((HOST, CHIP), None)),
                       out_specs=BOTH, check_vma=False)
        storage = jse.to_mod_sharded(jnp.asarray(case["table"]), T)
        out = jax.jit(fn)(jnp.asarray(case["ids"]), storage, case["drows"])
        want[name] = dict(zip(("r1_recv_ids", "r2_recv_ids", "r1_idx_of_pos", "r2_idx_of_pos",
                               "overflow", "rows", "row_ids", "grads"), map(np.asarray, out)))
        case["storage"] = np.asarray(storage)
    return want


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    keys = _keyed_inputs()
    cases = _hier_cases()
    want = _jax_engine(keys, cases)
    port_cases = {}
    for name, case in cases.items():
        g = np.asarray(case["drows"])
        if g.dtype.name == "bfloat16":
            g = g.view(np.int16)
        port_cases[name] = {"ids": case["ids"], "storage": case["storage"], "drows": g,
                            "cap1": case["cap1"], "cap2": case["cap2"],
                            "max_unique": case["max_unique"], "rows_per_shard": VS}
    ranks = worker.run(worker.hier_engine, tmp_path_factory.mktemp("engine"), T, num_hosts=H,
                       keyed={"keys": keys, "capacity": 128, "stride": STRIDE},
                       hier=port_cases)
    got = {part: {k: np.stack([r[part][k].float().numpy() if r[part][k].is_floating_point()
                               else r[part][k].numpy() for r in ranks])
                  for k in ranks[0][part]} for part in ranks[0]}
    return want, got


def test_build_routing_keys_with_a_sentinel_tail_matches_jax(engine):
    want, got = engine
    for k, w in want["keyed"].items():
        np.testing.assert_array_equal(got["keyed"][k], w, err_msg=k)
    assert want["keyed"]["overflow"].sum() > 0
    # the sentinels' slots point past the (T, C) buffer, as in JAX
    assert (want["keyed"]["idx_of_pos"] >= T * 128).any()


@pytest.mark.parametrize("case", ["f32", "bf16", "overflow"])
def test_hier_routing_lookup_and_grad_return_match_jax(engine, case):
    want, got = engine
    w, g = want[case], got[case]
    for k in ("r1_recv_ids", "r2_recv_ids", "r1_idx_of_pos", "r2_idx_of_pos", "overflow",
              "row_ids"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    np.testing.assert_array_equal(g["rows"], w["rows"])
    assert (int(w["overflow"].sum()) > 0) == (case == "overflow")
    valid = w["row_ids"] < VS
    if case == "bf16":
        _bf16_ulp_close(g["grads"][valid], w["grads"][valid])
    else:
        np.testing.assert_allclose(g["grads"][valid], w["grads"][valid], rtol=1e-6, atol=1e-6)


def test_pick_capacities_hier_matches_jax_over_a_grid():
    for n_local in (320, 8192 * 5, 319488):
        for h, c in ((2, 2), (2, 8), (1, 1), (1, 4), (4, 1)):
            for factor in (2.0, 0.25):
                for vs in (72, 100_000):
                    for cr, crh in ((0, 0), (256, 384), (8192, 16384)):
                        args = (n_local, h, c, factor, vs, 10_000, 40_000)
                        kw = dict(cap_rows=cr, cap_rows_host=crh)
                        assert he.pick_capacities_hier(*args, **kw) == \
                            jhe.pick_capacities_hier(*args, **kw), (args, kw)


def test_cap_rows_override_semantics():
    """The port's twin of tests/test_hier_train.py's: the override binds
    past one shard, the hard caps still bind, and one shard covers the
    whole distinct bound."""
    assert se.pick_capacity(319488, 8, 2.0, cap_rows=8192) == 8192
    assert se.pick_capacity(1000, 8, 2.0, cap_rows=8192) == 1024
    assert se.pick_capacity(319488, 8, 2.0, max_unique=4000, cap_rows=8192) == 4096
    assert se.pick_capacity(1000, 1, 0.25, cap_rows=128) == 1024
    assert he.pick_capacities_hier(8192 * 5, H, 4, 2.0, rows_per_shard=100_000,
                                   batch_unique=10_000, host_unique=40_000,
                                   cap_rows=256, cap_rows_host=384) == (256, 384)
    assert he.pick_capacities_hier(8192 * 5, H, 4, 2.0, rows_per_shard=72,
                                   batch_unique=10_000, host_unique=40_000,
                                   cap_rows=256, cap_rows_host=384)[1] == 128


# ---------------------------------------------------------------------------
# The train and eval steps
# ---------------------------------------------------------------------------


def _with_dense(batches):
    return [(ids, None, labels) for ids, labels in batches]


def _overflow_cfgs():
    """Uniform ids over 5 fields of 8192 at a capacity factor of 0.25:
    both stages' buckets overflow."""
    jcfg, cfg = _cfgs(vocabs=(8192,) * 5)
    return tuple(dataclasses.replace(c, sharding=dataclasses.replace(
        c.sharding, id_capacity_factor=0.25)) for c in (jcfg, cfg))


def _uniform_batches(cfg, seeds):
    out = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        b = cfg.data.batch_size
        ids = np.stack([rng.integers(0, v, size=b) for v in cfg.model.vocab_sizes], axis=1)
        ids = (ids + field_offsets(cfg.model)[None, :]).astype(np.int32)
        dense = (rng.normal(size=(b, cfg.model.num_dense)).astype(np.float32)
                 if cfg.model.num_dense else None)
        out.append((ids, dense, (rng.random(b) < 0.3).astype(np.float32)))
    return out


def _multihost_cfgs():
    """`multihost` with its sharding block verbatim at test widths."""
    pair = []
    for get in (jax_config.get_config, config.get_config):
        c = get("multihost")
        pair.append(dataclasses.replace(
            c, model=dataclasses.replace(c.model, vocab_sizes=tuple([64] * 13 + [512] * 26),
                                         table_dtype="float32", compute_dtype="float32",
                                         use_pallas=False),
            data=dataclasses.replace(c.data, batch_size=256)))
    return tuple(pair)


def _run_jax_hier(jcfg, batches, use_kernel, eval_batches=()):
    mesh = make_mesh_2d(H, C)
    jfn = jax_make_fn(use_pallas=True, bt=8, interpret=True) if use_kernel else None
    state = jst.create_sharded_state(jcfg, jax.random.key(0), mesh,
                                     table_pspec=P((HOST, CHIP), None))
    initial = _np_state(state)  # the step donates its input
    step = jst.make_sharded_train_step_hier(jcfg, mesh, jfn)
    losses, overflows = [], []
    for ids, dense, labels in batches:
        state, m = step(state, jnp.asarray(ids), None if dense is None else jnp.asarray(dense),
                        jnp.asarray(labels))
        losses.append(float(m["loss"]))
        overflows.append(int(m["overflow"]))
    evals = []
    if eval_batches:
        ev = jst.make_sharded_eval_step_hier(jcfg, mesh, jfn)
        for ids, dense, labels in eval_batches:
            evals.append(jax.tree.map(np.asarray, ev(state, jax_metrics.auc_state_init(),
                                                     jnp.asarray(ids), None,
                                                     jnp.asarray(labels))))
    return {"initial": initial, "final": _np_state(state), "losses": losses,
            "overflows": overflows, "evals": evals}


STEP_ROUTES = {
    # name: (cfg pair, use_kernel)
    "hybrid_f32": (_cfgs, True),
    "hybrid_bf16": (lambda: _cfgs(dtype="bfloat16"), True),
    "separate_linear": (lambda: _cfgs(vocabs=EIGHT), True),
}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Every step case in one spawn of the 4 ranks."""
    want, jobs, cfgs = {}, {}, {}
    for name, (make, use_kernel) in STEP_ROUTES.items():
        jcfg, cfg = make()
        batches = _with_dense([_batch(cfg, seed) for seed in range(2)])
        evals = _with_dense([_batch(cfg, 100)]) if name == "hybrid_f32" else ()
        want[name] = _run_jax_hier(jcfg, batches, use_kernel, evals)
        jobs[name] = {"engine": "hier", "cfg": cfg, "np_state": want[name]["initial"],
                      "batches": batches, "use_kernel": use_kernel, "eval_batches": evals}
        cfgs[name] = cfg
    # one step of each engine from the same state, as tests/test_hier_train.py
    one = dict(jobs["hybrid_f32"], batches=jobs["hybrid_f32"]["batches"][:1], eval_batches=())
    jobs["hier_one"], jobs["flat_one"] = one, dict(one, engine="flat")
    for name, (jcfg, cfg), seeds in (("overflow", _overflow_cfgs(), (0, 0)),
                                     ("multihost", _multihost_cfgs(), (0, 1))):
        batches = _uniform_batches(cfg, seeds)
        want[name] = _run_jax_hier(jcfg, batches, False)
        jobs[name] = {"engine": "hier", "cfg": cfg, "np_state": want[name]["initial"],
                      "batches": batches, "use_kernel": False}
        cfgs[name] = cfg
    ranks = worker.run(worker.grid_train, tmp_path_factory.mktemp("steps"), T, num_hosts=H,
                       jobs=jobs)
    return want, {name: [r[name] for r in ranks] for name in jobs}, cfgs


@pytest.mark.parametrize("route", sorted(STEP_ROUTES))
def test_hier_two_steps_match_jax(steps, route):
    want, got, cfgs = steps
    for r in got[route]:
        np.testing.assert_allclose(r["losses"], want[route]["losses"], rtol=1e-5)
        assert r["overflows"] == want[route]["overflows"] == [0, 0]
    _assert_close(want[route]["initial"], want[route]["final"], got[route], cfgs[route],
                  route == "hybrid_bf16")


def test_hier_equals_flat_in_the_port(steps):
    """One step from the same state and batch through the port's hier and
    flat steps. The layout is the same, so each rank's shards compare as
    they are: loss, dense params and accumulator at JAX's tolerances for
    this pair; the table's step within 1e-2 of its largest (the fused
    linear column of hot rows sums near-cancelling terms in another
    order, 0.4% apart here), untouched rows bit-equal."""
    want, got, _ = steps
    hier, flat = got["hier_one"], got["flat_one"]
    np.testing.assert_allclose(hier[0]["losses"], flat[0]["losses"], rtol=1e-6)
    initial = want["hybrid_f32"]["initial"]["params"]["embed"]["table"]
    vs = len(initial) // T
    for rank, (a, b) in enumerate(zip(hier, flat)):
        dense = lambda s: train.tree_leaves(train.split_dense_params(s.params))  # noqa: E731
        for x, y in zip(dense(a["state"]) + [a["state"].sparse_opt_state["embed"]["accum"]],
                        dense(b["state"]) + [b["state"].sparse_opt_state["embed"]["accum"]]):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-6)
        start = initial[rank * vs:(rank + 1) * vs]
        step_h = a["state"].params["embed"]["table"].numpy() - start
        step_f = b["state"].params["embed"]["table"].numpy() - start
        np.testing.assert_allclose(step_h, step_f, atol=1e-2 * np.abs(step_f).max())
        np.testing.assert_array_equal(step_h[(step_f == 0).all(axis=1)], 0.0)


def test_hier_forced_overflow_is_counted_and_stays_finite(steps):
    want, got, _ = steps
    assert min(want["overflow"]["overflows"]) > 0
    for r in got["overflow"]:
        assert r["overflows"] == want["overflow"]["overflows"]
        np.testing.assert_allclose(r["losses"], want["overflow"]["losses"], rtol=1e-5)
        assert torch.isfinite(r["state"].params["embed"]["table"]).all()


def test_hier_router_reports_each_stage_overflow(steps):
    """HierRouter.stage_overflow, this rank's (stage 1, stage 2) drops as
    the step routed them, sums over the ranks to the step's overflow; the
    forced case overflows both stages, multihost at test widths neither."""
    _, got, _ = steps
    for name in ("overflow", "multihost", "hybrid_f32"):
        stages = np.array([r["stages"] for r in got[name]])  # (rank, step, stage)
        np.testing.assert_array_equal(stages.sum(axis=(0, 2)), got[name][0]["overflows"])
        assert (stages.sum(axis=(0, 1)) > 0).all() == (name == "overflow")


@pytest.mark.parametrize("vocabs", ["mixed", "separate_linear"])
def test_a_shard_drawn_in_chunks_is_the_one_draw(monkeypatch, vocabs):
    """A shard whose f32 draw passes INIT_DRAW_BYTES (multihost's on one
    card) is drawn INIT_ROWS rows a randn call (`models/cffm.draw_table`);
    on the CPU's generator the chunks follow the one draw's stream, so every
    row is drawn once, scaled and cast as before: the state is the one
    draw's, bit for bit."""
    from cffm_tpu_torch.models import cffm as model_lib
    from cffm_tpu_torch.parallel import sharded_train as st
    from cffm_tpu_torch.parallel.mesh import Mesh

    _, cfg = _cfgs(**({"vocabs": EIGHT} if vocabs == "separate_linear" else {}))
    mesh = Mesh(None, 1, 3, torch.device("cpu"), False)
    one = st.create_sharded_state(cfg, torch.Generator().manual_seed(4), mesh)
    monkeypatch.setattr(model_lib, "INIT_DRAW_BYTES", 0)
    monkeypatch.setattr(model_lib, "INIT_ROWS", 32)
    chunked = st.create_sharded_state(cfg, torch.Generator().manual_seed(4), mesh)
    assert one.params["embed"]["table"].shape[0] % 32  # a partial last chunk
    for a, b in zip(train.tree_leaves(one.params) + train.tree_leaves(one.sparse_opt_state),
                    train.tree_leaves(chunked.params)
                    + train.tree_leaves(chunked.sparse_opt_state)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_hier_eval_matches_jax(steps):
    want, got, _ = steps
    (jauc,) = want["hybrid_f32"]["evals"]
    for r in got["hybrid_f32"]:
        (auc, overflow), = r["evals"]
        assert overflow == 0
        _assert_auc_close(auc, jauc)
        fin = jax_metrics.auc_state_finalize(auc)
        jfin = jax_metrics.auc_state_finalize(jauc)
        for key in ("auc", "logloss"):
            np.testing.assert_allclose(float(fin[key]), float(jfin[key]), rtol=1e-6)


def test_multihost_sharding_block_runs_at_test_widths(steps):
    """The twin of tests/test_hier_checkpoint.py's multihost check: the
    config's caps (the hard caps bind below them at this batch), no
    overflow, and two steps against JAX's."""
    want, got, cfgs = steps
    s = cfgs["multihost"].sharding
    assert (s.table_axis, s.cap_rows, s.cap_rows_host) == ("hier", 8192, 16384)
    for r in got["multihost"]:
        assert r["overflows"] == want["multihost"]["overflows"] == [0, 0]
        assert np.isfinite(r["losses"]).all()
        np.testing.assert_allclose(r["losses"], want["multihost"]["losses"], rtol=1e-5)
    _assert_close(want["multihost"]["initial"], want["multihost"]["final"], got["multihost"],
                  cfgs["multihost"], False)


# ---------------------------------------------------------------------------
# train.run on the grid
# ---------------------------------------------------------------------------


def test_run_trains_hier_packed_and_intra_host_raw(tmp_path):
    """train.run on 4 gloo ranks as 2 hosts of 2 (LOCAL_WORLD_SIZE=2):
    table_axis hier with the packed wire, intra_host with the raw one,
    each saving its final checkpoint. Every rank ends with the same
    metrics and counts the whole group's eval examples; rank 0 alone logs,
    with no overflow; the hier run saves 4 table shards, the intra-host
    run C = 2 (its tables are sharded over a host's cards)."""
    base = config.get_config("movielens")
    axes = (("hier", "packed", T), ("intra_host", "raw", C))
    cfgs = []
    for axis, wire, _ in axes:
        cfgs.append(dataclasses.replace(
            base, log_every=1, checkpoint_dir=str(tmp_path / axis),
            sharding=dataclasses.replace(base.sharding, table_sharded=True, table_axis=axis),
            data=dataclasses.replace(base.data, batch_size=256, num_train_steps=2,
                                     eval_batches=2, wire_format=wire)))
    ranks = worker.run(worker.run_train_grid, tmp_path, T, cfgs=cfgs, chips_per_host=C)
    for axis, _, shards in axes:
        step_dir = tmp_path / axis / "2"
        assert json.loads((step_dir / "meta.json").read_text())["num_table_shards"] == shards
        assert sorted(p.name for p in step_dir.glob("shard*")) == [
            f"shard{i:05d}.pt" for i in range(shards)]
    for i in range(len(cfgs)):
        for r in ranks:
            res = r[i]["result"]
            assert res["count"] == 2 * 256
            assert np.isfinite([res["auc"], res["logloss"], res["final_train_loss"]]).all()
            assert res == ranks[0][i]["result"]
        steps_logged = [json.loads(x) for x in ranks[0][i]["logs"] if '"step"' in x]
        assert [s["step"] for s in steps_logged] == [1, 2]
        assert all(s["id_overflow"] == 0 for s in steps_logged)
        assert all(r[i]["logs"] == [] for r in ranks[1:])

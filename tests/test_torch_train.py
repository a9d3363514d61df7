"""The port's train step (CPU) vs `cffm_tpu.train.train_step` over two
steps from the same state (`convert.state_from_jax`) and the same batches,
on every route; the port's hybrid route vs its gather route; `run`.

The JAX side runs its Pallas kernels in interpret mode (bt=8). f32
compute. Tolerances: loss rtol 1e-5; dense params rtol 1e-5, atol 1e-6;
table steps (new - initial) atol 1e-2 of the largest step, because the
streamed route rounds each row's summed gradient to bf16 after f32 sums in
another order (scatter routes agree far closer); sparse state rtol 1e-3,
atol 1e-3 of its largest entry, for the same reason.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu import train as jax_train
from cffm_tpu.config import DataConfig as JData
from cffm_tpu.config import ModelConfig as JModel
from cffm_tpu.config import OptimizerConfig as JOpt
from cffm_tpu.config import TrainConfig as JTrain
from cffm_tpu.models.cffm import field_offsets
from cffm_tpu.ops.interaction_conv import make_interaction_fn as jax_make_fn
from cffm_tpu_torch import config, train
from cffm_tpu_torch.cli import _apply_override
from cffm_tpu_torch.cli import main as cli_main
from cffm_tpu_torch.convert import state_from_jax
from cffm_tpu_torch.ops import interaction_conv as ic
from cffm_tpu_torch.ops.interaction_conv import make_interaction_fn

MIXED = (32, 64, 128) + (1000,) * 12          # F=15: fused column, 3 small fields
ALL_SMALL = (32, 64, 128, 96, 256, 48, 64, 80, 120, 200, 500, 100, 64, 32, 40)
SEVEN = (61, 40, 2, 8, 22, 35, 19)           # F=7: no fused column, a linear table


def _cfgs(vocabs=MIXED, sparse="adagrad", threshold=512, dense_opt="adam",
          stream="on", batch=64, **model_kw):
    mk = dict(num_fields=len(vocabs), vocab_sizes=vocabs, embed_dim=16,
              cross="field_aware", conv_channels=(16,), tower_hidden=(32,),
              compute_dtype="float32", small_field_threshold=threshold, **model_kw)
    ok = dict(sparse_optimizer=sparse, dense_optimizer=dense_opt, streamed_update=stream)
    jcfg = JTrain(name="t", model=JModel(**mk), optim=JOpt(**ok), data=JData(batch_size=batch))
    cfg = config.TrainConfig(name="t", model=config.ModelConfig(**mk),
                             optim=config.OptimizerConfig(**ok),
                             data=config.DataConfig(batch_size=batch))
    return jcfg, cfg


def _flatten_optax(state):
    out = {}

    def walk(x):
        if hasattr(x, "mu"):
            out.update(count=x.count, mu=x.mu, nu=x.nu)
        elif hasattr(x, "sum_of_squares"):
            out.update(sum=x.sum_of_squares)
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


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    b = cfg.data.batch_size
    ids = np.stack([np.minimum(rng.zipf(1.3, size=b) - 1, v - 1)
                    for v in cfg.model.vocab_sizes], axis=1).astype(np.int32)
    ids += field_offsets(cfg.model)[None, :].astype(np.int32)
    return ids, (rng.random(b) < 0.4).astype(np.float32)


def _two_steps(jcfg, cfg, use_kernel=True):
    jstate = jax_train.create_state(jcfg, jax.random.key(0))
    state = state_from_jax(_np_state(jstate))
    initial = _np_state(jstate)
    jfn = jax_make_fn(use_pallas=True, bt=8, interpret=True) if use_kernel else None
    fn = make_interaction_fn() if use_kernel else None
    for seed in range(2):
        ids, labels = _batch(cfg, seed)
        jstate, jm = jax_train.train_step(jstate, jnp.asarray(ids), None,
                                          jnp.asarray(labels), jcfg, jfn)
        state, m = train.train_step(state, torch.from_numpy(ids), None,
                                    torch.from_numpy(labels), cfg, fn)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["logit_mean"]), float(jm["logit_mean"]),
                                   rtol=1e-4, atol=1e-6)
    assert state.step == 2
    return initial, _np_state(jstate), state


def _assert_states_close(initial, want, got):
    for name in ("conv", "tower"):
        for lw, lg in zip(want["params"][name], got.params[name]):
            for k in lw:
                np.testing.assert_allclose(lg[k].numpy(), lw[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.params["linear"]["bias"].numpy(),
                               want["params"]["linear"]["bias"], rtol=1e-5, atol=1e-6)
    tables = [("embed", "table")] + ([("linear", "table")]
                                     if "table" in want["params"]["linear"] else [])
    for group, key in tables:
        step_want = want["params"][group][key] - initial["params"][group][key]
        step_got = got.params[group][key].numpy() - initial["params"][group][key]
        np.testing.assert_allclose(step_got, step_want, atol=1e-2 * np.abs(step_want).max())
        untouched = (step_want == 0).all(axis=1)
        np.testing.assert_array_equal(step_got[untouched], 0.0)
    for group, st in want["sparse_opt_state"].items():
        for k, v in st.items():
            np.testing.assert_allclose(got.sparse_opt_state[group][k].numpy(), v,
                                       rtol=1e-3, atol=1e-3 * np.abs(v).max())
    for k, v in want["dense_opt_state"].items():
        g = got.dense_opt_state[k]
        for a, b in zip(train.tree_leaves(g), jax.tree.leaves(v)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-9)


ROUTES = {
    # name: (config kwargs, use_kernel)
    "hybrid": (dict(), True),
    "fm_rowwise_adam": (dict(sparse="rowwise_adam"), True),
    "batch_major": (dict(use_pallas=False), False),
    "batch_major_separate_linear": (dict(vocabs=SEVEN, stream="off"), True),
    "all_small": (dict(vocabs=ALL_SMALL), True),
    "scatter_adam": (dict(sparse="adam", stream="off", dense_opt="adagrad"), True),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_two_steps_match_jax(route):
    kw, use_kernel = ROUTES[route]
    jcfg, cfg = _cfgs(**kw)
    if route == "batch_major_separate_linear":
        assert not cfg.model.fused_linear
    if route == "all_small":
        assert cfg.model.small_field_prefix == cfg.model.num_fields
    ic.reset_launches()
    initial, want, got = _two_steps(jcfg, cfg, use_kernel)
    _assert_states_close(initial, want, got)
    assert ic.cross_conv1_bwd.launches == 0  # CPU: the plain backward ran


@pytest.mark.parametrize("sparse", ["adagrad", "sgd"])
def test_hybrid_equals_gather_route(sparse):
    """threshold 512 (hybrid) vs 0 (pure gather): the same math, the small
    fields' gradient summed in another association."""
    _, cfg_h = _cfgs(sparse=sparse, stream="off", batch=128)
    _, cfg_g = _cfgs(sparse=sparse, stream="off", batch=128, threshold=0)
    fn = make_interaction_fn()
    s_h = train.create_state(cfg_h, torch.Generator().manual_seed(0))
    s_g = train.create_state(cfg_g, torch.Generator().manual_seed(0))
    for seed in range(3):
        ids, labels = (torch.from_numpy(a) for a in _batch(cfg_h, seed))
        s_h, m_h = train.train_step(s_h, ids, None, labels, cfg_h, fn)
        s_g, m_g = train.train_step(s_g, ids, None, labels, cfg_g, fn)
        np.testing.assert_allclose(float(m_h["loss"]), float(m_g["loss"]), rtol=1e-6)
    torch.testing.assert_close(s_h.params["embed"]["table"], s_g.params["embed"]["table"],
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s_h.params["tower"][0]["w"], s_g.params["tower"][0]["w"],
                               rtol=1e-5, atol=1e-7)
    if sparse == "adagrad":
        torch.testing.assert_close(s_h.sparse_opt_state["embed"]["accum"],
                                   s_g.sparse_opt_state["embed"]["accum"],
                                   rtol=1e-5, atol=1e-6)


def test_table_gets_no_gradient_of_its_own():
    _, cfg = _cfgs()
    state = train.create_state(cfg, torch.Generator().manual_seed(1))
    ids, labels = (torch.from_numpy(a) for a in _batch(cfg, 0))
    state, _ = train.train_step(state, ids, None, labels, cfg, make_interaction_fn())
    table = state.params["embed"]["table"]
    assert not table.requires_grad and table.grad is None
    assert all(not p.requires_grad for p in train.tree_leaves(state.params))


def _tiny_cfg(**overrides):
    cfg = config.get_config("movielens")
    return dataclasses.replace(cfg, log_every=1, data=dataclasses.replace(
        cfg.data, batch_size=64, num_train_steps=3, eval_batches=2, **overrides))


def test_run_ends_on_the_cpu():
    logs = []
    result = train.run(_tiny_cfg(), device="cpu", log_fn=logs.append)
    assert result["count"] == 2 * 64
    assert np.isfinite([result["auc"], result["logloss"], result["final_train_loss"]]).all()
    steps = [json.loads(x) for x in logs if '"step"' in x]
    assert [s["step"] for s in steps] == [1, 2, 3]


def test_run_refuses_what_later_slices_bring(tmp_path, monkeypatch):
    """checkpoint_dir and tensorboard_dir are taken on the CPU; the
    hierarchical exchange runs now, and refuses a group that is no whole
    number of hosts (2 ranks of 4-card hosts) before any rendezvous."""
    cfg = dataclasses.replace(_tiny_cfg(), checkpoint_dir=str(tmp_path / "ckpt"),
                              tensorboard_dir=str(tmp_path / "tb"))
    result = train.run(cfg, device="cpu", log_fn=lambda s: None)
    assert np.isfinite(result["auc"])
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["3"]
    assert any(p.name.startswith("events.out.tfevents") for p in (tmp_path / "tb").iterdir())
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    hier = dataclasses.replace(_tiny_cfg(), sharding=dataclasses.replace(
        _tiny_cfg().sharding, table_sharded=True, table_axis="hier"))
    with pytest.raises(ValueError, match="2 ranks is not a whole number of hosts"):
        train.run(hier, device="cpu")


def test_cli_checkpoints_and_resumes(tmp_path):
    """--checkpoint_dir and --checkpoint_every through the command line: a
    rerun with more steps resumes from the latest checkpoint."""
    args = ["--config=movielens", "--device=cpu", "data.batch_size=32", "data.eval_batches=1",
            "log_every=1", f"--checkpoint_dir={tmp_path}", "--checkpoint_every=1"]
    assert cli_main(args + ["data.num_train_steps=2"]) == 0
    assert sorted(int(p.name) for p in tmp_path.iterdir()) == [1, 2]
    logs = []
    cfg = config.get_config("movielens")
    for item in args[2:] + ["data.num_train_steps=4"]:
        cfg = _apply_override(cfg, *item.removeprefix("--").split("=", 1))
    train.run(cfg, device="cpu", log_fn=logs.append)
    assert json.loads(logs[0])["resumed_from_step"] == 2
    assert [json.loads(x)["step"] for x in logs if '"loss"' in x] == [3, 4]
    assert sorted(int(p.name) for p in tmp_path.iterdir()) == [2, 3, 4]


def test_run_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(_tiny_cfg())


def test_cli_trains_with_dotted_overrides(capsys):
    rc = cli_main(["--config=movielens", "--device=cpu", "data.batch_size=32",
                   "--data.num_train_steps=2", "data.eval_batches=1", "log_every=0"])
    assert rc == 0
    assert '"eval"' in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown config field"):
        cli_main(["--config=movielens", "--device=cpu", "data.bogus=1"])
    with pytest.raises(SystemExit, match="unrecognized argument"):
        cli_main(["--config=movielens", "--device=cpu", "stray"])


def test_cli_profile_dir_writes_a_trace(tmp_path, capsys):
    """--profile_dir, which the JAX CLI takes, wraps the run in the port's
    torch.profiler trace."""
    rc = cli_main(["--config=movielens", f"--profile_dir={tmp_path / 'prof'}", "--device=cpu",
                   "data.batch_size=32", "data.num_train_steps=2", "data.eval_batches=1",
                   "log_every=1"])
    assert rc == 0
    assert '"eval"' in capsys.readouterr().out
    trace = tmp_path / "prof" / "trace.json"
    assert trace.exists() and json.loads(trace.read_text())["traceEvents"]


def test_cli_distributed_needs_torchrun(monkeypatch):
    """--distributed without torchrun's environment exits non-zero and
    says how to launch; with it, the flag is taken."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as exc:
        cli_main(["--config=movielens", "--distributed", "--device=cpu"])
    assert "torchrun" in str(exc.value.code) and exc.value.code != 0
    calls = []
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(train, "run", lambda cfg, device=None: calls.append(device) or {"auc": 0.5})
    assert cli_main(["--config=movielens", "--distributed", "--device=cpu"]) == 0
    assert calls == ["cpu"]


@pytest.mark.parametrize("sizes", [MIXED, (64,) * 13 + (1000,) * 2],
                         ids=["unequal_small_fields", "equal_small_fields"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_prefix_gradient_is_each_field_s_one_hot_product(sizes, dtype):
    """`train.prefix_grad`'s one batched product, bit for bit each small
    field's transposed one-hot product in the compute dtype, with ids
    outside their field's block adding nothing."""
    mcfg = config.ModelConfig(num_fields=len(sizes), vocab_sizes=sizes)
    fs, b, w = mcfg.small_field_prefix, 300, 128
    gen = torch.Generator().manual_seed(0)
    offs = np.cumsum((0,) + sizes[:fs - 1])
    ids = torch.stack([torch.randint(-3, n + 3, (b,), generator=gen) + int(o)
                       for n, o in zip(sizes[:fs], offs)]).to(torch.int32)
    g = torch.randn((fs, b, w), generator=gen).to(dtype)
    want = []
    for f, (n, o) in enumerate(zip(sizes[:fs], offs)):
        onehot = (torch.arange(n)[:, None] + int(o) == ids[f][None, :]).to(dtype)
        want.append(onehot @ g[f])
    got = train.prefix_grad(g, ids, mcfg)
    assert got.dtype == torch.float32 and got.shape == (mcfg.small_rows, w)
    assert torch.equal(got, torch.cat(want).float())


@pytest.mark.parametrize("sparse", ["adagrad", "sgd"])
@pytest.mark.parametrize("table_dtype,rounding", [(torch.float32, "nearest"),
                                                 (torch.bfloat16, "nearest"),
                                                 (torch.bfloat16, "stochastic")])
@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_the_prefix_update_through_the_apply_kernel_keeps_the_dense_form_s_bits(
        sparse, table_dtype, rounding, clip):
    """`train.prefix_update` takes kernel 4's apply from f32 sums (on the CPU
    its eager plain version): table and state bit for bit what
    `rowwise.dense_rowwise_apply` gives the first rows, with the same
    folded key; rows past them and rows of zero gradient keep their bits."""
    from cffm_tpu_torch.optim import rowwise

    opt = config.OptimizerConfig(sparse_optimizer=sparse, sparse_lr=0.05, clip_norm=clip,
                                 table_rounding=rounding)
    gen = torch.Generator().manual_seed(1)
    start = (0.01 * torch.randn((900, 256), generator=gen)).to(table_dtype)
    rows = 832
    g = 0.1 * torch.randn((rows, 256), generator=gen)
    g[5:40] = 0.0
    assert rowwise.apply_kernel_takes(start, opt)
    key = torch.Generator().manual_seed(2)
    table, state = start.clone(), rowwise.rowwise_init(start, opt)
    train.prefix_update(table, state, rows, g, opt, torch.tensor(0.5), key)
    want_state = rowwise.rowwise_init(start, opt)
    want, new = rowwise.dense_rowwise_apply(
        start[:rows].clone(), {k: v[:rows] for k, v in want_state.items()}, g, opt,
        lr_scale=torch.tensor(0.5), sr_key=rowwise.fold_in(key, 1))
    bits = torch.int16 if table_dtype == torch.bfloat16 else torch.int32
    assert torch.equal(table[:rows].view(bits), want.view(bits))
    assert torch.equal(table[rows:].view(bits), start[rows:].view(bits))
    assert torch.equal(table[5:40].view(bits), start[5:40].view(bits))
    for k, v in new.items():
        assert torch.equal(state[k][:rows], v), k
        assert torch.equal(state[k][rows:], want_state[k][rows:]), k

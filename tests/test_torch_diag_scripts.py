"""The port's diagnostic scripts on the CPU: check_onchip_parity,
profile_sparse, profile_sharded_step, trace_sharded, probe_gather,
probe_h2d and run_pending_experiments (`cffm_tpu_torch/scripts/`).

Where a script computes something, it is held against the JAX script's
own operations on the same numpy inputs (JAX on the CPU, Pallas in
interpret mode): profile_sparse's segment sums in f32 at rtol 1e-6 (two
sum orders of a few bf16 terms), kernel 3's plain version at one bf16 ulp
of the larger value with uids and count exact, the sparse update at rtol
1e-5. profile_sharded_step's `update` fragment equals the shipped sharded
step bit for bit. Every script's `main` refuses to run without a card.
"""

import ast
import dataclasses
import importlib
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu.ops.sorted_segment import sorted_segment_sum_compact as jax_compact
from cffm_tpu.ops.streamed_update import padded_entries as jax_padded_entries
from cffm_tpu.ops.streamed_update import pick_tile as jax_pick_tile
from cffm_tpu.optim.rowwise import rowwise_init as jax_rowwise_init
from cffm_tpu.optim.rowwise import rowwise_update as jax_rowwise_update
from cffm_tpu.optim.rowwise import unique_bound as jax_unique_bound
from cffm_tpu_torch.config import get_config
from cffm_tpu_torch.ops import interaction_conv as ic
from cffm_tpu_torch.optim.rowwise import rowwise_init, tree_leaves
from cffm_tpu_torch.parallel.mesh import close_mesh, free_port, make_mesh
from cffm_tpu_torch.parallel.sharded_train import (_make_flat_router, create_sharded_state,
                                                   make_sharded_train_step)
from cffm_tpu_torch.scripts import (check_onchip_parity, probe_gather, probe_h2d,
                                    profile_sharded_step, profile_sparse,
                                    run_pending_experiments, trace_sharded)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# F = 15 with a fused first-order column (table width 256) and three small fields
MIXED = (32, 64, 128) + (1000,) * 12


def _small(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_fields=len(MIXED), vocab_sizes=MIXED))


def _jax_assignment(script: str, func: str, name: str):
    """The value of `name = <literal>` inside `func` of scripts/<script>."""
    tree = ast.parse((ROOT / "scripts" / script).read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    node = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == name)
    return node.value


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# --- check_onchip_parity ----------------------------------------------------


@pytest.mark.parametrize("check", check_onchip_parity.CHECKS, ids=lambda c: c.__name__)
def test_onchip_parity_checks_pass_on_the_plain_versions(check):
    assert check("cpu")


def test_onchip_parity_cases_are_the_jax_scripts():
    cases = ast.literal_eval(_jax_assignment("check_onchip_parity.py", "check_sorted_segment",
                                             "cases"))
    assert tuple(tuple(c) for c in cases) == check_onchip_parity.SORTED_SEGMENT_CASES
    w = _jax_assignment("check_onchip_parity.py", "check_sorted_segment", "w")
    assert ast.literal_eval(w) == check_onchip_parity.SEGMENT_W


def test_onchip_parity_refuses_without_a_card(monkeypatch, capsys):
    _no_card(monkeypatch)
    assert check_onchip_parity.main([]) == 2
    out = capsys.readouterr().out
    assert "refusing" in out and "ONCHIP PARITY" not in out


def test_onchip_parity_interaction_case_has_the_fused_column():
    cfg, _, rows = check_onchip_parity._interaction_case(torch.device("cpu"))
    assert cfg.fused_linear and cfg.use_first_order
    assert tuple(rows.shape) == (256, 15, cfg.table_width)


# --- profile_sparse ---------------------------------------------------------


@pytest.fixture(scope="module")
def sparse_case():
    cfg = _small(get_config("criteo_kaggle"))
    x = profile_sparse.inputs(cfg, 64, "cpu")
    ids = x["flat_ids"].numpy()
    grads = x["grads"].float().numpy()  # bf16 values, exact in f32
    return cfg, x, ids, grads


def _jax_sorted(ids, grads):
    """The JAX script's sort, segment index and sorted grads."""
    flat_ids = jnp.asarray(ids)
    order = jnp.argsort(flat_ids)
    sid = flat_ids[order]
    is_first = jnp.concatenate([jnp.ones((1,), bool), sid[1:] != sid[:-1]])
    seg = jnp.cumsum(is_first) - 1
    return sid, seg, jnp.asarray(grads, jnp.bfloat16)[order]


def test_profile_sparse_segsum_equals_the_jax_scripts(sparse_case):
    _, x, ids, grads = sparse_case
    sid, seg, sgrad = _jax_sorted(ids, grads)
    n = ids.size
    want = jax.ops.segment_sum(sgrad.astype(jnp.float32), seg, num_segments=n,
                               indices_are_sorted=True)
    psid, pseg, psgrad = profile_sparse.sorted_stream(x["flat_ids"], x["grads"])
    np.testing.assert_array_equal(psid.numpy(), np.asarray(sid))
    np.testing.assert_array_equal(pseg.numpy(), np.asarray(seg))
    got = profile_sparse.segsum(psgrad, pseg, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)


def test_profile_sparse_segkernel_equals_the_jax_scripts(sparse_case):
    cfg, x, ids, grads = sparse_case
    mcfg = cfg.model
    batch = ids.size // mcfg.num_fields
    r = jax_pick_tile(mcfg.total_vocab)
    m_pad = jax_padded_entries(min(ids.size, jax_unique_bound(mcfg.vocab_sizes, batch)), r)
    assert profile_sparse.slots(cfg, batch) == m_pad
    sid, _, sgrad = _jax_sorted(ids, grads)
    uw, gw, cw = jax_compact(sid, sgrad, m_pad)
    psid, _, psgrad = profile_sparse.sorted_stream(x["flat_ids"], x["grads"])
    uids, gsum, count = profile_sparse.segkernel(psid, psgrad, m_pad)
    assert int(count) == int(cw)
    np.testing.assert_array_equal(uids.numpy(), np.asarray(uw))
    got, want = gsum.float().numpy(), np.asarray(gw, np.float32)
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.ldexp(1.0, np.frexp(np.maximum(big, 1e-30))[1] - 8)
    assert (np.abs(got - want) <= ulp).all()


def test_profile_sparse_update_equals_the_jax_scripts(sparse_case):
    cfg, x, ids, grads = sparse_case
    table = profile_sparse.table_of(cfg, "cpu")
    state = rowwise_init(table, cfg.optim)
    jt = jnp.asarray(table.numpy())
    jst = jax_rowwise_init(jt, cfg.optim)
    want_t, want_st = jax_rowwise_update(jt, jst, jnp.asarray(ids),
                                         jnp.asarray(grads, jnp.bfloat16), cfg.optim)
    profile_sparse.update(table, state, x["flat_ids"], x["grads"], cfg.optim)
    np.testing.assert_allclose(table.numpy(), np.asarray(want_t), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(state["accum"].numpy(), np.asarray(want_st["accum"]),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("sub", profile_sparse.SUBS)
def test_profile_sparse_subs_run_on_the_cpu(sparse_case, sub):
    cfg, x, _, _ = sparse_case
    assert profile_sparse.run(sub, cfg, 64, "cpu", x=x, n=1) > 0


def test_profile_sparse_refuses_an_unknown_sub():
    with pytest.raises(SystemExit):
        profile_sparse.main(["sort,bogus"])


# --- profile_sharded_step and trace_sharded ---------------------------------


@pytest.fixture(scope="module")
def group_of_one():
    mesh = make_mesh(init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
                     backend="gloo", device="cpu")
    yield mesh
    close_mesh(mesh)


def _sharded_cfg(batch=64):
    return _small(profile_sharded_step.profile_config(batch))


def test_profile_sharded_step_update_equals_the_shipped_step(group_of_one):
    cfg = _sharded_cfg()
    mcfg = cfg.model
    assert mcfg.table_dtype == "bfloat16" and 0 < mcfg.small_field_prefix < mcfg.num_fields
    fn = ic.make_interaction_fn()
    ids, dense, labels = profile_sharded_step.batch_of(cfg, "cpu")
    states = [create_sharded_state(cfg, torch.Generator().manual_seed(0), group_of_one)
              for _ in range(2)]
    for _ in range(2):  # two steps: the second runs from the first's state
        got, mg = profile_sharded_step.fragment("update", states[0], ids, dense, labels, cfg,
                                                _make_flat_router(cfg, group_of_one), fn)
        want, mw = make_sharded_train_step(cfg, group_of_one, fn)(states[1], ids, dense,
                                                                  labels)
        states = [got, want]
        assert got.step == want.step
        assert torch.equal(mg["loss"], mw["loss"]) and torch.equal(mg["overflow"],
                                                                   mw["overflow"])
        for tree in ("params", "dense_opt_state", "sparse_opt_state"):
            a, b = tree_leaves(getattr(got, tree)), tree_leaves(getattr(want, tree))
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                assert torch.equal(x, y), tree


def test_profile_sharded_step_stages_run_on_the_cpu(group_of_one, capsys):
    out = profile_sharded_step.run(list(profile_sharded_step.STAGES), _sharded_cfg(),
                                   group_of_one, device="cpu", n=1)
    assert set(out) == set(profile_sharded_step.STAGES)
    assert all(out[s] > 0 for s in profile_sharded_step.FRAGMENTS + ("real",))
    assert out["trace"] == 0.0 and "no device time" in capsys.readouterr().out


def test_profile_sharded_step_refuses_an_unknown_fragment(group_of_one):
    with pytest.raises(ValueError):
        profile_sharded_step.fragment("all", None, None, None, None, _sharded_cfg(), None, None)


def test_trace_sharded_reports_no_device_time_on_the_cpu(group_of_one, tmp_path, capsys,
                                                         monkeypatch):
    from cffm_tpu_torch.scripts.trace_step import report

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _small(trace_sharded.sharded_config("criteo_kaggle", 64))
    assert cfg.sharding.table_sharded
    prof = trace_sharded.capture(cfg, 1, str(tmp_path), group_of_one, device="cpu")
    assert report(prof, 1) == 0.0
    assert "no device time" in capsys.readouterr().out
    assert (tmp_path / "trace.json").exists()


# --- probe_gather -----------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe_gather_equals_index_select(dtype):
    table, ids = probe_gather.operands(5000, 777, 320, dtype, "cpu")
    assert ids.dtype == torch.int32 and bool((ids[1:] >= ids[:-1]).all())
    got = probe_gather.gather(table, ids)
    assert torch.equal(got, torch.index_select(table, 0, ids))


def test_probe_gather_bound_is_the_bytes_over_the_memory_rate():
    take = 1_277_952
    for dtype, size, want in ((torch.float32, 4, (0.39, 0.98, 1.95)),
                              (torch.bfloat16, 2, (0.195, 0.49, 0.98))):
        for w, ms in zip((128, 320, 640), want):
            nbytes = probe_gather.bytes_moved(take, w, dtype)
            assert nbytes == take * w * size * 2
            assert probe_gather.bound_ms(nbytes) == pytest.approx(nbytes / 3.35e12 * 1e3)
            assert probe_gather.bound_ms(nbytes) == pytest.approx(ms, abs=0.006)


def test_probe_gather_lines_and_scaling():
    lines = [probe_gather.gather_line(3000, 500, w, torch.float32, "cpu", n=1)
             for w in (128, 640)]
    for line, w in zip(lines, (128, 640)):
        assert line["width"] == w and line["dtype"] == "float32"
        assert line["bytes"] == 500 * w * 4 * 2
        assert line["bound_share"] == pytest.approx(line["bound_ms"] / line["value"])
        json.dumps(line)
    flat = [dict(lines[0], value=1.0), dict(lines[1], value=1.1)]
    linear = [dict(lines[0], value=1.0), dict(lines[1], value=4.6)]
    assert probe_gather.scaling_line(flat)["bound_by"] == "row count"
    assert probe_gather.scaling_line(linear)["bound_by"] == "bandwidth"


# --- probe_h2d --------------------------------------------------------------


def test_probe_h2d_needs_a_card(monkeypatch, capsys):
    with pytest.raises(ValueError):
        probe_h2d.run("cpu")
    _no_card(monkeypatch)
    assert probe_h2d.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_probe_h2d_batch_is_the_jax_probes():
    arrays = probe_h2d.host_batch()
    assert arrays["ids"].shape == (49152, 26) and arrays["ids"].dtype == np.int32
    assert arrays["dense"].shape == (49152, 13) and arrays["dense"].dtype == np.float32
    assert arrays["labels"].shape == (49152,)
    p = probe_h2d.packed(arrays)
    assert p.nbytes == sum(a.nbytes for a in arrays.values()) == 7_864_320
    np.testing.assert_array_equal(p[:, :104].copy().view(np.int32), arrays["ids"])


# --- run_pending_experiments ------------------------------------------------


def test_runner_lists_only_the_ports_commands():
    exps = run_pending_experiments.experiments("python")
    for name, cmd, timeout in exps:
        assert cmd[0] == "python" and timeout > 0
        module = cmd[cmd.index("-m") + 1]
        assert module.startswith("cffm_tpu_torch."), (name, cmd)
        assert not any("bts" in a for a in cmd)
    jax_names = [e.elts[0].value for e in _jax_assignment(
        "run_pending_experiments.py", "main", "experiments").elts]
    want = ["bench_kernel" if n == "kernel_bts" else n for n in jax_names]
    assert [e[0] for e in exps] == want


def test_runner_writes_under_build_never_docs(monkeypatch):
    out = run_pending_experiments.OUT
    assert out.is_relative_to(ROOT / "build") and not out.is_relative_to(ROOT / "docs")
    with pytest.raises(SystemExit):
        run_pending_experiments.main(["--out=docs/experiments.jsonl"])
    _no_card(monkeypatch)
    assert run_pending_experiments.main(["--only=probe_gather"]) == 1


def test_runner_stops_after_two_silent_failures(tmp_path):
    out = tmp_path / "runs.jsonl"
    py = sys.executable
    silent = [py, "-c", "import sys; sys.exit(3)"]
    loud = [py, "-c", "import sys; print('partial'); sys.exit(3)"]
    exps = [("ok", [py, "-c", "print('fine')"], 60), ("loud", loud, 60),
            ("silent1", silent, 60), ("silent2", silent, 60), ("never", silent, 60)]
    results = run_pending_experiments.sweep(exps, out, log=lambda *a, **k: None)
    assert [r["name"] for r in results] == ["ok", "loud", "silent1", "silent2"]
    assert [r["rc"] for r in results] == [0, 3, 3, 3]
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["name"] for r in recs] == ["ok", "loud", "silent1", "silent2"]
    assert recs[0]["tail"].strip() == "fine"


def test_runner_records_a_timeout(tmp_path):
    out = tmp_path / "runs.jsonl"
    rec = run_pending_experiments.run("slow", [sys.executable, "-c",
                                               "import time; time.sleep(30)"], 1, out,
                                      log=lambda *a, **k: None)
    assert rec["rc"] == -1 and "TIMEOUT" in rec["err_tail"]


# --- every script needs a card ----------------------------------------------


# each script's argv; its main must return nonzero without a card
NEEDS_A_CARD = {"profile_sparse": ["update"], "profile_sharded_step": [], "trace_sharded": [],
                "probe_gather": [], "probe_h2d": [], "run_pending_experiments": []}


@pytest.mark.parametrize("name", sorted(NEEDS_A_CARD))
def test_main_refuses_without_a_card(name, monkeypatch):
    _no_card(monkeypatch)
    module = importlib.import_module(f"cffm_tpu_torch.scripts.{name}")
    assert module.main(NEEDS_A_CARD[name]) != 0

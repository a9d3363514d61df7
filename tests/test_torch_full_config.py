"""criteo_full on the port, at a small size on the CPU.

The benchmark's configuration file is the repo's criteo_full key for key.
A criteo_full-shaped model (a 64-bucket prefix, the first-order column
fused into the padding: 15 fields of d=16 give 240 lanes, padded to 256;
a bf16 table rounded stochastically; big fields that take the scatter
route) trains three steps of `train.train_step` through the benchmark's
stochastic-rounding driver (`benchmark/drivers/train_sr.py`), held
against `benchmark/reference.train` on seeded random weights by the
cell's limits: stochastic rounding passes them and rounding to nearest
fails `sr_gain_gap`. Rows no id touches stay bit-equal, the rounded
writes run in the span cffm.table_round and the scatter route counts its
slots and rows. On CPU tensors `round_table_delta` draws today's bits; a
table past the draw limit is drawn in chunks that follow the one draw.

On the card (marker `card`, skipped without one) the dither of a CPU key
is drawn on the card, with nothing drawn on the host: run with `python -m
pytest --noconftest -m card tests/test_torch_full_config.py` (this file
imports no JAX).
"""

import copy
import dataclasses
import json
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cffm_tpu_torch import config as port_config
from cffm_tpu_torch import train
from cffm_tpu_torch.models import cffm as model_lib
from cffm_tpu_torch.ops import rounding
from cffm_tpu_torch.optim import rowwise
from cffm_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "full-train-zipf"
IDS = {"kind": "zipf", "a": 1.3, "hashed_from": 5,
       "cardinality": [64] * 5 + [3, 40, 900, 2000, 5000, 100000, 10**7, 12, 250, 60000]}


def _bench():
    import sys

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import checks, spec
    from benchmark.drivers import train_sr

    return checks, spec, train_sr


def _file():
    return json.loads((ROOT / "benchmark" / "configs" / "criteo_full.json").read_text())


def _small(rounding_mode="stochastic") -> dict:
    c = copy.deepcopy(_file())
    c["model"].update(num_fields=15, vocab_sizes=[64] * 5 + [2000] * 10, conv_channels=[8, 8],
                      tower_hidden=[16, 8], num_dense=3)
    c["optim"]["table_rounding"] = rounding_mode
    return c


def _job(seed=6, rounding_mode="stochastic", **kw):
    _, spec, _ = _bench()
    return spec.Job(workload=CELL, seed=seed, seconds=0.2, trace=False,
                    config=_small(rounding_mode),
                    traffic={"driver": "train_sr", "ids": IDS, "batch_size": 256,
                             "pool_batches": 4, "trace_steps": 2},
                    limits=spec.load_json(ROOT / "benchmark" / "checks" / f"{CELL}.json"),
                    device=torch.device("cpu"), **kw)


def test_the_benchmark_file_is_the_repos_criteo_full():
    _, spec, _ = _bench()
    job = _job()
    job.config = _file()
    assert job.train_config() == port_config.get_config("criteo_full")
    m = port_config.get_config("criteo_full").model
    assert (m.total_vocab, m.table_width, m.table_dtype) == (26_000_832, 640, "bfloat16")
    assert spec.cell(spec.benchmark(), CELL)["config_entry"]["reduced"] == []


@pytest.mark.parametrize("rounding_mode", ["stochastic", "nearest"])
def test_three_steps_against_the_reference(rounding_mode):
    """Stochastic rounding passes every limit of the cell; rounding to
    nearest drops the sub-ulp changes and fails sr_gain_gap."""
    checks, _, train_sr = _bench()
    job = _job(rounding_mode=rounding_mode)
    res = train_sr.run(job)
    ok, compared = checks.judge(res["numbers"], job.limits)
    assert res["numbers"]["untouched_rows_changed"] == 0 and res["failed"] == 0
    if rounding_mode == "stochastic":
        assert ok, compared
    else:
        assert not ok and res["numbers"]["sr_gain_gap"] > job.limits["sr_gain_gap"], compared


def _state_and_batches(seed=3, b=256):
    """A train state of the small config and three batches of its ids."""
    _bench()
    from benchmark import weights
    from benchmark.drivers import train as base

    job = _job(seed=seed)
    cfg = job.train_config()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=b))
    host, pool, _ = base.make_pool(job)
    params = weights.make_params(job.model, seed, job.device)
    table = params["embed"]["table"]
    state = train.TrainState(
        0, params, rowwise.make_dense_optimizer(cfg.optim).init(train.split_dense_params(params)),
        {"embed": rowwise.rowwise_init(table, cfg.optim)})
    return cfg, state, host, pool


def test_untouched_rows_stay_bit_equal():
    cfg, state, host, pool = _state_and_batches()
    table = state.params["embed"]["table"]
    before = table.clone()
    fn = train.default_interaction_fn(cfg)
    for batch in pool[:3]:
        state, _ = train.train_step(state, *batch, cfg, fn)
    touched = torch.zeros(table.shape[0], dtype=torch.bool)
    for ids in host[:3]:
        touched[torch.from_numpy(ids).long().reshape(-1)] = True
    assert table.dtype == torch.bfloat16
    assert torch.equal(table[~touched].view(torch.int16), before[~touched].view(torch.int16))
    assert (table[touched] != before[touched]).any(dim=1).float().mean() > 0.5


def test_the_rounded_writes_run_in_their_span_and_the_scatter_route_counts():
    """One step: the touched rows' and the prefix's rounded writes are two
    cffm.table_round spans inside cffm.sparse_update; the scatter route
    counts itself once, that it took its kernels (bf16 grads, a 256-lane
    bf16 table), the slots its sums were sized to (the live rows) and its
    rows."""
    cfg, state, host, pool = _state_and_batches()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train.train_step(state, *pool[0], cfg, train.default_interaction_fn(cfg))
    counts = profiling.counts()
    profiling.reset()
    events = prof.events()
    spans = [e for e in events if e.name == "cffm.table_round"]
    upd = [e for e in events if e.name == "cffm.sparse_update"]
    assert len(spans) == 2 and len(upd) == 1
    assert all(upd[0].time_range.start <= s.time_range.start
               and s.time_range.end <= upd[0].time_range.end for s in spans)
    big = host[0][:, 5:]
    distinct = sum(len(set(big[:, f].tolist())) for f in range(big.shape[1]))
    assert counts == {"sparse.scatter": 1, "sparse.scatter_kernels": 1,
                      "sparse.scatter_slots": distinct, "sparse.scatter_rows": distinct}


@pytest.mark.parametrize("with_sentinels", [False, True])
def test_a_plan_made_ahead_is_the_update_s_own(with_sentinels):
    """The scatter route with `scatter_plan` made before the forward (as
    the train step makes it) writes the table and the accumulator bit for
    bit as with the plan made inside; the sentinel (>= the table's rows)
    and the ids' order change nothing."""
    gen = torch.Generator().manual_seed(8)
    opt = port_config.OptimizerConfig(sparse_optimizer="adagrad", streamed_update="off",
                                      table_rounding="stochastic")
    ids = torch.randint(0, 300, (1024,), generator=gen, dtype=torch.int32)
    if with_sentinels:
        ids[::7] = 300
    grads = torch.randn((1024, 256), generator=gen).to(torch.bfloat16)
    out = []
    for ahead in (False, True):
        table = (0.01 * torch.randn((300, 256), generator=torch.Generator().manual_seed(1))
                 ).to(torch.bfloat16)
        state = rowwise.rowwise_init(table, opt)
        plan = rowwise.scatter_plan(ids, 300, 700) if ahead else None
        rowwise.rowwise_update(table, state, ids, grads, opt, max_unique=700,
                               mask_sentinels=False, sr_key=torch.Generator().manual_seed(3),
                               plan=plan)
        out.append((table, state["accum"]))
    assert torch.equal(out[0][0].view(torch.int16), out[1][0].view(torch.int16))
    assert torch.equal(out[0][1], out[1][1])


def test_round_table_delta_on_cpu_keeps_todays_draw():
    """A CPU key on CPU rows: the dither is the key's own draw of
    randint(0, 2^16) int32, bit for bit, and counted as drawn on the CPU."""
    gen = torch.Generator().manual_seed(1234)
    rows = (0.01 * torch.randn((37, 256), generator=gen)).to(torch.bfloat16)
    delta = 1e-5 * torch.randn((37, 256), generator=gen)
    want = rounding.stochastic_round_bf16(
        rows.float() + delta,
        torch.randint(0, 1 << 16, (37, 256), generator=torch.Generator().manual_seed(99),
                      dtype=torch.int32))
    drawn = dict(rounding.DRAWS)
    got = rounding.round_table_delta(rows, delta, torch.bfloat16, "stochastic",
                                     torch.Generator().manual_seed(99))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert rounding.DRAWS["cpu"] == drawn["cpu"] + 1 and rounding.DRAWS["cuda"] == drawn["cuda"]


@pytest.mark.parametrize("separate_linear", [False, True])
def test_a_table_past_the_draw_limit_is_drawn_in_chunks(monkeypatch, separate_linear):
    """Past INIT_DRAW_BYTES a one-card table is drawn INIT_ROWS rows a
    call (criteo_full's 26M x 640 rows: one f32 draw would not fit beside
    the bf16 table); on the CPU's generator the chunks follow the one
    draw's stream, so the state is the one draw's, bit for bit."""
    cfg = port_config.get_config("criteo_full")
    vocab = (64,) * 13 + (300,) * 26
    mcfg = dataclasses.replace(cfg.model, vocab_sizes=vocab, conv_channels=(8, 8),
                               tower_hidden=(16, 8),
                               **({"embed_dim": 8, "num_fields": 39} if separate_linear else {}))
    assert mcfg.fused_linear != separate_linear
    one = model_lib.init_params(mcfg, torch.Generator().manual_seed(4))
    monkeypatch.setattr(model_lib, "INIT_DRAW_BYTES", 0)
    monkeypatch.setattr(model_lib, "INIT_ROWS", 1024)
    chunked = model_lib.init_params(mcfg, torch.Generator().manual_seed(4))
    assert mcfg.total_vocab % 1024  # a partial last chunk
    for a, b in zip(rowwise.tree_leaves(one), rowwise.tree_leaves(chunked)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert one["embed"]["table"].dtype == torch.bfloat16


# --- on the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_the_dither_is_drawn_on_the_card(card):
    """CUDA rows and the step's CPU key: the dither is drawn by a
    generator on the card (one seed from the key), with no draw on the
    host and no copy to the card; the same key gives the same bits."""
    gen = torch.Generator(device=card).manual_seed(5)
    rows = (0.01 * torch.randn((4096, 640), generator=gen, device=card)).to(torch.bfloat16)
    delta = 1e-6 * torch.randn((4096, 640), generator=gen, device=card)
    drawn = dict(rounding.DRAWS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a = rounding.round_table_delta(rows, delta, torch.bfloat16, "stochastic",
                                       torch.Generator().manual_seed(7))
        torch.cuda.synchronize()
    b = rounding.round_table_delta(rows, delta, torch.bfloat16, "stochastic",
                                   torch.Generator().manual_seed(7))
    assert rounding.DRAWS["cuda"] == drawn["cuda"] + 2 and rounding.DRAWS["cpu"] == drawn["cpu"]
    assert a.device == card and torch.equal(a.view(torch.int16), b.view(torch.int16))
    copies = [e for e in prof.events() if "HtoD" in e.name or "Memcpy HtoD" in e.name]
    assert not copies, [e.name for e in copies]
    # some sub-ulp changes round away from the row, most stay: the rounding dithers
    moved = (a != rows).float().mean()
    assert 0.0 < moved < 0.5

"""The stochastic-rounding training driver (`benchmark/drivers/train_sr.py`)
and its two metrics: the numbers that decide `correct` on planted rows
(an unbiased rounding, no change, a doubled change, rounding to
nearest), the compact reference against the whole table's, a sound tiny
run on the CPU against the cell's limits, each fault and the control
failing them, a port that draws the dither on the host (or cannot say
where it draws it) stopped on a card, and the readers of `table_round_ms.train` and
`scatter_slot_use.train` on synthetic traces and counters."""

import copy
import json
import math
import pathlib
import types

import pytest
import torch

from benchmark import checks, faults, readers, spec, trace
from benchmark.drivers import train as base
from benchmark.drivers import train_sr

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "full-train-zipf"
TINY_IDS = {"kind": "zipf", "a": 1.3, "hashed_from": 5,
            "cardinality": [64] * 5 + [3, 40, 900, 2000, 5000, 100000, 10**7, 12, 250, 60000]}
TINY_TRAFFIC = {"driver": "train_sr", "ids": TINY_IDS, "batch_size": 256, "pool_batches": 4,
                "trace_steps": 2}


def tiny_full_config(**model) -> dict:
    """criteo_full's file with 15 fields (5 of 64 ids, 10 of 2000), d=16
    (240 lanes padded to 256, the first-order column fused), conv (8, 8),
    tower (16, 8) and 3 dense inputs: a bf16 table rounded stochastically,
    the big fields on the scatter route."""
    c = copy.deepcopy(spec.load_json(ROOT / "benchmark" / "configs" / "criteo_full.json"))
    c["model"].update(num_fields=15, vocab_sizes=[64] * 5 + [2000] * 10, conv_channels=[8, 8],
                      tower_hidden=[16, 8], num_dense=3, **model)
    return c


def tiny_job(seed=6, config=None, **kw):
    args = dict(workload=CELL, seed=seed, seconds=0.3, trace=False,
                config=config or tiny_full_config(), traffic=dict(TINY_TRAFFIC),
                limits=spec.load_json(ROOT / "benchmark" / "checks" / f"{CELL}.json"),
                device=torch.device("cpu"))
    args.update(kw)
    return spec.Job(**args)


def _planted(n=4096, w=256, seed=0):
    """rows0 as bf16 values and reference changes: most under a tenth of
    an ulp, some of 5-20 ulps."""
    gen = torch.Generator().manual_seed(seed)
    rows0 = (0.01 * torch.randn((n, w), generator=gen)).to(torch.bfloat16).float()
    ulp = train_sr.bf16_ulp(rows0)
    frac = torch.rand((n, w), generator=gen) * 0.1
    big = torch.rand((n, w), generator=gen) < 0.05
    frac = torch.where(big, 5 + 15 * torch.rand((n, w), generator=gen), frac)
    sign = torch.where(torch.rand((n, w), generator=gen) < 0.5, -1.0, 1.0)
    return rows0, rows0 + sign * frac * ulp, gen


def _stochastic(x, gen):
    from cffm_tpu_torch.ops import rounding

    return rounding.stochastic_round_bf16(x, rounding.random_dither(x.shape, gen, "cpu")).float()


@pytest.mark.parametrize("case, gain, moved", [("unbiased", (0.0, 0.03), (0.0, 0.1)),
                                               ("unchanged", (1.0, 1.0), (1.0, 1.0)),
                                               ("doubled", (0.9, 1.1), (0.9, 1.1)),
                                               ("nearest", (0.95, 1.0), (0.0, 0.1))])
def test_the_rounding_numbers_on_planted_rows(case, gain, moved):
    rows0, ref, gen = _planted()
    prog = {"unbiased": lambda: _stochastic(ref, gen),
            "unchanged": lambda: rows0.clone(),
            "doubled": lambda: _stochastic(rows0 + 2 * (ref - rows0), gen),
            "nearest": lambda: ref.to(torch.bfloat16).float()}[case]()
    n = train_sr.rounding_numbers(prog, ref, rows0)
    assert gain[0] <= n["sr_gain_gap"] <= gain[1], n
    assert moved[0] <= n["moved_gap"] <= moved[1], n


def test_bf16_ulp():
    x = torch.tensor([1.0, 1.5, -2.0, 0.01, 3e-30])
    want = torch.tensor([2.0**-7, 2.0**-7, 2.0**-6, 2.0**-14, 2.0**-106])
    assert torch.equal(train_sr.bf16_ulp(x), want)


def test_the_compact_reference_is_the_whole_tables():
    """The reference trained on the touched rows alone, ids remapped,
    equals it trained on the whole table (f32, cast as drawn)."""
    job = tiny_job(seed=8)
    host, pool, _ = base.make_pool(job)
    batches = pool[:train_sr.CHECK_STEPS]
    rows = base.touched_ids(host[:train_sr.CHECK_STEPS], job.device)
    whole = base.reference_readings(job, batches, rows)
    compact = train_sr.reference_readings(job, batches, rows)
    torch.testing.assert_close(compact["rows0"], whole["rows0"], rtol=0, atol=0)
    torch.testing.assert_close(compact["rows"], whole["rows"], rtol=1e-6, atol=1e-9)
    assert compact["loss"] == pytest.approx(whole["loss"], rel=1e-6)
    for k in whole["grad"]:
        assert compact["grad"][k] == pytest.approx(whole["grad"][k], rel=1e-5), k
    # the whole table's check counts its change from the f32 draw, before the cast
    whole["change"]["embed.table"] = float((whole["rows"] - whole["rows0"]).norm())
    for k in whole["change"]:
        assert compact["change"][k] == pytest.approx(whole["change"][k], rel=1e-5), k


def _run(job):
    res = spec.driver(job.traffic).run(job)
    return res, checks.judge(res["numbers"], job.limits)[0] and res["failed"] == 0


def test_a_sound_run_is_correct():
    res, ok = _run(tiny_job())
    assert ok, res["numbers"]
    assert res["numbers"]["untouched_rows_changed"] == 0 and res["attempted"] > 0


def test_rounding_to_nearest_fails_sr_gain_gap():
    cfg = tiny_full_config()
    cfg["optim"]["table_rounding"] = "nearest"
    job = tiny_job(config=cfg)
    res, ok = _run(job)
    assert not ok and res["numbers"]["sr_gain_gap"] > job.limits["sr_gain_gap"], res["numbers"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "doubled_row_grads"])
def test_each_fault_is_caught(fault):
    res, ok = _run(tiny_job(seed=12, wrap_step=faults.FAULTS[fault]))
    assert not ok, (fault, res["numbers"])


def test_the_control_fails_the_limits():
    job = tiny_job(seed=13)
    numbers = train_sr.control_numbers(job)
    assert not checks.judge(numbers, job.limits)[0], numbers
    assert numbers["sr_gain_gap"] > job.limits["sr_gain_gap"]
    json.dumps(numbers)  # benchmark/control.py prints them whole


def test_the_cell_resolves_to_the_driver():
    cell = spec.cell(spec.benchmark(), CELL)
    assert spec.driver(cell["traffic"]) is train_sr
    assert cell["config"]["name"] == "criteo_full" and cell["workload"]["chips"] == 1
    names = [m["name"] for m in spec.benchmark()["per_layer"] if spec.applies(m, CELL)]
    assert {"table_round_ms.train", "scatter_slot_use.train"} <= set(names)
    assert not {"k3_roofline.train", "k4_roofline.train", "slot_use.train"} & set(names)


def _card_job():
    return tiny_job(device=torch.device("cuda", 0))


def _draws(**counts):
    return types.SimpleNamespace(DRAWS=dict({"cpu": 0, "cuda": 0}, **counts))


def test_a_port_without_dither_counts_stops_on_a_card(capsys):
    with pytest.raises(SystemExit) as stop:
        train_sr.card_draws(types.SimpleNamespace(), _card_job())
    assert stop.value.code == 2 and "ops/rounding.DRAWS" in capsys.readouterr().err


def test_the_cpu_reads_no_dither_counts():
    assert train_sr.card_draws(types.SimpleNamespace(), tiny_job()) is None
    train_sr.check_card_draws(_draws(cpu=5), tiny_job(), None)


@pytest.mark.parametrize("after, stops", [({"cuda": 6}, False), ({"cuda": 6, "cpu": 1}, True),
                                          ({}, True), ({"cpu": 6}, True)])
def test_the_check_steps_draw_their_dither_on_the_card(after, stops):
    job, port = _card_job(), _draws(cpu=2, cuda=10)
    before = train_sr.card_draws(port, job)
    for k, v in after.items():
        port.DRAWS[k] += v
    if stops:
        with pytest.raises(SystemExit) as stop:
            train_sr.check_card_draws(port, job, before)
        assert stop.value.code == 2
    else:
        train_sr.check_card_draws(port, job, before)


# --- the two metrics ---------------------------------------------------------

P = 20_000


def _host(steps=3, kids=2, start=1_000_000):
    """A cffm.step a step holding `kids` cffm.table_round spans, each
    launching one record; one launch outside them."""
    out = []
    for k in range(steps):
        s = start + k * P
        out += [("cffm.step", s, s + 9_000), ("cudaLaunchKernel", s + 500, s + 510)]
        for j in range(kids):
            a = s + 1_000 + 3_000 * j
            out += [("cffm.table_round", a, a + 2_000), ("cudaLaunchKernel", a + 100, a + 110)]
    return out


def _device(steps=3, kids=2):
    """Each launch's record on the device's clock: 1 us each, in order."""
    out = []
    for k in range(steps):
        t = 50_000_000 + k * 25_000
        out += [("x", t, t + 1_000)] + [("r", t + 2_000 + 2_000 * j, t + 3_000 + 2_000 * j)
                                         for j in range(kids)]
    return out


def _trace_run(items, host=(), device=()):
    run = readers.Run(model={}, train=True, window_s=1.0, window_examples=1)
    run.items = [{"batch": 1}] * items
    run.trace = trace.Trace(0, 10**9, device=list(device), host=list(host))
    return run


def _read(name, run):
    return spec.metric_module(name).read(run)


def test_table_round_ms_sums_the_spans_of_a_step():
    assert _read("table_round_ms.train", _trace_run(3, _host(), _device())) \
        == pytest.approx(0.002)
    assert _read("table_round_ms.train", _trace_run(3, _host(kids=1), _device(kids=1))) \
        == pytest.approx(0.001)


@pytest.mark.parametrize("case", ["no_span", "a_step_without", "records_unmatched", "no_trace"])
def test_table_round_ms_returns_none_when_there_is_nothing_to_read(case):
    host, device = _host(), _device()
    if case == "no_span":
        host = [h for h in host if h[0] != "cffm.table_round"]
    elif case == "a_step_without":
        host = [h for h in host if not (h[0] == "cffm.table_round" and h[1] > 1_000_000 + P)]
    elif case == "records_unmatched":
        device = device[:-1]
    run = _trace_run(3, host, device)
    if case == "no_trace":
        run.trace = None
    assert _read("table_round_ms.train", run) is None


@pytest.fixture
def counters(monkeypatch):
    from cffm_tpu_torch.utils import profiling

    def put(totals):
        monkeypatch.setattr(profiling, "counts", lambda: dict(totals))

    return put


def test_scatter_slot_use_is_rows_over_slots(counters):
    counters({"sparse.scatter": 2, "sparse.scatter_slots": 4096, "sparse.scatter_rows": 250})
    assert _read("scatter_slot_use.train", _trace_run(2)) == pytest.approx(100.0 * 250 / 4096)


@pytest.mark.parametrize("totals", [
    {"sparse.scatter": 1, "sparse.scatter_slots": 4096, "sparse.scatter_rows": 250},
    {"sparse.scatter": 2, "sparse.scatter_rows": 250},
    {"sparse.scatter": 2, "sparse.scatter_slots": 4096},
    {"sparse.streamed": 2, "sparse.slots": 4096, "sparse.distinct_rows": 250}])
def test_scatter_slot_use_returns_none_unless_every_step_scattered(counters, totals):
    counters(totals)
    assert _read("scatter_slot_use.train", _trace_run(2)) is None


@pytest.mark.parametrize("name", ["table_round_ms.train", "scatter_slot_use.train"])
def test_each_reader_returns_none_from_a_port_without_the_counters(monkeypatch, name):
    from cffm_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counts")
    assert _read(name, _trace_run(3, [("cudaLaunchKernel", 10, 11)], [("k", 20, 30)])) is None


def test_first_grads_read_the_table_from_the_accumulator():
    """sqrt(W * sum(accum - init)) is the norm of the rows' summed gradients."""
    g = torch.randn(5, 8, dtype=torch.float64)
    acc = 0.1 + (g * g).mean(dim=1, keepdim=True)
    state = type("S", (), {"dense_opt_state": {"mu": {"conv": [], "tower": [],
                                                      "linear_bias": torch.zeros(())}},
                           "sparse_opt_state": {"embed": {"accum": acc}}})()
    got = train_sr.first_grads(state, {"adam_b1": 0.9, "adagrad_init": 0.1}, 8)
    assert got["embed.table"] == pytest.approx(float(g.norm()), rel=1e-9)
    assert math.isfinite(got["linear.bias"])

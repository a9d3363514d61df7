"""The port's spans and counters (`cffm_tpu_torch.utils.profiling`) on the
CPU: they record nothing without a profiler; under one, the spans nest in
the profiler's records, the streamed sparse update counts its slots and
distinct rows, and the train step and the forward give bit-equal results
with the profiler on and off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cffm_tpu_torch import config, train
from cffm_tpu_torch.models import cffm as model_lib
from cffm_tpu_torch.ops.interaction_conv import make_interaction_fn
from cffm_tpu_torch.ops.streamed_update import padded_entries, pick_tile
from cffm_tpu_torch.optim import rowwise
from cffm_tpu_torch.utils import profiling

MIXED = (32, 64, 128) + (1000,) * 12          # F=15: fused column, 3 small fields
SEVEN = (61, 40, 2, 8, 22, 35, 19)           # F=7: no fused column, a linear table
STEP_CHILDREN = ["cffm.lookup", "cffm.forward", "cffm.conv_tail", "cffm.backward",
                 "cffm.dense_update", "cffm.sparse_update"]


@pytest.fixture(autouse=True)
def _empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _cfg(vocabs=MIXED, sparse="adagrad", stream="on", compute="float32", batch=64, **model_kw):
    return config.TrainConfig(
        name="t",
        model=config.ModelConfig(num_fields=len(vocabs), vocab_sizes=vocabs, embed_dim=16,
                                 cross="field_aware", conv_channels=(16,), tower_hidden=(32,),
                                 compute_dtype=compute, small_field_threshold=512, **model_kw),
        optim=config.OptimizerConfig(sparse_optimizer=sparse, streamed_update=stream),
        data=config.DataConfig(batch_size=batch))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    b = cfg.data.batch_size
    ids = np.stack([np.minimum(rng.zipf(1.3, size=b) - 1, v - 1)
                    for v in cfg.model.vocab_sizes], axis=1).astype(np.int32)
    ids += model_lib.field_offsets(cfg.model)[None, :].astype(np.int32)
    return torch.from_numpy(ids), torch.from_numpy((rng.random(b) < 0.4).astype(np.float32))


def _named(prof):
    """The profiler's host records of the port's spans: [(name, start, end)]."""
    return sorted(((e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("cffm.")), key=lambda r: r[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_off_span_and_count_record_nothing():
    assert not torch.autograd._profiler_enabled()
    first, second = profiling.span("cffm.step"), profiling.span("cffm.lookup")
    assert first is second is profiling._NO_SPAN
    with first:
        assert profiling.count("sparse.slots", 5) is None
        profiling.count("sparse.distinct_rows", torch.tensor(3))
    assert profiling.counts() == {}


def test_spans_nest_in_the_profilers_records():
    with _profiled() as prof:
        for _ in range(2):
            with profiling.span("cffm.step"):
                with profiling.span("cffm.lookup"):
                    pass
                with profiling.span("cffm.forward"):
                    with profiling.span("cffm.inner"):
                        pass
        with profiling.span("cffm.forward"):
            pass
    recs = _named(prof)
    assert [r[0] for r in recs] == ["cffm.step", "cffm.lookup", "cffm.forward",
                                    "cffm.inner"] * 2 + ["cffm.forward"]
    for k in (0, 4):
        step = recs[k]
        assert all(_inside(r, step) for r in recs[k + 1:k + 4])
        assert _inside(recs[k + 3], recs[k + 2]) and not _inside(recs[k + 3], recs[k + 1])
    assert not _inside(recs[8], recs[4])


def test_a_span_left_by_an_exception_is_closed():
    with _profiled() as prof:
        with pytest.raises(ValueError):
            with profiling.span("cffm.step"):
                raise ValueError("boom")
        with profiling.span("cffm.forward"):
            pass
    step, fwd = _named(prof)
    assert step[0] == "cffm.step" and fwd[0] == "cffm.forward"
    assert step[2] <= fwd[1]


def test_counts_add_host_numbers_and_sum_device_tensors_late():
    t = torch.tensor(4, dtype=torch.int32)
    with _profiled():
        profiling.count("sparse.streamed")
        profiling.count("sparse.streamed")
        profiling.count("sparse.slots", 128)
        profiling.count("sparse.distinct_rows", t)
        profiling.count("sparse.distinct_rows", torch.tensor([2, 3]))
    t += 10     # kept by reference: summed when counts() is read
    assert profiling.counts() == {"sparse.streamed": 2, "sparse.slots": 128,
                                  "sparse.distinct_rows": 19}


def test_reset_forgets_the_counts():
    with _profiled():
        profiling.count("sparse.slots", 7)
    profiling.reset()
    assert profiling.counts() == {}
    with _profiled():
        profiling.count("sparse.slots", 3)
    assert profiling.counts() == {"sparse.slots": 3}


@pytest.mark.parametrize("field_major", [False, True])
def test_streamed_update_counts_slots_and_distinct_rows(field_major):
    vocabs = (300, 500, 200, 1000)
    offs = np.concatenate([[0], np.cumsum(vocabs)[:-1]])
    b, w = 512, 128
    rng = np.random.default_rng(3)
    local = np.stack([np.minimum(rng.zipf(1.3, size=b) - 1, v - 1) for v in vocabs], axis=1)
    glob = (local + offs[None, :]).astype(np.int32)                     # (B, F)
    block = glob.T if field_major else glob
    table = torch.randn(int(sum(vocabs)), w) * 0.01
    opt = config.OptimizerConfig(sparse_optimizer="adagrad", streamed_update="on")
    state = rowwise.rowwise_init(table, opt)
    bound = rowwise.unique_bound(vocabs, b)
    with _profiled():
        rowwise.rowwise_update(table, state, torch.from_numpy(block.reshape(-1)),
                               torch.randn(b * len(vocabs), w), opt, max_unique=bound,
                               field_offsets=tuple(int(o) for o in offs),
                               mask_sentinels=False, field_major=field_major)
    counts = profiling.counts()
    distinct = sum(np.unique(glob[:, f]).size for f in range(len(vocabs)))
    assert counts == {"sparse.streamed": 1,
                      "sparse.slots": padded_entries(min(b * len(vocabs), bound),
                                                     pick_tile(table.shape[0])),
                      "sparse.distinct_rows": distinct}


def _scatter_counts(grads_dtype):
    """The counters of one scatter-route update of 256 ids into a 4000 x
    128 table, and the ids' distinct rows."""
    table = torch.randn(4000, 128) * 0.01
    opt = config.OptimizerConfig(sparse_optimizer="adagrad", streamed_update="off")
    ids = torch.randint(0, 4000, (256,))
    with _profiled():
        rowwise.rowwise_update(table, rowwise.rowwise_init(table, opt), ids,
                               torch.randn(256, 128).to(grads_dtype), opt)
    return profiling.counts(), int(torch.unique(ids).numel())


def test_the_scatter_route_counts_nothing():
    """Nothing of the streamed route's counters: the scatter route counts
    itself, that it took its kernels (bf16 grads), the slots its segment
    sums were sized to (the live rows) and the rows it wrote."""
    counts, rows = _scatter_counts(torch.bfloat16)
    assert counts == {"sparse.scatter": 1, "sparse.scatter_kernels": 1,
                      "sparse.scatter_slots": rows, "sparse.scatter_rows": rows}


def test_the_scatter_route_s_eager_sums_count_a_slot_per_id():
    """f32 grads keep the eager code, whose sums take a slot per id; no
    sparse.scatter_kernels."""
    counts, rows = _scatter_counts(torch.float32)
    assert counts == {"sparse.scatter": 1, "sparse.scatter_slots": 256,
                      "sparse.scatter_rows": rows}


def _state(cfg, seed=0):
    return train.create_state(cfg, torch.Generator().manual_seed(seed))


def _leaves(state):
    return ([state.params["embed"]["table"]]
            + ([state.params["linear"]["table"]] if "table" in state.params["linear"] else [])
            + train.tree_leaves(train.split_dense_params(state.params))
            + train.tree_leaves(state.dense_opt_state)
            + train.tree_leaves(state.sparse_opt_state))


STEP_ROUTES = {
    "hybrid": dict(),
    "hybrid_bf16": dict(compute="bfloat16"),
    "fm_rowwise_adam": dict(sparse="rowwise_adam"),
    "batch_major": dict(use_pallas=False),
    "batch_major_separate_linear": dict(vocabs=SEVEN, stream="off"),
}


@pytest.mark.parametrize("route", sorted(STEP_ROUTES))
def test_train_step_is_bit_equal_with_the_profiler_on(route):
    cfg = _cfg(**STEP_ROUTES[route])
    fn = train.default_interaction_fn(cfg)
    out = []
    for on in (False, True):
        state = _state(cfg)
        losses = []
        with (_profiled() if on else profiling._NO_SPAN) as prof:
            for seed in range(2):
                ids, labels = _batch(cfg, seed)
                state, m = train.train_step(state, ids, None, labels, cfg, fn)
                losses.append(m["loss"])
        out.append((losses, _leaves(state)))
    for a, b in zip(out[0][0] + out[0][1], out[1][0] + out[1][1]):
        assert torch.equal(a, b)
    recs = _named(prof)
    steps = [r for r in recs if r[0] == "cffm.step"]
    assert len(steps) == 2 and not _inside(steps[1], steps[0])
    # the conv tail's span is the interaction fn's: the reference conv stack has none
    want = [n for n in STEP_CHILDREN if fn is not None or n != "cffm.conv_tail"]
    for step in steps:
        assert [r[0] for r in recs if r is not step and _inside(r, step)] == want


def test_train_step_counts_the_streamed_update_of_the_big_fields():
    cfg = _cfg()
    ids, labels = _batch(cfg, 0)
    with _profiled():
        train.train_step(_state(cfg), ids, None, labels, cfg, train.default_interaction_fn(cfg))
    counts = profiling.counts()
    fs = cfg.model.small_field_prefix
    assert 0 < fs < cfg.model.num_fields
    assert counts["sparse.streamed"] == 1
    n, rows = ids[:, fs:].numel(), sum(cfg.model.vocab_sizes)
    bound = rowwise.unique_bound(cfg.model.vocab_sizes[fs:], cfg.data.batch_size)
    assert counts["sparse.slots"] == padded_entries(min(n, bound), pick_tile(rows))
    assert counts["sparse.distinct_rows"] == sum(np.unique(ids[:, f].numpy()).size
                                                 for f in range(fs, cfg.model.num_fields))


FORWARD_ROUTES = {
    "hybrid": (dict(), True),
    "hybrid_bf16": (dict(compute="bfloat16"), True),
    "batch_major": (dict(use_pallas=False), False),
}


@pytest.mark.parametrize("route", sorted(FORWARD_ROUTES))
def test_forward_is_bit_equal_with_the_profiler_on(route):
    kw, kernel = FORWARD_ROUTES[route]
    cfg = _cfg(**kw)
    params = model_lib.init_params(cfg.model, torch.Generator().manual_seed(1))
    fn = make_interaction_fn() if kernel else None
    ids, _ = _batch(cfg, 4)
    with torch.inference_mode():
        off = model_lib.forward(params, ids, None, cfg.model, interaction_fn=fn)
        with _profiled() as prof:
            on = model_lib.forward(params, ids, None, cfg.model, interaction_fn=fn)
    assert torch.equal(off, on)
    recs = _named(prof)
    assert [r[0] for r in recs] == ["cffm.forward", "cffm.lookup"] + (
        ["cffm.conv_tail"] if kernel else [])
    assert all(_inside(r, recs[0]) for r in recs[1:])


def test_record_function_names_the_spans_in_the_trace():
    with _profiled() as prof:
        with record_function("outside"):
            with profiling.span("cffm.step"):
                pass
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "cffm.step" in names and "outside" in names


def test_inside_trace_the_spans_name_the_trace_and_nothing_is_counted(tmp_path, monkeypatch):
    """`trace()` (the CLI's --profile_dir, the trace scripts) reads no
    counters: there the registry keeps nothing, however long the run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with profiling.trace(str(tmp_path / "t")):
        with profiling.span("cffm.step"):
            profiling.count("sparse.streamed")
    assert profiling.counts() == {}
    assert "cffm.step" in (tmp_path / "t" / "trace.json").read_text()
    with _profiled():
        profiling.count("sparse.streamed")
    assert profiling.counts() == {"sparse.streamed": 1}

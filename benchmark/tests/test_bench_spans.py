"""The metrics read from the port's spans and counters
(`cffm_tpu_torch.utils.profiling`, `benchmark/spans.py`): each reader on
a synthetic trace and counters, the case in which each finds nothing to
read and returns None, and on the card the cells' traced stretches,
where no device record carries a span's name and each busy time equals
the one the profiler's own correlation of launch and record gives."""

import pytest

from benchmark import readers, spec, trace

MS = {"lookup_ms.train": ("cffm.step", "cffm.lookup"),
      "dense_update_ms.train": ("cffm.step", "cffm.dense_update"),
      "sparse_update_ms.train": ("cffm.step", "cffm.sparse_update"),
      "lookup_ms.score": ("cffm.forward", "cffm.lookup")}
SYNCS = {"host_syncs.train": "cffm.step", "host_syncs.score": "cffm.forward"}
NEW = sorted(MS) + sorted(SYNCS) + ["slot_use.train"]
P = 20_000          # ns from one step's start to the next's on the host


def _host(top, child, steps=3, start=1_000_000):
    """Host records a step: the top-level span, its child from 1 to 5 us,
    four launching calls (at 0.5, 1.5, 3 and 6 us: the child launched the
    second and third) and calls that launch nothing."""
    out = []
    for k in range(steps):
        s = start + k * P
        out += [(top, s, s + 9_000), (child, s + 1_000, s + 5_000),
                ("cudaLaunchKernel", s + 500, s + 510), ("cuLaunchKernel", s + 1_500, s + 1_510),
                ("cudaEventRecordWithFlags", s + 1_600, s + 1_605),
                ("cudaMemcpyAsync", s + 3_000, s + 3_010), ("cudaStreamIsCapturing", s + 3_100, s + 3_101),
                ("cudaLaunchKernelExC", s + 6_000, s + 6_010)]
    return out


def _device(steps=3):
    """The device records the four launches made, on a clock of the
    device's own (another origin, another pace): the child's two overlap
    by 200 ns, so they keep the card busy 1.8 us a step."""
    out = []
    for k in range(steps):
        t = 50_000_000 + k * 25_000
        out += [("a", t + 100, t + 1_100), ("b", t + 1_200, t + 2_200),
                ("c", t + 2_000, t + 3_000), ("d", t + 3_500, t + 4_500)]
    return out


def _run(items, host=(), device=(), start=0):
    run = readers.Run(model={}, train=True, window_s=1.0, window_examples=1)
    run.items = [{"batch": 1}] * items
    run.trace = trace.Trace(start, 10**9, device=list(device), host=list(host))
    return run


def _read(name, run):
    return spec.metric_module(name).read(run)


@pytest.mark.parametrize("name", sorted(MS))
def test_ms_readers_count_what_the_child_span_launched(name):
    top, child = MS[name]
    assert _read(name, _run(3, _host(top, child), _device())) == pytest.approx(0.0018)
    # a call before the stretch launched nothing in it
    early = [("cudaLaunchKernel", 100, 110)] + _host(top, child)
    assert _read(name, _run(3, early, _device(), start=500)) == pytest.approx(0.0018)
    # the child launching one record less: 1 us a step
    host = [h for h in _host(top, child) if h[0] != "cuLaunchKernel"]
    assert _read(name, _run(3, host, [d for d in _device() if d[0] != "b"])) \
        == pytest.approx(0.0010)


@pytest.mark.parametrize("name", sorted(MS))
def test_ms_readers_return_none_when_the_records_do_not_match(name):
    top, child = MS[name]
    host, device = _host(top, child), _device()
    assert _read(name, _run(4, host, device)) is None                  # a step without its span
    assert _read(name, _run(3, host, device[:-1])) is None             # a call without its record
    assert _read(name, _run(3, [h for h in host if h[0] != child], device)) is None
    assert _read(name, _run(3, [h for h in host if h[0] != top], device)) is None
    run = _run(3)
    run.trace = None
    assert _read(name, run) is None
    assert _read(name, _run(0)) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_returns_none_from_a_port_without_the_spans(monkeypatch, name):
    from cffm_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counts")
    assert _read(name, _run(3, [("cudaLaunchKernel", 10, 11)], [("k", 20, 30)])) is None


@pytest.fixture
def counters(monkeypatch):
    """counters(**totals): what the port's counts() returns."""
    from cffm_tpu_torch.utils import profiling

    def put(totals):
        monkeypatch.setattr(profiling, "counts", lambda: dict(totals))

    return put


def test_slot_use_is_distinct_rows_over_slots(counters):
    counters({"sparse.streamed": 2, "sparse.slots": 2048, "sparse.distinct_rows": 82})
    assert _read("slot_use.train", _run(2)) == pytest.approx(100.0 * 82 / 2048)


@pytest.mark.parametrize("totals", [
    {"sparse.streamed": 1, "sparse.slots": 2048, "sparse.distinct_rows": 82},  # 1 route of 2
    {"sparse.streamed": 2, "sparse.distinct_rows": 82},                        # no slots
    {"sparse.streamed": 2, "sparse.slots": 2048},                              # no rows
    {}])                                                                       # scatter route
def test_slot_use_returns_none_unless_every_step_streamed(counters, totals):
    counters(totals)
    assert _read("slot_use.train", _run(2)) is None


@pytest.mark.parametrize("name", sorted(SYNCS))
def test_host_syncs_count_the_synchronizes_inside_the_top_spans(name):
    top = SYNCS[name]
    host = [("cudaStreamSynchronize", 1_000_000, 1_000_500),     # at a span's start: in
            ("cudaStreamSynchronize", 1_005_000, 1_005_500),     # in step 1
            ("cudaMemcpy", 1_020_100, 1_020_200),                # in step 2
            ("cudaEventSynchronize", 1_029_000, 1_029_100),      # at step 2's end: in
            ("cudaDeviceSynchronize", 1_015_000, 1_015_100),     # between the steps: out
            ("cudaStreamSynchronize", 999_999, 1_000_100),       # starts before: out
            ("cudaMemcpyAsync", 1_005_000, 1_005_100),           # asynchronous: out
            ("cudaLaunchKernel", 1_006_000, 1_006_100),
            (top, 1_000_000, 1_009_000), (top, 1_020_000, 1_029_000)]
    assert _read(name, _run(2, host)) == 2.0


@pytest.mark.parametrize("name", sorted(SYNCS))
def test_host_syncs_return_none_without_a_span_per_item_or_a_trace(name):
    host = _host(SYNCS[name], "cffm.lookup", steps=2)
    assert _read(name, _run(2, host)) == 0.0
    assert _read(name, _run(3, host)) is None
    run = _run(2, host)
    run.trace = None
    assert _read(name, run) is None
    assert _read(name, _run(2, _host("other", "cffm.lookup", steps=2))) is None


@pytest.mark.card
@pytest.mark.parametrize("workload, top", [("kaggle-train-zipf", "cffm.step"),
                                           ("kaggle-score-offline", "cffm.forward")])
def test_the_spans_in_a_cells_traced_stretch_on_the_card(card, monkeypatch, workload, top):
    """The cell's own traced stretch (about a minute a cell): no device
    record carries a span's name; each span's busy time, its records
    paired with their launching calls by order (`benchmark/spans.py`),
    equals the one the profiler's correlation ids give; the top-level
    spans hold 95% of the busy time; each new metric reads."""
    import torch.profiler

    from benchmark import spans
    from cffm_tpu_torch.utils import profiling

    made, real = [], torch.profiler.profile

    class Kept(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(torch.profiler, "profile", Kept)
    bench = spec.benchmark()
    cell = spec.cell(bench, workload)
    job = spec.Job(workload=workload, seed=4000000201, seconds=1.0, trace=True,
                   config=cell["config"], traffic=cell["traffic"], limits=cell["limits"],
                   device=card)
    profiling.reset()
    run = spec.driver(cell["traffic"]).run(job)["run"]
    tr = run.trace
    assert not [n for n, _, _ in tr.device if n.startswith("cffm.")]
    events = list(made[-1].profiler.kineto_results.events())
    call = {e.correlation_id(): trace._ns(e) for e in events
            if not trace._on_device(e) and e.name() in spans.LAUNCHES}
    recs = [(call[e.correlation_id()], max(trace._ns(e), tr.start),
             min(trace._ns(e, end=True), tr.end)) for e in events
            if trace._on_device(e) and not trace._annotation(e) and e.name() != trace.TRACED
            and trace._ns(e, end=True) > tr.start and trace._ns(e) < tr.end]
    assert sorted(recs) == sorted(spans.launched(run))
    names = sorted({n for n, _, _ in tr.host if n.startswith("cffm.")})
    report = []
    for name in names:
        got = spans.busy_ms(run, top, name)
        marks = [(a, b) for n, a, b in tr.host if n == name]
        truth = 0
        for a, b in marks:
            end = 0
            for s, e in sorted((s, e) for c, s, e in recs if a <= c <= b):
                truth += max(0, e - max(s, end))
                end = max(end, e)
        truth /= 1e6 * len(run.items)
        report.append(f"{name} {got:.4f} ms")
        assert got == pytest.approx(truth, rel=1e-9), name
    print(f"{workload}: busy a step or batch {'; '.join(report)}; of the busy time "
          f"{spans.busy_ms(run, top, top) * len(run.items) / 1e3 / tr.busy_s:.4f} in {top}; "
          + ", ".join(f"{m['name']} {spec.metric_module(m['name']).read(run)}"
                      for m in bench["per_layer"] if m["name"] in NEW
                      and spec.applies(m, workload)))
    assert spans.busy_ms(run, top, top) * len(run.items) / 1e3 >= 0.95 * tr.busy_s
    for m in bench["per_layer"]:
        if m["name"] in NEW and spec.applies(m, workload):
            assert spec.metric_module(m["name"]).read(run) is not None, m["name"]

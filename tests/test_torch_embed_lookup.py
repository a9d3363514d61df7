"""The field-major lookup (`cffm_tpu_torch.ops.embed_lookup`).

On the CPU: the wrapper's plain branch is bit-equal to the chain the
forward and the train step ran before it (the prefix's one-hot answer from
`index_select` and `torch.where`, the big fields' clamped `index_select`,
each cast to the compute dtype); the kernel's wrapper refuses what the
kernel does not take, and counts its launches and the rows it wrote.

On the card (marker `card`, skipped without one): the kernel is bit-equal
to the plain version at the benchmark's criteo_kaggle shapes, and one
traced train step and one forward each launch it once inside
`cffm.lookup`, with nothing else there and no synchronize in the forward.
Run them there with `python -m pytest --noconftest -m card
tests/test_torch_embed_lookup.py` (this file imports no JAX).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cffm_tpu_torch.ops import embed_lookup
from cffm_tpu_torch.utils import profiling

VOCAB = (8, 5, 11, 40, 300, 2000)   # the first three make the prefix
BOUNDS = (0, 8, 13, 24)
B, W = 37, 16


def _todays_chain(table, ids, fs, out_dtype):
    """What the forward ran before the kernel: `onehot_lookup_fm` (the
    vocab sizes copied to the ids' device, the block test on local ids,
    the gather, the cast and `torch.where`) and the big fields' clamped
    gather, cast to the compute dtype."""
    ids_fm = ids.t()

    def take(t, i):
        return t.index_select(0, i.reshape(-1).clamp(0, t.shape[0] - 1)).reshape(
            *i.shape, t.shape[1])

    vocab = torch.as_tensor(VOCAB[:fs], device=ids.device)
    offs = torch.cumsum(vocab, 0) - vocab
    small = ids_fm[:fs]
    local = small - offs[:, None].to(small.dtype)
    valid = (local >= 0) & (local < vocab[:, None])
    rows = take(table[: sum(VOCAB[:fs])], small).to(out_dtype)
    emb_small = torch.where(valid[..., None], rows,
                            torch.zeros((), dtype=out_dtype, device=rows.device))
    return emb_small, take(table, ids_fm[fs:]).to(out_dtype)


def _ids(layout: str, id_dtype, seed: int = 0):
    """(B, F) global ids with prefix ids outside their field's block and
    big-field ids below 0 and at or past V; contiguous, a transposed
    (F, B) store, or every other column of a wider tensor."""
    rng = np.random.default_rng(seed)
    total = sum(VOCAB)
    offs = np.concatenate([[0], np.cumsum(VOCAB)[:-1]])
    ids = np.stack([rng.integers(0, v, size=B) + o for v, o in zip(VOCAB, offs)], 1)
    ids[::5, :3] = rng.integers(0, total, size=(len(ids[::5]), 3))   # often out of block
    ids[1, 0], ids[2, 1], ids[3, 2] = -1, 8, 24                      # the blocks' edges
    ids[4, 3:] = [-7, total, total + 1000]
    ids[5, 3:] = [0, total - 1, -(2**31) + 5]
    t = torch.from_numpy(ids).to(id_dtype)
    if layout == "transposed":
        return t.t().contiguous().t()
    if layout == "sliced":
        wide = torch.zeros((B, 2 * len(VOCAB)), dtype=id_dtype)
        wide[:, ::2] = t
        return wide[:, ::2]
    return t


def _table(dtype, seed: int = 1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(sum(VOCAB), W)).astype(np.float32)).to(dtype)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("fs", [0, 3, len(VOCAB)])
@pytest.mark.parametrize("layout", ["contiguous", "transposed", "sliced"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64], ids=str)
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16], ids=str)
def test_plain_branch_is_todays_chain(table_dtype, id_dtype, layout, fs, out_dtype):
    table, ids = _table(table_dtype), _ids(layout, id_dtype)
    bounds = tuple(int(x) for x in np.cumsum([0, *VOCAB[:fs]])) if fs else ()
    got = embed_lookup.lookup_fm(table, ids, bounds, out_dtype)
    want = _todays_chain(table, ids, fs, out_dtype)
    for g, w, rows in zip(got, want, (fs, len(VOCAB) - fs)):
        assert g.shape == (rows, B, W) and g.dtype == out_dtype and g.is_contiguous()
        assert torch.equal(_bits(g), _bits(w))
    if fs == 3:  # the blocks' edges: out of block gives zeros; the big fields clamp
        assert not got[0][0, 1].any() and not got[0][2, 3].any()
        assert torch.equal(got[0][1, 2], table[8].to(out_dtype))
        assert torch.equal(got[1][0, 4], table[0].to(out_dtype))
        assert torch.equal(got[1][1, 4], table[-1].to(out_dtype))


def test_prefix_bounds_follow_the_config():
    from cffm_tpu_torch.config import get_config
    from cffm_tpu_torch.models import cffm as model_lib

    mcfg = get_config("criteo_kaggle").model
    bounds = model_lib.prefix_bounds(mcfg)
    assert bounds == tuple(range(0, 64 * 13 + 1, 64)) and bounds[-1] == mcfg.small_rows


class _FakeCard:
    """Stands in for the kernel on the CPU: fills the outputs from the plain
    version and records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, table, ids, bounds, emb_small, emb_big):
        small, big = embed_lookup.lookup_fm_reference(table, ids, bounds, emb_small.dtype)
        emb_small.copy_(small)
        emb_big.copy_(big)
        self.calls.append(tuple(bounds))


@pytest.mark.parametrize("case, error", [
    ("width_not_multiple_of_8", ValueError),
    ("f16_table", TypeError),
    ("f16_output", TypeError),
    ("int16_ids", TypeError),
    ("strided_table_rows", ValueError),
    ("too_many_prefix_fields", ValueError),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, case, error):
    fake = _FakeCard()
    monkeypatch.setattr(embed_lookup, "_launch", fake)
    table, ids, bounds, out = _table(torch.float32), _ids("contiguous", torch.int32), \
        BOUNDS, torch.bfloat16
    if case == "width_not_multiple_of_8":
        table = table[:, :12].contiguous()
    elif case == "f16_table":
        table = table.half()
    elif case == "f16_output":
        out = torch.float16
    elif case == "int16_ids":
        ids = ids.to(torch.int16)
    elif case == "strided_table_rows":
        table = torch.cat([table, table], 1)[:, ::2]
    else:
        many = embed_lookup.MAX_SMALL_FIELDS + 1
        ids = torch.zeros((B, many), dtype=torch.int32)
        bounds = tuple(range(many + 1))
    before = embed_lookup.lookup_fm.launches
    with pytest.raises(error):
        embed_lookup._fused(table, ids, bounds, out)
    assert not fake.calls and embed_lookup.lookup_fm.launches == before


def test_lookup_refuses_a_device_it_does_not_take():
    table = torch.empty((sum(VOCAB), W), device="meta")
    ids = torch.empty((B, len(VOCAB)), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        embed_lookup.lookup_fm(table, ids, BOUNDS, torch.bfloat16)
    with pytest.raises(ValueError, match="share a device"):
        embed_lookup.lookup_fm(_table(torch.float32), ids, BOUNDS, torch.bfloat16)


@pytest.mark.parametrize("profiled", [False, True], ids=["no_profiler", "profiler"])
def test_launches_and_fused_rows_follow_the_calls(monkeypatch, profiled):
    """Three launches through the kernel's wrapper: the launch count rises
    by three; under a profiler `lookup.fused_rows` counts the rows written
    (F x B a call), and without one nothing is counted. An empty batch
    launches nothing."""
    fake = _FakeCard()
    monkeypatch.setattr(embed_lookup, "_launch", fake)
    table, ids = _table(torch.float32), _ids("transposed", torch.int64)
    profiling.reset()
    before = embed_lookup.lookup_fm.launches
    with profile(activities=[ProfilerActivity.CPU]) if profiled else torch.no_grad():
        for bounds in (BOUNDS, (), BOUNDS[:2]):
            got = embed_lookup._fused(table, ids, bounds, torch.bfloat16)
            want = embed_lookup.lookup_fm_reference(table, ids, bounds, torch.bfloat16)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        embed_lookup._fused(table, ids[:0], BOUNDS, torch.bfloat16)
    assert fake.calls == [BOUNDS, (), BOUNDS[:2]]
    assert embed_lookup.lookup_fm.launches == before + 3
    counted = profiling.counts().get("lookup.fused_rows")
    assert counted == (3 * len(VOCAB) * B if profiled else None)
    profiling.reset()


# --- on the card ------------------------------------------------------------

CELL_BATCH = 65536


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _kaggle(table_dtype: str = "float32"):
    """criteo_kaggle's train config at the cells' batch, and one batch of
    the benchmark's zipf traffic (`benchmark/traffic.py`): global int32 ids
    (B, 39), dense features and labels, on the host."""
    import dataclasses
    import json
    import pathlib

    from benchmark import traffic
    from cffm_tpu_torch.config import get_config

    cfg = get_config("criteo_kaggle")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, table_dtype=table_dtype),
                              data=dataclasses.replace(cfg.data, batch_size=CELL_BATCH))
    root = pathlib.Path(__file__).resolve().parents[1]
    law = json.loads((root / "benchmark" / "traffic" / "train_zipf.json").read_text())["ids"]
    world = traffic.PlantedCTR(cfg.model.vocab_sizes, cfg.model.num_dense, 2**31 + 11, law)
    ids, dense, labels = world.batch(traffic.rng(2**31 + 11, 1), CELL_BATCH)
    ids = ids + traffic.field_offsets(cfg.model.vocab_sizes)[None, :].astype(np.int32)
    return cfg, ids, dense, labels


@pytest.mark.card
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_kernel_is_bit_equal_to_the_plain_version_at_the_cells_shapes(card, table_dtype):
    from cffm_tpu_torch.models import cffm as model_lib

    cfg, ids_np, _, _ = _kaggle(table_dtype)
    mcfg = cfg.model
    gen = torch.Generator(device=card).manual_seed(3)
    table = (0.01 * torch.randn((mcfg.total_vocab, mcfg.table_width), generator=gen,
                                device=card)).to(model_lib.torch_dtype(table_dtype))
    ids = torch.from_numpy(ids_np).to(card)
    bounds = model_lib.prefix_bounds(mcfg)
    # the ids as the forward holds them, int64, and every other column of a wider store
    wide = torch.zeros((CELL_BATCH, 2 * mcfg.num_fields), dtype=torch.int32, device=card)
    wide[:, ::2] = ids
    for what, i in (("int32", ids), ("int64", ids.long()), ("strided", wide[:, ::2])):
        before = embed_lookup.lookup_fm.launches
        got = embed_lookup.lookup_fm(table, i, bounds, torch.bfloat16)
        torch.cuda.synchronize()
        assert embed_lookup.lookup_fm.launches == before + 1, what
        want = embed_lookup.lookup_fm_reference(table, i, bounds, torch.bfloat16)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w)), what
        del got, want


def _launched_in_lookup(fn) -> list:
    """Names of the device records launched from inside `cffm.lookup` while
    fn runs under the profiler, paired by the profiler's correlation ids."""
    from benchmark import spans, trace

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    marks = [(trace._ns(e), trace._ns(e, end=True)) for e in events
             if e.name() == "cffm.lookup" and not trace._on_device(e)]
    assert len(marks) == 1
    (a, b), = marks
    calls = {e.correlation_id() for e in events
             if not trace._on_device(e) and e.name() in spans.LAUNCHES
             and a <= trace._ns(e) <= b}
    return [e.name() for e in events if trace._on_device(e) and not trace._annotation(e)
            and e.correlation_id() in calls]


@pytest.mark.card
def test_a_traced_step_and_forward_launch_the_kernel_once_in_the_lookup(card):
    from cffm_tpu_torch import train
    from cffm_tpu_torch.models import cffm as model_lib

    cfg, ids_np, dense_np, labels_np = _kaggle()
    mcfg = cfg.model
    fn = train.default_interaction_fn(cfg)
    state = train.create_state(cfg, torch.Generator(device=card).manual_seed(0))
    ids, dense, labels = (torch.from_numpy(x).to(card) for x in (ids_np, dense_np, labels_np))
    rows = mcfg.num_fields * CELL_BATCH
    assert rows == 2_555_904

    def step():
        nonlocal state
        state, _ = train.train_step(state, ids, dense, labels, cfg, fn)

    def forward():
        with torch.no_grad():
            model_lib.forward(state.params, ids, dense, mcfg, interaction_fn=fn)

    for run in (step, forward):
        run()  # builds and warms
        profiling.reset()
        before = embed_lookup.lookup_fm.launches
        names = _launched_in_lookup(run)
        assert embed_lookup.lookup_fm.launches == before + 1, run.__name__
        assert len(names) == 1 and "lookup_fm_kernel" in names[0], (run.__name__, names)
        assert profiling.counts()["lookup.fused_rows"] == rows, run.__name__
        profiling.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        forward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

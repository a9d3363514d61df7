"""The scatter route's kernels (`ops/sorted_segment.scatter_segment_sum`,
`ops/streamed_update.scatter_rowwise_apply`) and the route that takes
them in `optim/rowwise.rowwise_update`.

On the CPU the route's plain versions are the eager code it replaced, so
an update through them is bit for bit the eager route's (f32 grads keep
that route): every CPU number stays as it was. The route predicate says
which updates take the kernels.

On the card (marker `card`, skipped without one) the kernels are held to
the eager route at full-train-zipf's shapes (`scripts/check_onchip_parity
.check_scatter_update`) and the apply draws its dither on the card: run
with `python -m pytest --noconftest -m card tests/test_torch_scatter_update.py`
(this file imports no JAX).
"""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cffm_tpu_torch.config import OptimizerConfig
from cffm_tpu_torch.ops import rounding
from cffm_tpu_torch.ops import sorted_segment as ss
from cffm_tpu_torch.ops import streamed_update as su
from cffm_tpu_torch.optim import rowwise
from cffm_tpu_torch.utils import profiling

V, W = 3000, 256


def _case(seed=0, n=2048, sentinels=True):
    """Ids with duplicates, a hot row, negative ids and the sentinel V; bf16
    grads; an f32 table."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, V, (n,), generator=gen, dtype=torch.int32)
    ids[100:400] = 17
    if sentinels:
        ids[::11] = -1
        ids[5::13] = V
    grads = (0.1 * torch.randn((n, W), generator=gen)).to(torch.bfloat16)
    table = 0.01 * torch.randn((V, W), generator=gen)
    return ids, grads, table


ROUTE = [("adagrad", W, torch.float32, torch.bfloat16, True),
         ("sgd", W, torch.bfloat16, torch.bfloat16, True),
         ("rowwise_adam", 640, torch.bfloat16, torch.bfloat16, True),
         ("adagrad", 1152, torch.float32, torch.bfloat16, True),   # kernel 4's chunked route
         ("adam", W, torch.float32, torch.bfloat16, False),        # full Adam
         ("adagrad", 1, torch.float32, torch.bfloat16, False),     # the first-order table
         ("adagrad", 192, torch.float32, torch.bfloat16, False),   # not a multiple of 128
         ("adagrad", W, torch.float16, torch.bfloat16, False),     # another table dtype
         ("adagrad", W, torch.float32, torch.float32, False),      # f32 grads, never cast down
         ("sgd", W, torch.bfloat16, torch.float16, False)]


@pytest.mark.parametrize("optimizer,w,table_dtype,grads_dtype,takes", ROUTE)
def test_which_updates_take_the_scatter_kernels(optimizer, w, table_dtype, grads_dtype, takes):
    opt = OptimizerConfig(sparse_optimizer=optimizer)
    table = torch.zeros((8, w), dtype=table_dtype)
    assert rowwise._scatter_kernels_take(table, opt, torch.zeros((4, w),
                                                                 dtype=grads_dtype)) == takes


@pytest.mark.parametrize("sentinels", [False, True])
def test_the_plain_sums_are_today_s_slots_live_slice(sentinels):
    """The live rows' sums, bit for bit the rows [lo, lo + n) of the eager
    sums into a slot per id; negative ids and the sentinel run dropped."""
    ids, grads, _ = _case(1, sentinels=sentinels)
    order, seg, uids, bounds = rowwise.scatter_plan(ids, V, ids.numel() + 1)
    lo, n = bounds()
    assert (lo > 0) == sentinels and n == int(torch.unique(ids[(ids >= 0) & (ids < V)]).numel())
    want = rowwise._segment_sums(grads, order, seg, uids.shape[0])[lo:lo + n]
    got = ss.scatter_segment_sum(order, seg, grads, lo, n)
    assert got.dtype == torch.float32 and got.shape == (n, W)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


TABLES = [("f32", torch.float32, "nearest"), ("bf16_nearest", torch.bfloat16, "nearest"),
          ("bf16_stochastic", torch.bfloat16, "stochastic")]


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd", "rowwise_adam"])
@pytest.mark.parametrize("name,dtype,rounding_mode", TABLES, ids=[t[0] for t in TABLES])
@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_the_kernel_route_on_the_cpu_is_the_eager_route(optimizer, name, dtype, rounding_mode,
                                                        clip):
    """bf16 grads (the kernels' route, their plain versions here) against
    the same grads in f32 (the eager route): table and state bit for bit,
    two steps, sentinels masked; rows no id touches keep their bits."""
    ids, grads, start = _case(2)
    opt = OptimizerConfig(sparse_optimizer=optimizer, sparse_lr=0.05, clip_norm=clip,
                          streamed_update="off", table_rounding=rounding_mode)
    out = []
    for g in (grads, grads.float()):
        table = start.to(dtype, copy=True)
        state = rowwise.rowwise_init(table, opt)
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            for step in range(2):
                key, _ = rowwise.sr_keys("bfloat16", opt, step)
                rowwise.rowwise_update(table, state, ids, g, opt, sr_key=key)
        out.append((table, state, profiling.counts()))
    profiling.reset()
    (tk, sk, ck), (te, se, ce) = out
    assert ck.get("sparse.scatter_kernels") == 2 and "sparse.scatter_kernels" not in ce
    assert ck["sparse.scatter_rows"] == ce["sparse.scatter_rows"] == ck["sparse.scatter_slots"]
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(tk.view(bits), te.view(bits))
    assert sorted(sk) == sorted(se)
    for k in sk:
        assert torch.equal(sk[k], se[k]), k
    touched = torch.zeros(V, dtype=torch.bool)
    touched[ids[(ids >= 0) & (ids < V)].long()] = True
    assert torch.equal(tk[~touched].view(bits), start.to(dtype)[~touched].view(bits))
    assert (tk[touched] != start.to(dtype)[touched]).any()


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd", "rowwise_adam"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_kernel_s_plain_apply_is_the_eager_update(optimizer, dtype):
    """Kernel 4's arithmetic from f32 sums (its plain model, `_apply_rows`)
    against `scatter_rowwise_apply`'s plain version, the eager update: bit
    for bit for an f32 table and for rounding to nearest (adagrad, sgd);
    rowwise_adam's bias corrections are multiplied, not divided, and its
    (1 - b) taken in f32, so it is held at 2e-5 of its step (and one ulp in
    a bf16 table); untouched rows keep their bits."""
    gen = torch.Generator().manual_seed(4)
    start = (0.01 * torch.randn((V, W), generator=gen)).to(dtype)
    rows = torch.unique(torch.randint(0, V, (500,), generator=gen))
    s = 0.1 * torch.randn((rows.numel(), W), generator=gen)
    opt = OptimizerConfig(sparse_optimizer=optimizer, sparse_lr=0.05, table_rounding="nearest")
    lr = opt.sparse_lr * torch.tensor(1.0)
    tables, states = [], []
    for model in (True, False):
        table = start.clone()
        state = rowwise.rowwise_init(table, opt)
        if model:
            extra = ()
            if optimizer == "rowwise_adam":
                state["t"] = state["t"] + 1
                extra = su._adam_extra(opt.adam_b1, opt.adam_b2, state["t"])
            su._apply_rows(table, state, rows, s, su._hyper(lr, opt.eps, extra), optimizer, None)
        else:
            su.scatter_rowwise_apply(table, state, rows.to(torch.int32), s, opt, lr)
        tables.append(table)
        states.append(state)
    (tp, te), (sp, se) = tables, states
    untouched = torch.ones(V, dtype=torch.bool)
    untouched[rows] = False
    assert torch.equal(tp[untouched], start[untouched])
    assert torch.equal(te[untouched], start[untouched])
    if optimizer == "rowwise_adam":
        assert int(sp["t"]) == int(se["t"]) == 1
        # in f32, (1 - b2) is 1.3e-5 from the eager update's 0.001: 6.5e-6 of a step
        step = float((te.float() - start.float()).abs().max())
        gap = (tp.float() - te.float()).abs()
        if dtype == torch.float32:
            assert float(gap.max()) <= 2e-5 * step
        else:  # and one bf16 ulp of the larger value
            big = torch.maximum(tp.float().abs(), te.float().abs())
            ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
            assert (gap <= ulp + 2e-5 * step).all()
        return
    assert torch.equal(tp, te)
    for k in sp:
        assert torch.equal(sp[k], se[k]), k


STATES = [("adagrad", torch.float32, ("accum",), 2), ("sgd", torch.bfloat16, (), 2),
          ("rowwise_adam", torch.bfloat16, ("m", "v"), 6)]


@pytest.mark.parametrize("optimizer,dtype,kernel_state,n_hyper", STATES)
@pytest.mark.parametrize("rounding_mode", ["nearest", "stochastic"])
def test_the_card_branch_hands_the_kernel_its_state_alone(monkeypatch, optimizer, dtype,
                                                          kernel_state, n_hyper,
                                                          rounding_mode):
    """`scatter_rowwise_apply`'s card branch up to the launch, with meta
    tensors for the card's and the launch recorded: the kernel gets its
    own state (no step "t"), f32 sums, lr and eps (rowwise_adam's betas and
    bias corrections for the incremented step too), and a seed exactly
    where a bf16 table rounds stochastically; a bf16 table's launch runs in
    the span cffm.table_round."""
    calls = []

    def launch(table, state, ids, g, hyper, mode, sr_seed, clip=None, f32_sums=False):
        with torch.profiler.record_function("launch"):
            calls.append((sorted(state), hyper.shape[0], mode, sr_seed, f32_sums))
        return table

    monkeypatch.setattr(su, "_apply", launch)
    opt = OptimizerConfig(sparse_optimizer=optimizer, table_rounding=rounding_mode)
    table = torch.empty((V, W), dtype=dtype, device="meta")
    state = rowwise.rowwise_init(table, opt)
    launches = su.scatter_rowwise_apply.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        su.scatter_rowwise_apply(table, state, torch.empty((64,), dtype=torch.int32,
                                                           device="meta"),
                                 torch.empty((64, W), device="meta"), opt, torch.tensor(0.05),
                                 sr_key=torch.Generator().manual_seed(1))
    (names, n, mode, seed, f32_sums), = calls
    assert (names, n, mode, f32_sums) == (sorted(kernel_state), n_hyper, optimizer, True)
    assert (seed is not None) == (dtype == torch.bfloat16 and rounding_mode == "stochastic")
    assert su.scatter_rowwise_apply.launches == launches + 1
    if optimizer == "rowwise_adam":
        assert int(state["t"]) == 1
    spans = [e.time_range for e in prof.events() if e.name == "cffm.table_round"]
    assert len(spans) == (dtype == torch.bfloat16)
    (at,) = [e.time_range for e in prof.events() if e.name == "launch"]
    assert all(span.start <= at.start and at.end <= span.end for span in spans)


def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    ids, grads, table = _case(3)
    order, seg, _, bounds = rowwise.scatter_plan(ids, V, ids.numel() + 1)
    lo, n = bounds()
    with pytest.raises(ValueError, match="W % 128"):
        ss.scatter_segment_sum(order, seg, grads[:, :192], lo, n)
    with pytest.raises(TypeError, match="bf16"):
        ss.scatter_segment_sum(order, seg, grads.float(), lo, n)
    with pytest.raises(ValueError, match="order and seg"):
        ss.scatter_segment_sum(order[1:], seg, grads, lo, n)
    sgd = OptimizerConfig(sparse_optimizer="sgd")
    with pytest.raises(ValueError, match="int32"):
        su.scatter_rowwise_apply(table, {}, torch.arange(4), torch.zeros(4, W), sgd, 0.1)
    with pytest.raises(ValueError, match="rowwise_adam, got 'adam'"):
        su.scatter_rowwise_apply(table, {}, torch.arange(4, dtype=torch.int32),
                                 torch.zeros(4, W), OptimizerConfig(sparse_optimizer="adam"),
                                 0.1)


def test_an_empty_live_run_updates_nothing():
    """Only sentinel ids: no live row, nothing written."""
    table = torch.ones((V, W))
    opt = OptimizerConfig(sparse_optimizer="adagrad", streamed_update="off")
    state = rowwise.rowwise_init(table, opt)
    ids = torch.full((64,), V, dtype=torch.int32)
    rowwise.rowwise_update(table, state, ids, torch.ones((64, W), dtype=torch.bfloat16), opt,
                           mask_sentinels=False)
    assert (table == 1).all() and (state["accum"] == opt.adagrad_init).all()


# --- on the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_the_kernels_hold_to_the_eager_route_at_the_cell_s_shapes(card):
    from cffm_tpu_torch.scripts import check_onchip_parity

    assert check_onchip_parity.check_scatter_update("cuda")


@pytest.mark.card
@pytest.mark.parametrize("optimizer", ["adagrad", "sgd", "rowwise_adam"])
def test_every_optimizer_s_kernel_route_holds_to_the_eager_route_on_the_card(card, optimizer):
    """Two steps of `rowwise_update` on an f32 table on the card: the
    kernels (bf16 grads, one apply launch a step) against the eager route
    (the same grads in f32, no launch): table steps within 1e-4 of the
    largest, state within its `check_scatter_update` gap of its largest
    (rowwise_adam's (1 - b2) is taken in f32 by the kernel), rowwise_adam's
    step equal, untouched rows bit-equal."""
    from cffm_tpu_torch.scripts.check_onchip_parity import SCATTER_STATE_GAP

    ids, grads, start = _case(6)
    opt = OptimizerConfig(sparse_optimizer=optimizer, sparse_lr=0.05, streamed_update="off")
    ids, grads, start = ids.to(card), grads.to(card), start.to(card)
    out = []
    for g in (grads, grads.float()):
        table = start.clone()
        state = rowwise.rowwise_init(table, opt)
        launches = su.scatter_rowwise_apply.launches
        for _ in range(2):
            rowwise.rowwise_update(table, state, ids, g, opt)
        out.append((table, state, su.scatter_rowwise_apply.launches - launches))
    (tk, sk, nk), (te, se, ne) = out
    assert (nk, ne) == (2, 0)
    assert float((tk - te).abs().max()) <= 1e-4 * float((te - start).abs().max())
    assert sorted(sk) == sorted(se)
    for k in se:
        if se[k].dim():
            gap = float((sk[k] - se[k]).abs().max())
            assert gap <= SCATTER_STATE_GAP[optimizer] * float(se[k].abs().max()), k
        else:
            assert int(sk[k]) == int(se[k]) == 2
    touched = torch.zeros(V, dtype=torch.bool, device=card)
    touched[ids[(ids >= 0) & (ids < V)].long()] = True
    assert torch.equal(tk[~touched], start[~touched])


@pytest.mark.card
def test_the_apply_draws_its_dither_on_the_card_inside_its_span(card):
    """A bf16 table rounded stochastically: one launch of each kernel, one
    dither drawn on the card and none on the host, the apply inside the
    span cffm.table_round; the same key gives the same bits."""
    ids, grads, start = _case(5)
    opt = OptimizerConfig(sparse_optimizer="adagrad", sparse_lr=0.05, streamed_update="off",
                          table_rounding="stochastic")
    ids, grads = ids.to(card), grads.to(card)
    tables = []
    for _ in range(2):
        table = start.to(card, torch.bfloat16)
        state = rowwise.rowwise_init(table, opt)
        launches = (ss.scatter_segment_sum.launches, su.scatter_rowwise_apply.launches)
        drawn = dict(rounding.DRAWS)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rowwise.rowwise_update(table, state, ids, grads, opt,
                                   sr_key=torch.Generator().manual_seed(9))
            torch.cuda.synchronize()
        assert (ss.scatter_segment_sum.launches, su.scatter_rowwise_apply.launches) == (
            launches[0] + 1, launches[1] + 1)
        assert rounding.DRAWS["cuda"] == drawn["cuda"] + 1
        assert rounding.DRAWS["cpu"] == drawn["cpu"]
        # the host's record of the span (the trace also holds its device-side copy)
        spans = [e for e in prof.events()
                 if e.name == "cffm.table_round" and e.device_type == DeviceType.CPU]
        assert len(spans) == 1
        tables.append(table.view(torch.int16))
    assert torch.equal(tables[0], tables[1])

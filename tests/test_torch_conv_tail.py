"""The conv tail's kernel (`cffm_tpu_torch.ops.interaction_conv.conv_tail`).

On the CPU: the shape gate takes every named config and refuses what the
kernel does not take; the kernel's wrapper refuses what the kernel does not
take, and counts its launches and the examples it ran.

On the card (marker `card`, skipped without one): the kernel against its
plain version at both named channel widths, at the cells' batch and at
ragged ones (one-hot conv-2 weights, whose sums are exact: equal, which
holds layer 1 bit for bit; drawn weights: within `chip_smoke.tail_limit`);
a traced forward without a gradient launches it once inside cffm.conv_tail
and no eager pool or layout kernel, and a traced train step launches it
never. Run them there with `python -m pytest --noconftest -m card
tests/test_torch_conv_tail.py` (this file imports no JAX).
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cffm_tpu_torch.config import get_config
from cffm_tpu_torch.ops import interaction_conv as ic
from cffm_tpu_torch.utils import profiling

NAMED = ("criteo_kaggle", "criteo_full", "avazu", "multihost", "movielens")


def _model(name: str = "criteo_kaggle", **kw):
    return dataclasses.replace(get_config(name).model, **kw)


def _layers(c1: int, c2: int, dtype=torch.float32, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    return [{"w": torch.randn((c1, 10, 3), generator=gen).to(dtype),
             "b": (0.1 * torch.randn((c1,), generator=gen)).to(dtype)},
            {"w": (0.1 * torch.randn((c2, c1, 3), generator=gen)).to(dtype),
             "b": (0.1 * torch.randn((c2,), generator=gen)).to(dtype)}]


def _y(b: int, c1: int, seed: int = 1):
    return torch.randn((b, c1, 16), generator=torch.Generator().manual_seed(seed)).to(
        torch.bfloat16)


@pytest.mark.parametrize("name", NAMED)
def test_every_named_config_takes_the_kernel(name):
    cfg = get_config(name).model
    assert ic.tail_kernel_takes(cfg), name
    assert cfg.conv_channels in ((64, 64), (32, 32)) and cfg.compute_dtype == "bfloat16"


@pytest.mark.parametrize("change", [
    dict(conv_channels=(64, 64, 64)),   # a three-layer stack
    dict(conv_channels=(64,)),          # no conv 2
    dict(conv_kernel=5),
    dict(conv_kernel=2),                # an even k
    dict(conv_pool=1),
    dict(embed_dim=8),
    dict(conv_channels=(48, 64)),
    dict(compute_dtype="float32"),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_the_gate_refuses_what_the_kernel_does_not_take(change):
    assert not ic.tail_kernel_takes(_model(**change))


class _FakeCard:
    """Stands in for the kernel on the CPU: fills the output from the plain
    version and records each launch's batch."""

    def __init__(self, cfg):
        self.cfg, self.calls = cfg, []

    def __call__(self, y, w2, b1, b2, out):
        layers = [{"b": b1}, {"w": w2, "b": b2}]
        out.copy_(ic.conv_tail_reference(y, layers, self.cfg))
        self.calls.append(y.shape[0])


@pytest.mark.parametrize("profiled", [False, True], ids=["no_profiler", "profiler"])
@pytest.mark.parametrize("name", ["criteo_kaggle", "movielens"])
def test_launches_and_fused_examples_follow_the_calls(monkeypatch, name, profiled):
    """Three launches through the kernel's wrapper: the launch count rises
    by three; under a profiler `conv_tail.fused_examples` counts the
    examples, and without one nothing is counted. An empty batch launches
    nothing."""
    cfg = get_config(name).model
    c1, c2 = cfg.conv_channels
    fake = _FakeCard(cfg)
    monkeypatch.setattr(ic, "_tail_launch", fake)
    profiling.reset()
    before = ic.conv_tail.launches
    with profile(activities=[ProfilerActivity.CPU]) if profiled else torch.no_grad():
        for b, dtype in ((7, torch.float32), (1, torch.bfloat16), (64, torch.float32)):
            layers = _layers(c1, c2, dtype)
            got = ic._fused_tail(_y(b, c1), layers, cfg)
            assert got.shape == (b, c2 * 4) and got.dtype == torch.bfloat16
            assert torch.equal(got, ic.conv_tail_reference(_y(b, c1), layers, cfg))
        assert ic._fused_tail(_y(0, c1), _layers(c1, c2), cfg).shape == (0, c2 * 4)
    assert fake.calls == [7, 1, 64]
    assert ic.conv_tail.launches == before + 3
    assert profiling.counts().get("conv_tail.fused_examples") == (72 if profiled else None)
    profiling.reset()


@pytest.mark.parametrize("case", [
    "three_layers", "f32_compute", "f32_y", "wrong_channels", "mixed_param_dtypes",
    "f16_params", "strided_w2", "wrong_w2_shape",
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, case):
    cfg = _model()
    fake = _FakeCard(cfg)
    monkeypatch.setattr(ic, "_tail_launch", fake)
    y, layers = _y(5, 64), _layers(64, 64)
    if case == "three_layers":
        cfg = _model(conv_channels=(64, 64, 64))
    elif case == "f32_compute":
        cfg = _model(compute_dtype="float32")
    elif case == "f32_y":
        y = y.float()
    elif case == "wrong_channels":
        y = _y(5, 32)
    elif case == "mixed_param_dtypes":
        layers[1]["b"] = layers[1]["b"].to(torch.bfloat16)
    elif case == "f16_params":
        layers = _layers(64, 64, torch.float16)
    elif case == "strided_w2":
        layers[1]["w"] = torch.cat([layers[1]["w"]] * 2, -1)[..., ::2]
    else:
        layers[1]["w"] = layers[1]["w"][:, :32]
    before = ic.conv_tail.launches
    with pytest.raises(ValueError):
        ic._fused_tail(y, layers, cfg)
    assert not fake.calls and ic.conv_tail.launches == before


def test_conv_tail_refuses_a_device_it_does_not_take():
    y = torch.empty((4, 64, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ic.conv_tail(y, _layers(64, 64), _model())


def test_the_wrapper_on_the_cpu_is_the_plain_version():
    cfg, y, layers = _model(), _y(9, 64), _layers(64, 64)
    before = ic.conv_tail.launches
    assert torch.equal(ic.conv_tail(y, layers, cfg), ic.conv_tail_reference(y, layers, cfg))
    assert ic.conv_tail.launches == before


# --- on the card ------------------------------------------------------------

CELL_BATCH = 65536


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False   # tail_limit's f32 sums
    yield torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.card
@pytest.mark.parametrize("batch", [CELL_BATCH, 65537, 1000])
@pytest.mark.parametrize("name", ["criteo_kaggle", "movielens"])
def test_kernel_against_the_plain_version(card, name, batch):
    import chip_smoke

    cfg = get_config(name).model
    c1, c2 = cfg.conv_channels
    gen = torch.Generator(device=card).manual_seed(batch)
    y = torch.randn((batch, c1, 16), generator=gen, device=card).to(torch.bfloat16)
    for onehot in (True, False):
        layers = chip_smoke._tail_layers(c1, c2, gen, torch.float32, onehot)
        before = ic.conv_tail.launches
        got = ic.conv_tail(y, layers, cfg)
        want = ic.conv_tail_reference(y, layers, cfg)
        torch.cuda.synchronize()
        assert ic.conv_tail.launches == before + 1
        assert got.shape == want.shape == (batch, c2 * 4) and got.dtype == want.dtype
        if onehot:   # every sum exact: layer 1 and the roundings bit for bit
            assert torch.equal(got, want)
        else:
            diff = (got.float() - want.float()).abs()
            assert bool((diff <= chip_smoke.tail_limit(y, layers, cfg)).all())


def _launched_in(fn, span: str):
    """(names of the device records launched inside `span`, names of all
    device records) while fn runs under the profiler, paired by the
    profiler's correlation ids; and the count of `span`'s host records."""
    from benchmark import spans, trace

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    marks = [(trace._ns(e), trace._ns(e, end=True)) for e in events
             if e.name() == span and not trace._on_device(e)]
    calls = {e.correlation_id() for e in events
             if not trace._on_device(e) and e.name() in spans.LAUNCHES
             and any(a <= trace._ns(e) <= b for a, b in marks)}
    device = [e for e in events if trace._on_device(e) and not trace._annotation(e)]
    return ([e.name() for e in device if e.correlation_id() in calls],
            [e.name() for e in device], len(marks))


@pytest.mark.card
def test_a_traced_forward_launches_the_kernel_once_and_a_train_step_never(card):
    from cffm_tpu_torch import train
    from cffm_tpu_torch.models import cffm as model_lib

    cfg = get_config("criteo_kaggle")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=CELL_BATCH))
    mcfg = cfg.model
    fn = train.default_interaction_fn(cfg)
    state = train.create_state(cfg, torch.Generator(device=card).manual_seed(0))
    gen = torch.Generator(device=card).manual_seed(1)
    ids = torch.stack([torch.randint(0, v, (CELL_BATCH,), generator=gen, device=card)
                       for v in mcfg.vocab_sizes], 1)
    ids = (ids + torch.as_tensor(model_lib.field_offsets(mcfg), device=card)).int()
    dense = torch.randn((CELL_BATCH, mcfg.num_dense), generator=gen, device=card)
    labels = (torch.rand((CELL_BATCH,), generator=gen, device=card) < 0.25).float()

    def step():
        nonlocal state
        state, _ = train.train_step(state, ids, dense, labels, cfg, fn)

    def forward():
        with torch.inference_mode():
            model_lib.forward(state.params, ids, dense, mcfg, interaction_fn=fn)

    for run in (step, forward):
        run()  # builds and warms
        profiling.reset()
        before = ic.conv_tail.launches
        inside, every, spans_seen = _launched_in(run, "cffm.conv_tail")
        assert spans_seen == 1, run.__name__
        if run is step:
            assert ic.conv_tail.launches == before, inside
            assert not any("conv_tail_fwd" in n for n in every), every
            continue
        assert ic.conv_tail.launches == before + 1
        assert len(inside) == 1 and "conv_tail_fwd_kernel" in inside[0], inside
        assert not any("reduce_kernel" in n or "transposeBlock" in n for n in every), every
        assert profiling.counts()["conv_tail.fused_examples"] == CELL_BATCH
        profiling.reset()

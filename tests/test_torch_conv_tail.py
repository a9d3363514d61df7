"""The conv tail's kernels (`cffm_tpu_torch.ops.interaction_conv.conv_tail`,
`conv_tail_bwd` and the Function `conv_tail_with_grad`).

On the CPU: the shape gate takes every named config and refuses what the
kernels do not take; the wrappers refuse what the kernels do not take, and
count their launches and the examples they ran; the backward's plain
version against autograd through the forward's plain version (ties in the
pools, windows that are all <= 0, both channel widths, f32 and bf16
weights); under a gradient, a CPU tensor and a config the gate refuses keep
the eager tail.

On the card (marker `card`, skipped without one): the forward kernel
against its plain version at both named channel widths, at the cells'
batch and at ragged ones (one-hot conv-2 weights, whose sums are exact:
equal, which holds layer 1 bit for bit; drawn weights: within
`chip_smoke.tail_limit`); the backward kernel against its plain version at
the same widths and at B = 65536, 65537, 1000, 17 and 1 (one-hot weights,
and values on a coarse grid whose sums are exact: gy equal; the weight
and bias gradients within `chip_smoke.grad_close`), two calls bit-equal;
the Function against eager autograd; a traced forward without a gradient
launches the forward kernel once inside cffm.conv_tail and no eager pool
or layout kernel, and a traced train step launches the forward once there
and the backward once inside cffm.conv_tail_bwd. Run them there with
`python -m pytest --noconftest -m card tests/test_torch_conv_tail.py`
(this file imports no JAX).
"""

import dataclasses

import chip_smoke
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


# --- the backward's plain version, the Function and the route -------------


def _tail_case(b: int, c1: int, c2: int, dtype, onehot: bool, seed: int):
    """y, g and the tail's layers with the windows the backward must route:
    a quarter of layer 1's channels with equal position pairs (ties), a
    quarter all <= 0, a quarter constant along positions (with one-hot
    conv-2 weights, ties in conv 2's windows); conv 2's last quarter of
    channels biased all <= 0."""
    gen = torch.Generator().manual_seed(seed)
    y = torch.randn((b, c1, 16), generator=gen)
    q = c1 // 4
    y[:, :q, 1::2] = y[:, :q, 0::2]
    y[:, q : 2 * q] = -y[:, q : 2 * q].abs() - 0.5
    y[:, 2 * q : 3 * q] = y[:, 2 * q : 3 * q, :1].abs()
    y = y.to(torch.bfloat16)
    if onehot:
        w2 = torch.zeros((c2, c1, 3))
        pick = torch.randint(0, c1 * 3, (c2,), generator=gen)
        w2.view(c2, -1)[torch.arange(c2), pick] = 1.0
    else:
        w2 = torch.randn((c2, c1, 3), generator=gen) * (2.0 / (3 * c1)) ** 0.5
    b1 = 0.1 * torch.randn((c1,), generator=gen)
    b1[q : 2 * q] = -0.25
    b2 = 0.1 * torch.randn((c2,), generator=gen)
    b2[-(c2 // 4):] = -100.0
    g = torch.randn((b, c2 * 4), generator=gen).to(torch.bfloat16)
    layers = [{"b": b1.to(dtype)}, {"w": w2.to(dtype), "b": b2.to(dtype)}]
    return y, g, layers


@pytest.mark.parametrize("onehot", [True, False], ids=["onehot_w2", "drawn_w2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 17, 37])
@pytest.mark.parametrize("channels", [(64, 64), (32, 32), (32, 64), (64, 32)],
                         ids=lambda c: f"{c[0]}x{c[1]}")
def test_plain_backward_matches_autograd_through_the_plain_forward(channels, batch, dtype,
                                                                    onehot):
    """`conv_tail_bwd_reference` against torch.autograd through
    `conv_tail_reference` in bf16 (B = 37 leaves a ragged tile of 16): gy
    equal where conv 2's input gradient has one term (one-hot weights),
    else within `chip_smoke.grad_close`, as are the weight and bias
    gradients, each in its parameter's dtype. The case holds ties in both
    pools' windows and windows that are all <= 0."""
    c1, c2 = channels
    cfg = _model(conv_channels=channels)
    y, g, layers = _tail_case(batch, c1, c2, dtype, onehot, seed=batch + c1 + c2)
    x1 = (y + layers[0]["b"].to(y.dtype)[None, :, None]).float()
    assert bool((x1[..., 0::2] == x1[..., 1::2]).logical_and(x1[..., 0::2] > 0).any())
    assert bool((x1.reshape(batch, c1, 8, 2).amax(-1) <= 0).any())
    _, want = chip_smoke.eager_tail_grads(y, g, layers, cfg)
    got = ic.conv_tail_bwd_reference(y, g, layers, cfg)
    assert [t.dtype for t in got] == [torch.bfloat16, dtype, dtype, dtype]
    if onehot:
        assert torch.equal(got[0], want[0])
    for name, a, b in zip(("gy", "dw2", "db1", "db2"), got, want):
        assert chip_smoke.grad_close(a, b), name


def test_pool_gradient_goes_to_the_first_positive_maximum():
    """Each window's gradient lands on its first maximum if that is > 0:
    (1, 1) -> first, (-1, 2) -> second, (0, 0) and (-2, -1) -> neither,
    (3, 1) -> first; a ragged tail gets none."""
    x = torch.tensor([[[1.0, 1.0, -1.0, 2.0, 0.0, 0.0, -2.0, -1.0, 3.0, 1.0, 5.0]]])
    g = torch.tensor([[[10.0, 20.0, 30.0, 40.0, 50.0]]])
    want = torch.tensor([[[10.0, 0.0, 0.0, 20.0, 0.0, 0.0, 0.0, 0.0, 50.0, 0.0, 0.0]]])
    assert torch.equal(ic._pool_grad(x, g, 2), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_function_on_the_cpu_is_the_two_plain_versions(dtype):
    """`conv_tail_with_grad` on CPU tensors: the forward's plain version,
    and gradients from the backward's plain version into every leaf, within
    `chip_smoke.grad_close` of autograd through the eager tail (gy equal
    with one-hot weights)."""
    cfg = _model()
    y, g, layers = _tail_case(17, 64, 64, dtype, True, seed=5)
    feats, want = chip_smoke.eager_tail_grads(y, g, layers, cfg)
    leaves = [y.clone().requires_grad_()] + [
        t.clone().requires_grad_() for t in (layers[1]["w"], layers[0]["b"], layers[1]["b"])]
    y_, w2, b1, b2 = leaves
    out = ic.conv_tail_with_grad(y_, [{"b": b1}, {"w": w2, "b": b2}], cfg)
    assert torch.equal(out, feats) and out.requires_grad
    out.backward(g)
    assert torch.equal(y_.grad, want[0])
    for name, leaf, w in zip(("dw2", "db1", "db2"), leaves[1:], want[1:]):
        assert chip_smoke.grad_close(leaf.grad, w), name


@pytest.mark.parametrize("case", ["cpu_tensor", "f32_compute", "other_widths", "no_kernel"])
def test_under_grad_the_route_keeps_the_eager_tail(monkeypatch, case):
    """With gradients taken, the interaction fn keeps the eager tail for a
    CPU tensor at a shape the kernels take, for a config the gate refuses
    and without use_kernel: neither kernel's wrapper nor the Function is
    called, and the rows and every conv leaf get gradients."""
    channels = (48, 64) if case == "other_widths" else (64, 64)
    cfg = _model(conv_channels=channels,
                 compute_dtype="float32" if case == "f32_compute" else "bfloat16")
    assert ic.tail_kernel_takes(cfg) == (case in ("cpu_tensor", "no_kernel"))
    for name in ("conv_tail", "conv_tail_with_grad", "conv_tail_bwd"):
        monkeypatch.setattr(ic, name, lambda *a, name=name: pytest.fail(f"{name} called"))
    fn = ic.make_interaction_fn(use_kernel=case != "no_kernel")
    gen = torch.Generator().manual_seed(3)
    f = cfg.num_fields
    emb = torch.randn((5, f, f, cfg.embed_dim), generator=gen).requires_grad_()
    layers = [{n: t.requires_grad_() for n, t in lay.items()}
              for lay in _layers(channels[0], channels[1], seed=4)]
    layers[0]["w"] = torch.randn((channels[0], f * (f - 1) // 2, 3), generator=gen
                                 ).requires_grad_()
    cdt = torch.float32 if case == "f32_compute" else torch.bfloat16
    out = fn(emb.to(cdt), layers, cfg)
    out.float().sum().backward()
    assert emb.grad is not None and all(t.grad is not None for lay in layers for t in lay.values())


class _FakeBwdCard:
    """Stands in for the backward kernel on the CPU: fills its outputs from
    the plain version and records each launch's batch."""

    def __init__(self, cfg):
        self.cfg, self.calls = cfg, []

    def __call__(self, y, g, w2, b1, b2, gy, dw2, db1, db2):
        got = ic.conv_tail_bwd_reference(y, g, [{"b": b1}, {"w": w2, "b": b2}], self.cfg)
        for out, v in zip((gy, dw2, db1, db2), got):
            out.copy_(v)
        self.calls.append(y.shape[0])


@pytest.mark.parametrize("profiled", [False, True], ids=["no_profiler", "profiler"])
@pytest.mark.parametrize("name", ["criteo_kaggle", "movielens"])
def test_backward_launches_and_examples_follow_the_calls(monkeypatch, name, profiled):
    """Three launches through the backward's wrapper: the launch count rises
    by three and the outputs are the plain version's; under a profiler
    `conv_tail.bwd_examples` counts the examples, and without one nothing is
    counted. An empty batch launches nothing and gives zero gradients."""
    cfg = get_config(name).model
    c1, c2 = cfg.conv_channels
    fake = _FakeBwdCard(cfg)
    monkeypatch.setattr(ic, "_tail_bwd_launch", fake)
    profiling.reset()
    before = ic.conv_tail_bwd.launches
    with profile(activities=[ProfilerActivity.CPU]) if profiled else torch.no_grad():
        for b, dtype in ((7, torch.float32), (1, torch.bfloat16), (64, torch.float32)):
            y, g, layers = _tail_case(b, c1, c2, dtype, False, seed=b)
            got = ic._fused_tail_bwd(y, g, layers, cfg)
            want = ic.conv_tail_bwd_reference(y, g, layers, cfg)
            assert all(torch.equal(a, w) and a.dtype == w.dtype for a, w in zip(got, want))
        y, g, layers = _tail_case(0, c1, c2, torch.float32, False, seed=0)
        gy, *grads = ic._fused_tail_bwd(y, g, layers, cfg)
        assert gy.shape == (0, c1, 16) and all(not t.any() for t in grads)
    assert fake.calls == [7, 1, 64]
    assert ic.conv_tail_bwd.launches == before + 3
    assert profiling.counts().get("conv_tail.bwd_examples") == (72 if profiled else None)
    profiling.reset()


@pytest.mark.parametrize("case", ["f32_compute", "f32_y", "wrong_channels", "mixed_param_dtypes",
                                  "g_too_narrow", "g_f32"])
def test_backward_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, case):
    cfg = _model()
    fake = _FakeBwdCard(cfg)
    monkeypatch.setattr(ic, "_tail_bwd_launch", fake)
    y, g, layers = _tail_case(5, 64, 64, torch.float32, False, seed=1)
    if case == "f32_compute":
        cfg = _model(compute_dtype="float32")
    elif case == "f32_y":
        y = y.float()
    elif case == "wrong_channels":
        y = _y(5, 32)
    elif case == "mixed_param_dtypes":
        layers[1]["b"] = layers[1]["b"].to(torch.bfloat16)
    elif case == "g_too_narrow":
        g = g[:, :128]
    else:
        g = g.float()
    before = ic.conv_tail_bwd.launches
    with pytest.raises(ValueError):
        ic._fused_tail_bwd(y, g, layers, cfg)
    assert not fake.calls and ic.conv_tail_bwd.launches == before


def test_conv_tail_bwd_refuses_a_device_it_does_not_take():
    y = torch.empty((4, 64, 16), dtype=torch.bfloat16, device="meta")
    g = torch.empty((4, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ic.conv_tail_bwd(y, g, _layers(64, 64), _model())


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
@pytest.mark.parametrize("batch", [CELL_BATCH, 65537, 1000, 17, 1])
@pytest.mark.parametrize("name", ["criteo_kaggle", "movielens"])
def test_backward_kernel_against_the_plain_version(card, name, batch):
    """The backward kernel against `conv_tail_bwd_reference`, f32 and bf16
    weights: with one-hot conv-2 weights and with values on coarse grids
    (every sum behind gy exact) gy is equal; the weight and bias gradients,
    long f32 sums, within `chip_smoke.grad_close`. A second call gives the same bits."""
    cfg = get_config(name).model
    c1, c2 = cfg.conv_channels
    gen = torch.Generator(device=card).manual_seed(batch)
    for dtype in (torch.float32, torch.bfloat16):
        y = torch.randn((batch, c1, 16), generator=gen, device=card).to(torch.bfloat16)
        g = torch.randn((batch, c2 * 4), generator=gen, device=card).to(torch.bfloat16)
        cases = {"one-hot": (y, g, chip_smoke._tail_layers(c1, c2, gen, dtype, True)),
                 "grid": chip_smoke.grid_tail_case(batch, c1, c2, gen, dtype)}
        for what, (y, g, layers) in cases.items():
            before = ic.conv_tail_bwd.launches
            got = ic.conv_tail_bwd(y, g, layers, cfg)
            again = ic.conv_tail_bwd(y, g, layers, cfg)
            want = ic.conv_tail_bwd_reference(y, g, layers, cfg)
            torch.cuda.synchronize()
            assert ic.conv_tail_bwd.launches == before + 2, what
            assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                       for a, b in zip(got, again)), what
            assert torch.equal(got[0], want[0]), what
            for part, a, b in zip(("dw2", "db1", "db2"), got[1:], want[1:]):
                assert chip_smoke.grad_close(a, b), (what, part, dtype)


@pytest.mark.card
@pytest.mark.parametrize("name", ["criteo_kaggle", "movielens"])
def test_the_function_against_eager_autograd(card, name):
    """`conv_tail_with_grad` (the forward kernel, then the backward kernel)
    against torch.autograd through the eager tail on a small batch with
    values on coarse grids: the features and gy equal, the leaves'
    gradients within `chip_smoke.grad_close`, each in its leaf's dtype."""
    cfg = get_config(name).model
    c1, c2 = cfg.conv_channels
    gen = torch.Generator(device=card).manual_seed(7)
    y, g, layers = chip_smoke.grid_tail_case(300, c1, c2, gen, torch.float32)
    feats, want = chip_smoke.eager_tail_grads(y, g, layers, cfg)
    leaves = [y.clone().requires_grad_()] + [
        t.clone().requires_grad_() for t in (layers[1]["w"], layers[0]["b"], layers[1]["b"])]
    y_, w2, b1, b2 = leaves
    before = (ic.conv_tail.launches, ic.conv_tail_bwd.launches)
    out = ic.conv_tail_with_grad(y_, [{"b": b1}, {"w": w2, "b": b2}], cfg)
    out.backward(g)
    torch.cuda.synchronize()
    assert (ic.conv_tail.launches, ic.conv_tail_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out.detach(), feats)
    assert torch.equal(y_.grad, want[0])
    for part, leaf, w in zip(("dw2", "db1", "db2"), leaves[1:], want[1:]):
        assert chip_smoke.grad_close(leaf.grad, w), part


@pytest.mark.card
def test_a_traced_train_step_launches_both_tail_kernels_once_and_a_forward_only_the_forward(card):
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
        before = (ic.conv_tail.launches, ic.conv_tail_bwd.launches)
        inside, every, spans_seen = _launched_in(run, "cffm.conv_tail")
        assert spans_seen == 1, run.__name__
        assert ic.conv_tail.launches == before[0] + 1
        assert len(inside) == 1 and "conv_tail_fwd_kernel" in inside[0], inside
        assert profiling.counts()["conv_tail.fused_examples"] == CELL_BATCH
        if run is forward:
            assert ic.conv_tail_bwd.launches == before[1]
            assert not any("conv_tail_bwd" in n for n in every), every
            assert not any("reduce_kernel" in n or "transposeBlock" in n for n in every), every
            profiling.reset()
            continue
        profiling.reset()
        inside, every, spans_seen = _launched_in(run, "cffm.conv_tail_bwd")
        assert spans_seen == 1
        assert ic.conv_tail_bwd.launches == before[1] + 2  # both traced steps
        assert sum("conv_tail_bwd_kernel" in n for n in inside) == 1, inside
        assert sum("conv_tail_bwd_kernel" in n for n in every) == 1, every
        assert not any("transposeBlock" in n for n in every), every
        assert profiling.counts()["conv_tail.bwd_examples"] == CELL_BATCH
        profiling.reset()

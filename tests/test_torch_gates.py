"""The port's shape gates, and the overrides they decide, against the JAX
package, which takes every shape.

Three gates, each a function of shapes decided before any launch:
`streamed_update.bucketed_kernel_takes` (kernel 7's row width; a wider
table takes kernels 3-4), `interaction_conv.bwd_kernel_takes` (the shapes
the backward kernels take; on the card the backward raises for others)
and `interaction_conv.kernel_takes_width` (every odd k; an even k raises,
as JAX asserts). The backward's CUDA-core kernel walks layer 1 in slices
of channels and taps, so it takes any C1 and every odd k whose smallest
slice fits shared memory. The model sends every odd k to the fused
entries, as JAX sends every odd k to its Pallas kernels; on the CPU the
entries take their plain versions. The JAX side
runs its Pallas kernels in interpret mode (bt=8). f32 compute: rtol 2e-4, atol 2e-5 (sum orders); dW atol 1e-4.
The bucketed update at W > 2048 is held as the streamed route is
(tests/test_torch_rowwise.py): table steps at atol 1% of the largest
step, since a row's bf16-rounded gradient sum can sit one bf16 ulp from
JAX's. The optimizer state is held at rtol 2^-6 (two bf16 ulps): the
flattened route rounds a row's total to bf16 and, with a clip, rounds
the clipped total again, where JAX's bucketed kernel keeps both in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu.config import ModelConfig as JaxModelConfig
from cffm_tpu.config import OptimizerConfig as JaxOpt
from cffm_tpu.models import cffm as jax_model
from cffm_tpu.ops import interaction_conv as jax_ic
from cffm_tpu.optim import rowwise as jax_rw
from cffm_tpu_torch.config import ModelConfig, OptimizerConfig
from cffm_tpu_torch.convert import params_from_jax
from cffm_tpu_torch.models import cffm as model
from cffm_tpu_torch.ops import interaction_conv as ic
from cffm_tpu_torch.ops import streamed_update as su
from cffm_tpu_torch.optim import rowwise as rw

B = 16
RTOL, ATOL = 2e-4, 2e-5


def _cfg(**kw):
    # F=15, d=16: row_width 240 -> table_width 256 with the fused column
    return ModelConfig(**{"num_fields": 15, "vocab_sizes": (40,) * 15, "embed_dim": 16, **kw})


# bwd: (k, C1, d, cross). Channel and tap slices keep the CUDA-core kernel's
# shared memory within the card's (d=16: 196 KB at k=9, 64 channels; 201 KB
# at k=13, 8 taps); only a d whose smallest slice does not fit is refused
GATE_CASES = [
    ("bucketed", 640, True), ("bucketed", 2048, True), ("bucketed", 2560, False),
    ("bwd", (3, 32, 16, "field_aware"), True), ("bwd", (3, 64, 16, "field_aware"), True),
    ("bwd", (3, 128, 16, "field_aware"), True), ("bwd", (3, 128, 16, "hadamard"), True),
    ("bwd", (5, 128, 16, "field_aware"), True), ("bwd", (5, 128, 16, "hadamard"), True),
    ("bwd", (7, 128, 16, "field_aware"), True), ("bwd", (3, 136, 16, "field_aware"), True),
    ("bwd", (9, 64, 16, "field_aware"), True), ("bwd", (9, 64, 16, "hadamard"), True),
    ("bwd", (7, 64, 32, "field_aware"), True), ("bwd", (11, 8, 16, "field_aware"), True),
    ("bwd", (7, 128, 16, "hadamard"), True), ("bwd", (9, 128, 16, "field_aware"), True),
    ("bwd", (13, 64, 16, "field_aware"), True), ("bwd", (3, 64, 512, "field_aware"), False),
    ("bwd", (4, 64, 16, "field_aware"), False),
    ("width", 1, True), ("width", 3, True), ("width", 7, True), ("width", 9, True),
    ("width", 11, True), ("width", 13, True), ("width", 4, False),
]


@pytest.mark.parametrize("gate,arg,want", GATE_CASES)
def test_gate_decisions(gate, arg, want):
    if gate == "bucketed":
        assert su.bucketed_kernel_takes(arg) is want
        assert su.bucketed_kernel_takes(arg, torch.device("cpu")) is want
    elif gate == "bwd":
        k, c1, d, cross = arg
        cfg = _cfg(conv_kernel=k, embed_dim=d, cross=cross)
        assert ic.bwd_kernel_takes(cfg, c1) is want
        assert ic.bwd_kernel_takes(cfg, c1, torch.device("cpu")) is want
    else:
        assert ic.kernel_takes_width(arg) is want


# kernels 4-5's route per row width: the column pairs a lane holds on the
# register route, 0 for the chunked route, -1 for a width they do not take
ROUTE_CASES = [(64, 4), (128, 4), (256, 4), (320, 8), (384, 8), (512, 8), (576, 10),
               (640, 10), (704, 16), (1024, 16), (1088, 0), (2048, 0), (2560, 0), (8192, 0),
               (0, -1), (-64, -1), (100, -1), (672, -1)]


@pytest.mark.parametrize("w,want", ROUTE_CASES)
def test_streamed_route_decisions(w, want):
    """The CPU copy of cffm_streamed_route (chip_smoke.py's parity_apply
    holds it against the library at every width to 8192)."""
    assert su.streamed_route(w) == want
    assert su.streamed_route(w, torch.device("cpu")) == want
    if want > 0:
        assert want in su.STREAMED_REGISTER_PAIRS and w <= 64 * want


def test_gate_constants_match_the_kernels_caps():
    assert su.BUCKETED_MAX_WIDTH == 64 * 32 == 2048
    assert ic.BWD_CHANNEL_SLICE == 256 // 32 * 8 and ic.BWD_TAP_SLICE == 8
    assert ic.BWD_SMEM_MAX == 227 * 1024 - 2 * 32 * 4
    assert ic.KERNEL_WIDTHS == (1, 3, 5, 7, 9)
    # slices: the most channels that fit, a multiple of 8
    assert ic.bwd_core_channels(16, 3, 136, False) == 64
    assert ic.bwd_core_channels(16, 13, 64, True) == 64
    assert ic.bwd_core_channels(32, 7, 64, False) == 56
    assert ic.bwd_core_channels(512, 3, 64, False) == 0


def test_backward_refuses_a_shape_its_kernels_do_not_take():
    """The wrapper raises from the gate, before the library is asked: at
    d=512 not even an 8-channel slice fits shared memory."""
    cfg = _cfg(num_fields=4, vocab_sizes=(40,) * 4, conv_kernel=3, embed_dim=512)
    emb = torch.zeros((2, 4, 4, 512))
    w1 = torch.zeros((8, cfg.num_pairs, 3))
    parts = [(emb, 4, emb.stride(1), emb.stride(0))]
    with pytest.raises(ValueError, match="do not take C1=8 at k=3, d=512"):
        ic.cross_conv1_bwd(parts, parts, w1, torch.zeros((2, 8, 512)), None, cfg,
                           cfg.row_width)


def test_model_takes_the_full_rows_route_at_k9():
    """k=9 takes the fused full-rows entry, as JAX takes its kernel at k=9."""
    cfg = _cfg(conv_kernel=9)
    fn = ic.make_interaction_fn()
    params = {"conv": [{"w": torch.zeros(1)}]}
    # every field small: the whole row is the prefix
    assert model.route(params, cfg, fn) == model.Route(True, True, 15)
    assert model.route(params, _cfg(conv_kernel=4), fn) == model.Route(False, False, 0)
    calls = []
    real = fn.full_rows
    fn.full_rows = lambda *a: calls.append(1) or real(*a)
    kw = dict(num_fields=15, vocab_sizes=(40,) * 15, embed_dim=16, conv_channels=(4,),
              conv_kernel=9, tower_hidden=(8,))
    cfg = ModelConfig(**kw)
    assert cfg.fused_linear
    params = params_from_jax(jax.tree.map(
        np.asarray, jax_model.init_params(jax.random.key(1), JaxModelConfig(**kw))))
    rows = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, cfg.num_fields, cfg.table_width)).astype(np.float32))
    route = model.route(params, cfg, fn).batch_major()
    assert route == model.Route(True, False, 0)
    out = model.forward_from_rows(params, route, [rows], None, cfg, interaction_fn=fn)
    assert out.shape == (B,) and torch.isfinite(out).all() and calls == [1]


def _interaction_vs_jax(cross_kind, k, c1, monkeypatch):
    """Layer 1 (C1 channels, width k) and a conv tail through the port's
    fused entry (its plain version on the CPU) against JAX's
    interaction_fn, whose layer 1 is its Pallas kernel entry; forward and
    the gradients to the rows and both layers' weights."""
    kw = dict(num_fields=6, vocab_sizes=(40,) * 6, embed_dim=16, cross=cross_kind,
              conv_channels=(c1, 4), conv_kernel=k, compute_dtype="float32")
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(9)
    shape = (B, 6, 6, 16) if cross_kind == "field_aware" else (B, 6, 16)
    emb = rng.normal(size=shape).astype(np.float32)
    layers = [{"w": (rng.normal(size=(c1, 15, k)) * 0.1).astype(np.float32),
               "b": rng.normal(size=(c1,)).astype(np.float32)},
              {"w": (rng.normal(size=(4, c1, k)) * 0.1).astype(np.float32),
               "b": rng.normal(size=(4,)).astype(np.float32)}]
    jfn = jax_ic.make_interaction_fn(use_pallas=True, bt=8, interpret=True)
    j_layers = [{n: jnp.asarray(v) for n, v in lay.items()} for lay in layers]
    want = jfn(jnp.asarray(emb), j_layers, jcfg)
    gout = rng.normal(size=want.shape).astype(np.float32)

    def loss(e, lays):
        return jnp.sum(jfn(e, lays, jcfg) * gout)

    de_want, dl_want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(emb), j_layers)

    calls = []
    real = ic.cross_conv1
    monkeypatch.setattr(ic, "cross_conv1", lambda *a: calls.append(1) or real(*a))
    e = torch.from_numpy(emb).requires_grad_()
    t_layers = [{n: torch.from_numpy(v).requires_grad_() for n, v in lay.items()}
                for lay in layers]
    got = ic.make_interaction_fn()(e, t_layers, cfg)
    assert calls == [1]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    (got * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(de_want), rtol=RTOL, atol=ATOL)
    for lay, jlay in zip(t_layers, dl_want):
        for n in ("w", "b"):
            np.testing.assert_allclose(lay[n].grad.numpy(), np.asarray(jlay[n]),
                                       rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("k", [9, 11])
@pytest.mark.parametrize("cross_kind", ["field_aware", "hadamard"])
def test_k9_interaction_and_grads_match_jax_kernel_entry(cross_kind, k, monkeypatch):
    assert ic.kernel_takes_width(k) and ic.bwd_kernel_takes(_cfg(conv_kernel=k), 8)
    _interaction_vs_jax(cross_kind, k, 8, monkeypatch)


@pytest.mark.parametrize("c1", [128, 136])
@pytest.mark.parametrize("cross_kind", ["field_aware", "hadamard"])
def test_c1_128_interaction_and_grads_match_jax_kernel_entry(cross_kind, c1, monkeypatch):
    assert ic.bwd_kernel_takes(_cfg(cross=cross_kind), c1)
    _interaction_vs_jax(cross_kind, 3, c1, monkeypatch)


def test_k9_model_forward_matches_jax_through_the_kernel_route(monkeypatch):
    """criteo-shaped hybrid config at k=9: JAX takes its split field-major
    kernel, and so does the port (its plain version on the CPU); the
    logits match."""
    kw = dict(num_fields=15, vocab_sizes=(8,) * 4 + (600,) * 11, embed_dim=16,
              conv_channels=(8, 8), conv_kernel=9, tower_hidden=(16,), num_dense=3,
              compute_dtype="float32")
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    params = jax_model.init_params(jax.random.key(5), jcfg)
    rng = np.random.default_rng(0)
    ids = np.stack([rng.integers(0, v, size=B) for v in jcfg.vocab_sizes], axis=1)
    ids = (ids + jax_model.field_offsets(jcfg)[None, :]).astype(np.int32)
    dense = rng.normal(size=(B, 3)).astype(np.float32)
    want = jax_model.forward(params, jnp.asarray(ids), jnp.asarray(dense), jcfg,
                             interaction_fn=jax_ic.make_interaction_fn(
                                 use_pallas=True, bt=8, interpret=True))
    calls = []
    for name in ("cross_conv1", "cross_conv1_lin", "cross_conv1_lin_fm",
                 "cross_conv1_lin_fm2"):
        real = getattr(ic, name)
        monkeypatch.setattr(ic, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    got = model.forward(params_from_jax(jax.tree.map(np.asarray, params)),
                        torch.from_numpy(ids), torch.from_numpy(dense), cfg,
                        interaction_fn=ic.make_interaction_fn())
    assert calls == ["cross_conv1_lin_fm2"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("optimizer", ["adagrad", "rowwise_adam"])
def test_bucketed_update_wider_than_kernel7_matches_jax(optimizer, monkeypatch):
    """W = 2560 (criteo_kaggle at embed_dim=64): the gate sends the buckets
    to the flattened rowwise_update route; JAX's bucketed kernel has no cap.
    Four overlapping buckets, sentinel V in the tails, garbage grads there."""
    v, w, nb, c = 1024, 2560, 4, 256
    assert not su.bucketed_kernel_takes(w)
    rng = np.random.default_rng(4)
    table = rng.normal(size=(v, w)).astype(np.float32)
    ids = np.full((nb, c), v, np.int32)
    for o in range(nb):
        rows = np.union1d(np.arange(8), rng.choice(v, size=150, replace=False))
        ids[o, :len(rows)] = rows
    grads = (rng.normal(size=(nb, c, w)) * 0.1).astype(np.float32)
    kw = dict(sparse_optimizer=optimizer, sparse_lr=0.05, streamed_update="on",
              clip_norm=0.5)
    jopt, opt = JaxOpt(**kw), OptimizerConfig(**kw)
    js = jax_rw.rowwise_init(jnp.asarray(table), jopt)
    jt, js = jax_rw.bucketed_rowwise_update(jnp.asarray(table), js, jnp.asarray(ids),
                                            jnp.asarray(grads), jopt)
    tt = torch.from_numpy(table.copy())
    ts = rw.rowwise_init(tt, opt)
    calls = []
    real = rw.rowwise_update
    monkeypatch.setattr(rw, "rowwise_update", lambda *a, **k: calls.append(1) or real(*a, **k))
    got_t, got_s = rw.bucketed_rowwise_update(tt, ts, torch.from_numpy(ids),
                                              torch.from_numpy(grads), opt)
    assert got_t is tt and calls == [1]
    d_want, d_got = np.asarray(jt) - table, got_t.numpy() - table
    np.testing.assert_allclose(d_got, d_want, atol=0.01 * np.abs(d_want).max())
    touched = np.zeros(v, bool)
    touched[ids[ids < v]] = True
    np.testing.assert_array_equal(got_t.numpy()[~touched], table[~touched])
    for k, val in js.items():
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(val), rtol=2.0**-6, atol=1e-7)

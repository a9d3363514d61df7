"""The port's cross+conv1 entries (plain version, CPU) vs the JAX entries.

The JAX side runs its Pallas kernel in interpret mode (bt=8), as the
JAX package's own kernel tests do. Inputs are numpy draws handed to both.
f32 compute: rtol 2e-4, atol 2e-5 (only the sum order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu.config import ModelConfig as JaxModelConfig
from cffm_tpu.ops import cross as jax_cross
from cffm_tpu.ops import interaction_conv as jax_ic
from cffm_tpu_torch.config import ModelConfig
from cffm_tpu_torch.ops import cross
from cffm_tpu_torch.ops import interaction_conv as ic

RTOL, ATOL = 2e-4, 2e-5
B = 16


def _cfgs(**kw):
    kw.setdefault("compute_dtype", "float32")
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _w1(cfg, c1, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(c1, cfg.num_pairs, cfg.conv_kernel)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    ic.reset_launches()
    yield
    # CPU tensors take the plain version: the kernel is never launched
    assert [fn.launches for fn in ic.ENTRIES] == [0, 0, 0, 0]


@pytest.mark.parametrize("cross_kind", ["field_aware", "hadamard"])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_sliced_entry_matches_jax(cross_kind, k):
    jcfg, cfg = _cfgs(num_fields=5, vocab_sizes=(32,) * 5, embed_dim=8,
                      cross=cross_kind, conv_channels=(12,), conv_kernel=k)
    shape = ((B, 5, 5, 8) if cross_kind == "field_aware" else (B, 5, 8))
    emb = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    w1 = _w1(cfg, 12)
    want = jax_ic.cross_conv1_pallas(jnp.asarray(emb), jnp.asarray(w1), jcfg, 8, True)
    got = ic.cross_conv1(torch.from_numpy(emb), torch.from_numpy(w1), cfg)
    assert got.shape == (B, 12, 8)
    _close(got, want)
    _close(ic.cross_conv1_reference(torch.from_numpy(emb), torch.from_numpy(w1), cfg),
           jax_ic.cross_conv1_reference(jnp.asarray(emb), jnp.asarray(w1), jcfg))


def _full_rows_cfgs():
    # F=15, d=16: row_width 240 -> table_width 256 with the fused column
    jcfg, cfg = _cfgs(num_fields=15, vocab_sizes=(50,) * 15, embed_dim=16,
                      conv_channels=(8,))
    assert cfg.fused_linear and cfg.table_width == 256
    return jcfg, cfg


def _rows_fm(cfg, seed=0):
    return np.random.default_rng(seed).normal(
        size=(cfg.num_fields, B, cfg.table_width)).astype(np.float32)


def test_flat_full_rows_entry_matches_jax():
    jcfg, cfg = _full_rows_cfgs()
    emb2d = np.ascontiguousarray(_rows_fm(cfg).transpose(1, 0, 2)).reshape(B, -1)
    w1 = _w1(cfg, 8)
    y_want, lin_want = jax_ic.cross_conv1_lin_pallas(
        jnp.asarray(emb2d), jnp.asarray(w1), jcfg, 8, True)
    y, lin = ic.cross_conv1_lin(torch.from_numpy(emb2d), torch.from_numpy(w1), cfg)
    _close(y, y_want)
    _close(lin, lin_want)


def test_field_major_entry_matches_jax():
    jcfg, cfg = _full_rows_cfgs()
    emb3 = _rows_fm(cfg)
    w1 = _w1(cfg, 8)
    y_want, lin_want = jax_ic.cross_conv1_lin_fm_pallas(
        jnp.asarray(emb3), jnp.asarray(w1), jcfg, 8, True)
    y, lin = ic.cross_conv1_lin_fm(torch.from_numpy(emb3), torch.from_numpy(w1), cfg)
    _close(y, y_want)
    _close(lin, lin_want)


@pytest.mark.parametrize("split", [1, 4, 14])
def test_split_field_major_entry_matches_jax(split):
    jcfg, cfg = _full_rows_cfgs()
    emb3 = _rows_fm(cfg)
    es, eb = emb3[:split], emb3[split:]
    w1 = _w1(cfg, 8)
    y_want, lin_want = jax_ic.cross_conv1_lin_fm2_pallas(
        jnp.asarray(es), jnp.asarray(eb), jnp.asarray(w1), jcfg, 8, True)
    y, lin = ic.cross_conv1_lin_fm2(torch.from_numpy(es), torch.from_numpy(eb),
                                    torch.from_numpy(w1), cfg)
    _close(y, y_want)
    _close(lin, lin_want)


@pytest.mark.parametrize("cross_kind", ["field_aware", "hadamard"])
def test_cross_map_and_conv_core_match_jax(cross_kind):
    jcfg, cfg = _cfgs(num_fields=6, vocab_sizes=(9,) * 6, embed_dim=7,
                      cross=cross_kind, conv_channels=(5, 4), conv_kernel=4,
                      conv_pool=2)
    shape = (B, 6, 6, 7) if cross_kind == "field_aware" else (B, 6, 7)
    rng = np.random.default_rng(3)
    emb = rng.normal(size=shape).astype(np.float32)
    layers = [{"w": rng.normal(size=(5, 15, 4)).astype(np.float32),
               "b": rng.normal(size=(5,)).astype(np.float32)},
              {"w": rng.normal(size=(4, 5, 4)).astype(np.float32),
               "b": rng.normal(size=(4,)).astype(np.float32)}]
    t_layers = [{k: torch.from_numpy(v) for k, v in lay.items()} for lay in layers]
    j_layers = [{k: jnp.asarray(v) for k, v in lay.items()} for lay in layers]
    _close(cross.build_cross_map(torch.from_numpy(emb), cfg),
           jax_cross.build_cross_map(jnp.asarray(emb), jcfg))
    _close(cross.interaction_conv_reference(torch.from_numpy(emb), t_layers, cfg),
           jax_cross.interaction_conv_reference(jnp.asarray(emb), j_layers, jcfg))


@pytest.mark.parametrize("k", [2, 3])
def test_interaction_fn_matches_jax(k):
    """Layer 1 in the entry (odd k) or the reference (even k), then the
    conv tail, against the JAX interaction_fn."""
    jcfg, cfg = _cfgs(num_fields=5, vocab_sizes=(32,) * 5, embed_dim=8,
                      conv_channels=(6, 4), conv_kernel=k, conv_pool=2)
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(B, 5, 5, 8)).astype(np.float32)
    layers = [{"w": rng.normal(size=(6, 10, k)).astype(np.float32),
               "b": rng.normal(size=(6,)).astype(np.float32)},
              {"w": rng.normal(size=(4, 6, k)).astype(np.float32),
               "b": rng.normal(size=(4,)).astype(np.float32)}]
    t_layers = [{n: torch.from_numpy(v) for n, v in lay.items()} for lay in layers]
    j_layers = [{n: jnp.asarray(v) for n, v in lay.items()} for lay in layers]
    want = jax_ic.make_interaction_fn(use_pallas=True, bt=8, interpret=True)(
        jnp.asarray(emb), j_layers, jcfg)
    got = ic.make_interaction_fn()(torch.from_numpy(emb), t_layers, cfg)
    assert got.shape == (B, 4 * 2)
    _close(got, want)


def test_pair_indices_match_jax():
    for f in (2, 5, 39):
        for got, want in zip(cross.pair_indices(f), jax_cross.pair_indices(f)):
            np.testing.assert_array_equal(got, want)


def test_entries_reject_what_the_kernel_does_not_take():
    _, cfg = _cfgs(num_fields=5, vocab_sizes=(32,) * 5, embed_dim=8,
                   conv_channels=(4,), conv_kernel=2)
    emb = torch.zeros((B, 5, 5, 8))
    with pytest.raises(ValueError, match="odd k"):
        ic.cross_conv1(emb, torch.zeros((4, 10, 2)), cfg)
    _, movielens_like = _cfgs(num_fields=7, vocab_sizes=(9,) * 7, embed_dim=16,
                              conv_channels=(4,))
    assert not movielens_like.fused_linear
    with pytest.raises(ValueError, match="fused first-order"):
        ic.cross_conv1_lin_fm(torch.zeros((7, B, 112)), torch.zeros((4, 21, 3)),
                              movielens_like)


# ---------------------------------------------------------------------------
# The tensor-core forward's formulation: stacked weights, one GEMM, shift-add
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c1", [32, 64])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_stacked_formulation_matches_jax_fm2(k, c1, dtype):
    """Z = A @ M with A the stacked weights (k*C1, P), then the k row blocks
    of Z shift-added, equals JAX's split field-major entry (f32 1e-5, bf16
    2e-2: both round M to bf16 and sum in f32, in other orders)."""
    jcfg, cfg = _cfgs(num_fields=15, vocab_sizes=(50,) * 15, embed_dim=16,
                      conv_channels=(c1,), conv_kernel=k, compute_dtype=dtype)
    emb3 = _rows_fm(cfg, seed=k)
    w1 = _w1(cfg, c1, seed=c1) * np.float32(np.sqrt(2.0 / (cfg.num_pairs * k)))
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
                else (jnp.float32, torch.float32))
    y_want, _ = jax_ic.cross_conv1_lin_fm2_pallas(
        jnp.asarray(emb3[:4], jdt), jnp.asarray(emb3[4:], jdt), jnp.asarray(w1), jcfg, 8, True)
    rows = torch.from_numpy(emb3).to(tdt).transpose(0, 1)
    f, d = cfg.num_fields, cfg.embed_dim
    m = cross.build_cross_map(rows[..., :cfg.row_width].reshape(B, f, f, d), cfg)
    y = ic.stacked_conv1(m, torch.from_numpy(w1))
    assert y.dtype == tdt and y.shape == (B, c1, d)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("k, c1, fields", [(1, 64, 39), (3, 32, 15), (3, 64, 39),
                                           (5, 48, 10), (7, 64, 6)])
def test_wgmma_weight_layout(k, c1, fields):
    """Each (chunk, k-step, 8-row group, pair half) block of the kernel's
    weight operand is one 8x8 core matrix of the zero-padded stacked
    weights, and the blocks cover it once."""
    p = fields * (fields - 1) // 2
    w1 = torch.from_numpy(np.random.default_rng(k).normal(size=(c1, p, k)).astype(np.float32))
    got = ic.wgmma_weights(w1)
    mt, nq = -(-k * c1 // ic.WG_ROWS), -(-p // ic.WG_PAIRS)
    assert got.shape == (nq, ic.WG_PAIRS // 16, mt * 8, 2, 8, 8) and got.is_contiguous()
    a = torch.zeros((mt * ic.WG_ROWS, nq * ic.WG_PAIRS))
    a[:k * c1, :p] = ic.stacked_weights(w1)
    for t in range(k):
        torch.testing.assert_close(a[t * c1:(t + 1) * c1, :p], w1[:, :, t], rtol=0, atol=0)
    q, s, g, h = 1 % nq, 2, mt * 8 - 1, 1
    torch.testing.assert_close(got[q, s, g, h],
                               a[g * 8:g * 8 + 8, q * 64 + s * 16 + h * 8:q * 64 + s * 16 + h * 8 + 8],
                               rtol=0, atol=0)
    back = got.permute(2, 4, 0, 1, 3, 5).reshape(mt * ic.WG_ROWS, nq * ic.WG_PAIRS)
    torch.testing.assert_close(back, a, rtol=0, atol=0)


def _tail_inputs(c1, c2, b, dtype, seed=0):
    """y (B, C1, 16) in dtype and the tail's layers (f32), as numpy."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(b, c1, 16)).astype(np.float32)
    y = np.array(jnp.asarray(y).astype(dtype).astype(jnp.float32))
    layers = [{"w": rng.normal(size=(c1, 10, 3)).astype(np.float32),
               "b": (0.1 * rng.normal(size=(c1,))).astype(np.float32)},
              {"w": (rng.normal(size=(c2, c1, 3)) / np.sqrt(3 * c1)).astype(np.float32),
               "b": (0.1 * rng.normal(size=(c2,))).astype(np.float32)}]
    return y, layers


@pytest.mark.parametrize("b", [1, 7, 64])
@pytest.mark.parametrize("channels", [(64, 64), (32, 32)], ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_tail_plain_version_matches_jax(dtype, channels, b):
    """The conv tail's plain version (the kernel's CPU branch) against the
    JAX package's `_conv_tail` on the same inputs. f32: only the conv's sum
    order differs. bf16: both round at the same points (the bias adds and
    conv 2's output), so they differ where conv 2's f32 sums round to
    neighbouring bf16 values: within two bf16 ulps (conv 2's rounding and
    its bias add's) of the larger magnitude."""
    c1, c2 = channels
    jcfg, cfg = _cfgs(num_fields=5, vocab_sizes=(32,) * 5, embed_dim=16, conv_channels=channels,
                      conv_kernel=3, conv_pool=2, compute_dtype=dtype)
    y, layers = _tail_inputs(c1, c2, b, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    want = jax_ic._conv_tail(jnp.asarray(y).astype(getattr(jnp, dtype)),
                             [{n: jnp.asarray(v) for n, v in lay.items()} for lay in layers], jcfg)
    t_layers = [{n: torch.from_numpy(v) for n, v in lay.items()} for lay in layers]
    got = ic.conv_tail(torch.from_numpy(y).to(tdt), t_layers, cfg)
    assert got.shape == (b, c2 * 4) and got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        _close(got, want)
        return
    got = got.float().numpy()
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert (np.abs(got - want) <= 2 * ulp).all()


def _tail_model(compute_dtype="bfloat16"):
    # the hybrid route at criteo_kaggle's conv stack: (64, 64), k=3, pool 2, d=16
    return ModelConfig(num_fields=15, vocab_sizes=(8,) * 4 + (600,) * 11, embed_dim=16,
                       conv_channels=(64, 64), tower_hidden=(16,), num_dense=3,
                       compute_dtype=compute_dtype)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "grad_enabled_no_param_grads",
                                  "params_require_grad", "f32_compute"])
def test_forward_routes_the_tail_by_gradient_and_shape(monkeypatch, mode):
    """The model's forward takes `conv_tail` (the kernel's wrapper) when no
    tensor of the tail needs a gradient and the gate takes the config, and
    the eager tail otherwise."""
    from cffm_tpu_torch.models import cffm as model

    cfg = _tail_model("float32" if mode == "f32_compute" else "bfloat16")
    assert ic.tail_kernel_takes(cfg) == (mode != "f32_compute")
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.stack([rng.integers(0, v, size=B) for v in cfg.vocab_sizes], 1)
                           + model.field_offsets(cfg)[None, :]).int()
    dense = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32))
    calls = []
    real = ic.conv_tail
    monkeypatch.setattr(ic, "conv_tail", lambda y, *a: (calls.append(y.shape[0]), real(y, *a))[1])
    fn = ic.make_interaction_fn()
    if mode == "params_require_grad":
        for lay in params["conv"]:
            for t in lay.values():
                t.requires_grad_()
    cm = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad}.get(
        mode, torch.enable_grad)
    with cm():
        got = model.forward(params, ids, dense, cfg, interaction_fn=fn)
    assert calls == ([B] if mode in ("inference_mode", "no_grad",
                                     "grad_enabled_no_param_grads") else [])
    assert got.shape == (B,) and bool(torch.isfinite(got).all())
    assert got.requires_grad == (mode == "params_require_grad")


def test_under_grad_the_eager_tail_gives_jax_gradients(monkeypatch):
    """With gradients taken, the interaction fn at a shape the kernel takes
    (bf16, (32, 32), k=3, pool 2, d=16) keeps the eager tail, and its
    gradients to the rows and every conv leaf match `jax.grad` of the JAX
    interaction fn (bf16: atol 2e-2 on unit-scale inputs, as the backward's
    tests hold bf16; the biases at 3e-2)."""
    import jax

    jcfg, cfg = _cfgs(num_fields=5, vocab_sizes=(32,) * 5, embed_dim=16, conv_channels=(32, 32),
                      conv_kernel=3, conv_pool=2, compute_dtype="bfloat16")
    assert ic.tail_kernel_takes(cfg)
    monkeypatch.setattr(ic, "conv_tail", lambda *a: pytest.fail("the kernel's route under grad"))
    rng = np.random.default_rng(9)
    emb = rng.normal(size=(B, 5, 5, 16)).astype(np.float32)
    layers = [{"w": (rng.normal(size=(32, 10, 3)) / np.sqrt(30)).astype(np.float32),
               "b": (0.1 * rng.normal(size=(32,))).astype(np.float32)},
              {"w": (rng.normal(size=(32, 32, 3)) / np.sqrt(96)).astype(np.float32),
               "b": (0.1 * rng.normal(size=(32,))).astype(np.float32)}]
    gout = rng.normal(size=(B, 32 * 4)).astype(np.float32)

    def jloss(e, lays):
        out = jax_ic.make_interaction_fn(use_pallas=True, bt=8, interpret=True)(
            e.astype(jnp.bfloat16), lays, jcfg)
        return jnp.sum(out.astype(jnp.float32) * gout)

    j_layers = [{n: jnp.asarray(v) for n, v in lay.items()} for lay in layers]
    de_want, dl_want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(emb), j_layers)
    e = torch.from_numpy(emb).requires_grad_()
    t_layers = [{n: torch.from_numpy(v).requires_grad_() for n, v in lay.items()}
                for lay in layers]
    out = ic.make_interaction_fn()(e.to(torch.bfloat16), t_layers, cfg)
    (out.float() * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(de_want), rtol=0, atol=2e-2)
    # each leaf against its largest gradient; a bias's is a sum over B * d
    # bf16 terms, which XLA's CPU reduction rounds more often than torch's
    for t_lay, j_lay in zip(t_layers, dl_want):
        for n, atol in (("w", 2e-2), ("b", 3e-2)):
            want = np.asarray(j_lay[n])
            np.testing.assert_allclose(t_lay[n].grad.numpy() / np.abs(want).max(),
                                       want / np.abs(want).max(), rtol=0, atol=atol)

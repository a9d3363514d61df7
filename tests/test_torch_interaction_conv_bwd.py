"""The port's cross+conv1 backward (plain version, CPU) vs `jax.grad`
through the four JAX entries, and vs torch autograd of the plain forward.

The JAX side runs its Pallas forward and backward kernels in interpret
mode (bt=8). The same numpy inputs and output gradients go to both.
f32: rtol 2e-4, atol 2e-5 (only sum orders differ). bf16: atol 2e-2 on
unit-scale inputs (one bf16 ulp of dM can move a dE product by one ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu.config import ModelConfig as JaxModelConfig
from cffm_tpu.ops import interaction_conv as jax_ic
from cffm_tpu_torch.config import ModelConfig
from cffm_tpu_torch.ops import interaction_conv as ic

B = 16
RTOL, ATOL = 2e-4, 2e-5


def _cfgs(**kw):
    kw.setdefault("compute_dtype", "float32")
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.fixture(autouse=True)
def _no_launches():
    ic.reset_launches()
    yield
    assert ic.cross_conv1_bwd.launches == 0  # CPU tensors: plain backward


@pytest.mark.parametrize("cross_kind", ["field_aware", "hadamard"])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_sliced_backward_matches_jax_grad(cross_kind, k):
    jcfg, cfg = _cfgs(num_fields=5, vocab_sizes=(32,) * 5, embed_dim=8,
                      cross=cross_kind, conv_channels=(12,), conv_kernel=k)
    shape = (B, 5, 5, 8) if cross_kind == "field_aware" else (B, 5, 8)
    emb, w1, gy = _draw(k, shape, (12, 10, k), (B, 12, 8))

    def loss(e, w):
        return jnp.sum(jax_ic.cross_conv1_pallas(e, w, jcfg, 8, True) * gy)

    de_want, dw_want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(w1))
    de, dw = ic.cross_conv1_bwd_reference(torch.from_numpy(emb), torch.from_numpy(w1),
                                          torch.from_numpy(gy), cfg)
    _close(de, de_want)
    _close(dw, dw_want, atol=1e-4)
    # the autograd Function hands back the same gradients
    e = torch.from_numpy(emb).requires_grad_()
    w = torch.from_numpy(w1).requires_grad_()
    ic.cross_conv1(e, w, cfg).backward(torch.from_numpy(gy))
    _close(e.grad, de_want)
    _close(w.grad, dw_want, atol=1e-4)


def _full_cfgs(**kw):
    # F=15, d=16: row_width 240 -> table_width 256 with the fused column
    jcfg, cfg = _cfgs(num_fields=15, vocab_sizes=(50,) * 15, embed_dim=16,
                      conv_channels=(8,), **kw)
    assert cfg.fused_linear and cfg.table_width == 256
    return jcfg, cfg


def _full_inputs(cfg, k, seed=0):
    return _draw(seed, (cfg.num_fields, B, cfg.table_width), (8, cfg.num_pairs, k),
                 (B, 8, cfg.embed_dim), (B,))


def _torch_grads(entry, cfg, e3, w1, gy, glin, dtype=torch.float32, split=4):
    """Row grads (F, B, W) and dW through one port entry's autograd."""
    w = torch.from_numpy(w1).requires_grad_()
    e = torch.from_numpy(e3).to(dtype)
    if entry == "fm2":
        parts = [e[:split].clone().requires_grad_(), e[split:].clone().requires_grad_()]
        y, lin = ic.cross_conv1_lin_fm2(*parts, w, cfg)
    elif entry == "fm":
        parts = [e.clone().requires_grad_()]
        y, lin = ic.cross_conv1_lin_fm(parts[0], w, cfg)
    else:
        parts = [e.transpose(0, 1).reshape(B, -1).clone().requires_grad_()]
        y, lin = ic.cross_conv1_lin(parts[0], w, cfg)
    ((y * torch.from_numpy(gy).to(dtype)).float().sum()
     + (lin * torch.from_numpy(glin)).sum()).backward()
    assert w.grad is not None and all(p.grad is not None for p in parts)
    if entry == "flat":
        return parts[0].grad.reshape(B, cfg.num_fields, -1).transpose(0, 1), w.grad
    return torch.cat([p.grad for p in parts]), w.grad


def _jax_grads(entry, jcfg, e3, w1, gy, glin, dtype=jnp.float32, split=4):
    e = jnp.asarray(e3).astype(dtype)

    def loss(parts, w):
        if entry == "fm2":
            y, lin = jax_ic.cross_conv1_lin_fm2_pallas(parts[0], parts[1], w, jcfg, 8, True)
        elif entry == "fm":
            y, lin = jax_ic.cross_conv1_lin_fm_pallas(parts[0], w, jcfg, 8, True)
        else:
            y, lin = jax_ic.cross_conv1_lin_pallas(parts[0], w, jcfg, 8, True)
        return (jnp.sum((y * jnp.asarray(gy).astype(dtype)).astype(jnp.float32))
                + jnp.sum(lin * glin))

    if entry == "fm2":
        parts = (e[:split], e[split:])
    elif entry == "fm":
        parts = (e,)
    else:
        parts = (jnp.swapaxes(e, 0, 1).reshape(B, -1),)
    dparts, dw = jax.grad(loss, argnums=(0, 1))(parts, jnp.asarray(w1))
    if entry == "flat":
        return jnp.swapaxes(dparts[0].reshape(B, jcfg.num_fields, -1), 0, 1), dw
    return jnp.concatenate(dparts), dw


@pytest.mark.parametrize("entry", ["fm2", "fm", "flat"])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_full_rows_backward_matches_jax_grad(entry, k):
    jcfg, cfg = _full_cfgs(conv_kernel=k)
    e3, w1, gy, glin = _full_inputs(cfg, k, seed=k)
    de_want, dw_want = _jax_grads(entry, jcfg, e3, w1, gy, glin)
    de, dw = _torch_grads(entry, cfg, e3, w1, gy, glin)
    _close(de, de_want)
    _close(dw, dw_want, atol=1e-4)


def test_fm2_backward_bf16_matches_jax_grad():
    """bf16 rows: gY, dM and the dE products are rounded where JAX rounds."""
    jcfg, cfg = _full_cfgs(compute_dtype="bfloat16")
    e3, w1, gy, glin = _full_inputs(cfg, 3, seed=7)
    de_want, dw_want = _jax_grads("fm2", jcfg, e3, w1, gy, glin, dtype=jnp.bfloat16)
    de, dw = _torch_grads("fm2", cfg, e3, w1, gy, glin, dtype=torch.bfloat16)
    assert de.dtype == torch.bfloat16
    _close(de, de_want, atol=2e-2, rtol=2e-2)
    # dW sums exact bf16 products in f32: only the order differs
    _close(dw, dw_want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("cross_kind", ["field_aware", "hadamard"])
def test_plain_backward_matches_torch_autograd(cross_kind):
    _, cfg = _cfgs(num_fields=6, vocab_sizes=(9,) * 6, embed_dim=8, cross=cross_kind,
                   conv_channels=(5,), conv_kernel=3)
    shape = (B, 6, 6, 8) if cross_kind == "field_aware" else (B, 6, 8)
    emb, w1, gy = (torch.from_numpy(a) for a in _draw(11, shape, (5, 15, 3), (B, 5, 8)))
    e, w = emb.clone().requires_grad_(), w1.clone().requires_grad_()
    de_want, dw_want = torch.autograd.grad(ic.cross_conv1_reference(e, w, cfg), (e, w), gy)
    de, dw = ic.cross_conv1_bwd_reference(emb, w1, gy, cfg)
    torch.testing.assert_close(de, de_want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw, dw_want, rtol=1e-5, atol=1e-5)


def test_pad_lanes_and_diagonal_exact():
    _, cfg = _full_cfgs()
    e3, w1, gy, glin = _full_inputs(cfg, 3, seed=5)
    rows = torch.from_numpy(e3).transpose(0, 1)
    drows, _ = ic._rows_bwd_reference(rows, torch.from_numpy(w1), torch.from_numpy(gy),
                                      torch.from_numpy(glin), cfg)
    d, rw = cfg.embed_dim, cfg.row_width
    for f in range(cfg.num_fields):
        assert (drows[:, f, f * d:(f + 1) * d] == 0).all()
    assert (drows[..., rw + 1:] == 0).all()
    assert torch.equal(drows[..., rw], torch.from_numpy(glin)[:, None].expand(-1, 15))
    # every off-diagonal block carries gradient
    assert (drows[..., :rw].abs().reshape(B, 15, 15, d).sum(dim=(0, 3)) > 0).sum() == 15 * 14


def test_gradients_reach_rows_and_w1_through_make_interaction_fn():
    """The model-facing fns: each full-rows attr and the sliced fn give
    gradients to their rows and to the layer-1 weight."""
    _, cfg = _full_cfgs()
    e3, w1, _, _ = _full_inputs(cfg, 3, seed=6)
    fn = ic.make_interaction_fn()
    conv = [{"w": torch.from_numpy(w1).requires_grad_(), "b": torch.zeros(8)}]
    rows = torch.from_numpy(e3).requires_grad_()
    feats, lin = fn.full_rows_fm2(rows[:3], rows[3:], conv, cfg)
    (feats.sum() + lin.sum()).backward()
    assert rows.grad is not None and rows.grad.abs().sum() > 0
    assert conv[0]["w"].grad is not None and conv[0]["w"].grad.abs().sum() > 0


@pytest.mark.parametrize("length", [16, 15])
def test_max_pool_valid_matches_max_pool1d(length):
    """Values and gradients equal max_pool1d's, with and without autograd,
    ties (the zeros after a ReLU) and a ragged tail included."""
    from cffm_tpu_torch.ops.cross import max_pool_valid

    x = torch.relu(torch.from_numpy(_draw(12, (4, 3, length))[0]))
    g = torch.from_numpy(_draw(13, (4, 3, length // 2))[0])
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = max_pool_valid(a, 2), torch.nn.functional.max_pool1d(b, 2, 2)
    assert torch.equal(ya, yb)
    ya.backward(g)
    yb.backward(g)
    assert torch.equal(a.grad, b.grad)
    with torch.no_grad():
        assert torch.equal(max_pool_valid(x, 2), yb)

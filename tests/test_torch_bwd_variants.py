"""The port's backward variants (`ops.bwd_variants`, plain versions on the
CPU) against the TPU micro-bench's kernels `bwd_v1` and `bwd_v2`
(scripts/bench_bwd_variants.py) and the shipped `_bwd_pallas(fm=True,
glin=...)`, all three in Pallas interpret mode (bt=8), at F=15, d=16,
C1=8, k=3 (and k=9 for the variants), B=16.

The script module is imported from scripts/ and handed a `pl` whose
pallas_call runs in interpret mode (the script passes no interpret flag and
TPU compiler params); no JAX file changes. The same numpy inputs go to
both sides. Tolerances: f32 rtol 2e-4, atol 2e-5 for dE and atol 1e-4 for
dW (only f32 sum orders differ); bf16 rtol=atol 2e-2 for dE (one bf16 ulp
of dM, summed in another order, moves a dE product by one ulp) and
rtol 1e-4, atol 1e-3 for dW (exact bf16 products summed in f32 in another
order).
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cffm_tpu.config import ModelConfig as JaxModelConfig
from cffm_tpu.ops import interaction_conv as jax_ic
from cffm_tpu_torch.config import ModelConfig
from cffm_tpu_torch.ops import bwd_variants as bv
from cffm_tpu_torch.ops import interaction_conv as ic

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "scripts"))
import bench_bwd_variants as jbv  # noqa: E402

B, BT = 16, 8
TOL = {"float32": dict(de=(2e-4, 2e-5), dw=(2e-4, 1e-4)),
       "bfloat16": dict(de=(2e-2, 2e-2), dw=(1e-4, 1e-3))}


class _InterpretPl:
    """The script's `pl` with every pallas_call in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(kernel, **kw):
        kw.pop("compiler_params", None)
        return pl.pallas_call(kernel, interpret=True, **kw)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jbv, "pl", _InterpretPl())
    bv.reset_launches()
    ic.reset_launches()
    yield
    # CPU tensors: the plain versions, no kernel launch
    assert all(fn.launches == 0 for fn in bv.VARIANTS.values())
    assert ic.cross_conv1_bwd.launches == 0


def _cfgs(dtype, k=3):
    kw = dict(num_fields=15, vocab_sizes=(50,) * 15, embed_dim=16, conv_channels=(8,),
              conv_kernel=k, compute_dtype=dtype)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    c1, d = cfg.conv_channels[0], cfg.embed_dim
    return (rng.normal(size=(cfg.num_fields, B, cfg.table_width)).astype(np.float32),
            (0.3 * rng.normal(size=(c1, cfg.num_pairs, cfg.conv_kernel))).astype(np.float32),
            rng.normal(size=(B, c1 * d)).astype(np.float32),
            rng.normal(size=(B,)).astype(np.float32))


def _jax_all(jcfg, e3, w1, g, glin, dtype):
    """{v0, v1, v2: (dE, dW)} from the JAX side, in interpret mode."""
    jdt = jnp.dtype(dtype)
    p_pad = jax_ic._round_up(jcfg.num_pairs, 8)
    wrs = jax_ic._prep_w_bwd(jnp.asarray(w1), jcfg, p_pad, jdt)
    e, gg, gl = jnp.asarray(e3).astype(jdt), jnp.asarray(g).astype(jdt), jnp.asarray(glin)
    return wrs, {
        "v0": jax_ic._bwd_pallas(e, wrs, gg, jcfg, BT, True, glin=gl, fm=True),
        "v1": jbv.bwd_v1(e, jnp.asarray(wrs.T), gg, gl, jcfg, BT),
        "v2": jbv.bwd_v2(e, wrs, gg, gl, jcfg, BT),
    }


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("k", [3, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["v0", "v1", "v2"])
def test_variant_matches_jax(variant, dtype, k):
    jcfg, cfg = _cfgs(dtype, k)
    e3, w1, g, glin = _inputs(cfg, seed=3)
    wrs_j, want = _jax_all(jcfg, e3, w1, g, glin, dtype)
    tdt = getattr(torch, dtype)
    wrs = bv.prep_w_bwd(torch.from_numpy(w1), cfg, bv.round_up(cfg.num_pairs, 8), tdt)
    np.testing.assert_array_equal(wrs.float().numpy(), _np(wrs_j))
    w = wrs.t().contiguous() if variant == "v1" else wrs
    de, dw = bv.VARIANTS[variant](torch.from_numpy(e3).to(tdt), w,
                                  torch.from_numpy(g).to(tdt), torch.from_numpy(glin), cfg)
    de_want, dw_want = want[variant]
    assert de.dtype == tdt and tuple(de.shape) == de_want.shape
    assert dw.dtype == torch.float32 and tuple(dw.shape) == dw_want.shape
    rtol, atol = TOL[dtype]["de"]
    np.testing.assert_allclose(de.float().numpy(), _np(de_want), rtol=rtol, atol=atol)
    rtol, atol = TOL[dtype]["dw"]
    np.testing.assert_allclose(dw.numpy(), _np(dw_want), rtol=rtol, atol=atol)
    # dW's pad rows (P..P_pad) are exact zeros on both sides
    assert (dw[:, cfg.num_pairs:] == 0).all()
    assert (_np(dw_want)[:, cfg.num_pairs:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v2_is_the_shipped_kernel(dtype):
    """The TPU's v2 equals `_bwd_pallas` fm+lin bit for bit: the port's v2
    is therefore kernel 2's fm+lin launch (PERF.md row 8b)."""
    jcfg, cfg = _cfgs(dtype)
    e3, w1, g, glin = _inputs(cfg, seed=4)
    _, out = _jax_all(jcfg, e3, w1, g, glin, dtype)
    for a, b in zip(out["v2"], out["v0"]):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_prep_w_bwd_round_trip():
    _, cfg = _cfgs("float32")
    w1 = torch.from_numpy(_inputs(cfg, seed=5)[1])
    wrs = bv.prep_w_bwd(w1, cfg, bv.round_up(cfg.num_pairs, 8), torch.float32)
    assert tuple(wrs.shape) == (3 * 8, 112)
    assert (wrs[:, cfg.num_pairs:] == 0).all()
    torch.testing.assert_close(bv.w1_from_wrs(wrs, cfg), w1, rtol=0, atol=0)


def test_variants_reject_bad_inputs():
    _, cfg = _cfgs("float32")
    e3, w1, g, glin = (torch.from_numpy(a) for a in _inputs(cfg, seed=6))
    wrs = bv.prep_w_bwd(w1, cfg, 112, torch.float32)
    with pytest.raises(ValueError, match="weights"):
        bv.bwd_v1(e3, wrs, g, glin, cfg)           # v1 wants wrs.T
    with pytest.raises(ValueError, match="emb3"):
        bv.bwd_v0(e3[:, :, :200], wrs, g, glin, cfg)
    with pytest.raises(ValueError, match="g must be"):
        bv.bwd_v2(e3, wrs, g[:, :64], glin, cfg)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bv.bwd_v0(e3.to("meta"), wrs, g, glin, cfg)


# ---------------------------------------------------------------------------
# Kernel 8a's tensor-core formulation (csrc/cross_conv1_bwd_v1.cu) on the
# CPU: bwd_v1_tiles spells out its tap-window tiles, weight chunks, per-x
# products, grid and partial order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("k, c1", [(3, 64), (5, 32), (3, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v1_tiles_formulation_matches_jax(dtype, k, c1, sms):
    """The per-position products over slices gp[x:x+k] of each tile's tap
    window, dW kept per (block, warpgroup) and summed in order, v1's tap
    order, a narrower layer brought to 32 channels by v1_pad_channels:
    against the TPU script's bwd_v1 (interpret, bt=8) at B=40, so that the
    last 16-example tile is ragged."""
    kw = dict(num_fields=15, vocab_sizes=(50,) * 15, embed_dim=16, conv_channels=(c1,),
              conv_kernel=k, compute_dtype=dtype)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(k + c1)
    b = 40
    e3 = rng.normal(size=(15, b, cfg.table_width)).astype(np.float32)
    w1 = (0.3 * rng.normal(size=(c1, cfg.num_pairs, k))).astype(np.float32)
    g = rng.normal(size=(b, c1 * 16)).astype(np.float32)
    glin = rng.normal(size=(b,)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    p_pad = jax_ic._round_up(jcfg.num_pairs, 8)
    wrs = jax_ic._prep_w_bwd(jnp.asarray(w1), jcfg, p_pad, jdt)
    de_want, dw_want = jbv.bwd_v1(jnp.asarray(e3).astype(jdt), jnp.asarray(wrs.T),
                                  jnp.asarray(g).astype(jdt), jnp.asarray(glin), jcfg, BT)
    tdt = getattr(torch, dtype)
    wr = bv.prep_w_bwd(torch.from_numpy(w1), cfg, p_pad, tdt).t().contiguous()
    c1k = bv.v1_channels(c1)
    assert c1k == max(c1, 32)
    wr_k, g_k = bv.v1_pad_channels(wr, torch.from_numpy(g).to(tdt), k, 16, c1k)
    de, dw = bv.bwd_v1_tiles(torch.from_numpy(e3).to(tdt), wr_k, g_k, torch.from_numpy(glin),
                             cfg, sms)
    dw = dw[..., :c1]
    assert de.dtype == tdt and dw.dtype == torch.float32
    rtol, atol = TOL[dtype]["de"]
    np.testing.assert_allclose(de.float().numpy(), _np(de_want), rtol=rtol, atol=atol)
    rtol, atol = TOL[dtype]["dw"]
    np.testing.assert_allclose(dw.numpy(), _np(dw_want), rtol=rtol, atol=atol)
    assert (dw[:, cfg.num_pairs:] == 0).all()


def test_v1_window_and_weight_chunks_layouts():
    """Element (r = q*C1 + c, example e) of a tile's window sits in core
    matrix (r/8, e/8) at (r/8 * 2 + e/8) * 64 elements and holds g[b0 + e,
    c, q - k//2] (zero in the halo rows and past B); store_window's items
    write each real row's 16 examples exactly once. Weight (pair, r) of
    chunk pair/64 sits in core matrix (pair%64/8, r/8)."""
    b, c1, d, k = 21, 32, 16, 3
    g = torch.arange(b * c1 * d, dtype=torch.float32).reshape(b, c1 * d) + 1
    q = d + k - 1
    for b0, qq, c, e in [(0, 0, 0, 0), (0, 1, 3, 5), (16, 9, 7, 4), (16, 17, 2, 9),
                         (0, 16, 5, 15), (16, 3, 31, 4), (16, 3, 31, 5)]:
        win = bv.v1_window(g, k, d, b0)
        assert win.numel() == q * c1 * 16
        x, ex = qq - k // 2, b0 + e
        want = g[ex].reshape(c1, d)[c, x] if 0 <= x < d and ex < b else 0
        assert win[bv.v1_window_offset(qq * c1 + c, e)] == want
    c, e2 = (t.reshape(-1) for t in bv.v1_window_items(c1))
    slots = torch.stack([bv.v1_window_offset((x + k // 2) * c1 + c, 2 * e2 + e)
                         for x in range(d) for e in range(2)]).reshape(-1)
    real = bv.v1_window_offset(torch.arange(k // 2 * c1, (k // 2 + d) * c1)[:, None],
                               torch.arange(16)[None, :]).reshape(-1)
    assert torch.equal(slots.sort().values, real.sort().values)
    wr = torch.arange(112 * 24, dtype=torch.float32).reshape(112, 24) + 1
    chunks = bv.v1_weight_chunks(wr)
    assert tuple(chunks.shape) == (2, 8, 3, 8, 8)
    flat = chunks.reshape(2, -1)
    for p, r in [(0, 0), (63, 23), (64, 5), (100, 17), (111, 8)]:
        pl_ = p % 64
        assert flat[p // 64, ((pl_ // 8) * 3 + r // 8) * 64 + (pl_ % 8) * 8 + r % 8] == wr[p, r]
    assert (flat[1, :].reshape(8, 3, 8, 8).permute(0, 2, 1, 3).reshape(64, 24)[48:] == 0).all()


@pytest.mark.parametrize("batch", [1, 16, 17, 4096, 65536])
@pytest.mark.parametrize("sms", [1, 132])
def test_v1_grid_gives_every_tile_one_warpgroup(batch, sms):
    blocks, tpb, nt = bv.v1_grid(batch, sms)
    assert nt == -(-batch // bv.V1_TILE) and 1 <= blocks <= sms
    owners = [(t // tpb, (t - t // tpb * tpb) % 2) for t in range(nt)]
    assert all(blk < blocks for blk, _ in owners)
    assert blocks == -(-nt // tpb)  # no block without a tile

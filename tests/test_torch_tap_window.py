"""The tensor-core backward's formulation and weight layout (CPU).

The backward kernel on `wgmma` (csrc/cross_conv1_bwd.cu) computes both of
its products as GEMMs over one tap window of g, Gwin[t*C1 + c, (b, x)] =
g[b, c, x - t + k//2]: dM^T = Gwin^T A and dW_stack = Gwin M^T, with A
the stacked weights. `interaction_conv.tap_window_bwd` is that
formulation in plain torch; here it is held against JAX's `_bwd_pallas`
(fm entry with the fused column, Pallas interpret mode, bt=8) on the same
numpy inputs, dE assembled from dM as the kernel assembles it.
Tolerances: f32 rtol 1e-5 with atol 1e-5 of the largest value (sum
orders only); bf16 dE within one bf16 ulp of the product plus two ulps
of the product taken from |E|, |W| and |g| (dM is summed in f32 in
another order before its rounding to bf16), bf16 dW rtol 1e-4 with atol
1e-4 of max|dW| (exact bf16 products summed in f32 in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu.config import ModelConfig as JaxModelConfig
from cffm_tpu.ops import interaction_conv as jax_ic
from cffm_tpu_torch.config import ModelConfig
from cffm_tpu_torch.ops import interaction_conv as ic
from cffm_tpu_torch.ops.cross import build_cross_map, pair_indices

B, BT = 16, 8


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def _de_from_dm(dm, emb):
    """Field-aware dE (B, F, F, d) from dM (B, P, d), in emb's dtype."""
    pi, pj = (torch.from_numpy(a) for a in pair_indices(emb.shape[1]))
    de = torch.zeros(emb.shape, dtype=emb.dtype)
    de[:, pi, pj] = dm * emb[:, pj, pi]
    de[:, pj, pi] = dm * emb[:, pi, pj]
    return de


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c1", [32, 64])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_tap_window_formulation_matches_jax_bwd_pallas(k, c1, dtype):
    kw = dict(num_fields=15, vocab_sizes=(50,) * 15, embed_dim=16, conv_channels=(c1,),
              conv_kernel=k, compute_dtype=dtype)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    f, d, rw, p = cfg.num_fields, cfg.embed_dim, cfg.row_width, cfg.num_pairs
    rng = np.random.default_rng(100 * k + c1)
    e3 = rng.normal(size=(f, B, cfg.table_width)).astype(np.float32)
    w1 = (rng.normal(size=(c1, p, k)) * np.sqrt(2.0 / (p * k))).astype(np.float32)
    gy = rng.normal(size=(B, c1, d)).astype(np.float32)
    glin = rng.normal(size=(B,)).astype(np.float32)

    jdt = jnp.dtype(dtype)
    p_pad = jax_ic._round_up(p, 8)
    wrs = jax_ic._prep_w_bwd(jnp.asarray(w1), jcfg, p_pad, jdt)
    de3_j, dwp_j = jax_ic._bwd_pallas(jnp.asarray(e3).astype(jdt), wrs,
                                      jnp.asarray(gy).reshape(B, c1 * d).astype(jdt), jcfg,
                                      BT, True, glin=jnp.asarray(glin), fm=True)
    de_want = torch.from_numpy(np.array(de3_j.astype(jnp.float32))).transpose(0, 1)
    de_want = de_want[..., :rw].reshape(B, f, f, d)
    dw_want = torch.from_numpy(np.array(dwp_j)[:, :p, :]).permute(2, 1, 0)

    tdt = getattr(torch, dtype)
    rows = torch.from_numpy(e3).to(tdt).transpose(0, 1)
    emb = rows[..., :rw].reshape(B, f, f, d)
    m = build_cross_map(emb, cfg)
    dm, dw = ic.tap_window_bwd(m, torch.from_numpy(w1), torch.from_numpy(gy))
    assert dm.dtype == tdt and dm.shape == (B, p, d)
    assert dw.dtype == torch.float32 and dw.shape == (c1, p, k)
    de = _de_from_dm(dm, emb)

    if dtype == "float32":
        for got, want in ((de, de_want), (dw, dw_want)):
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * want.abs().max().item())
        return
    dm_abs, _ = ic.tap_window_bwd(m, torch.from_numpy(np.abs(w1)),
                                  torch.from_numpy(np.abs(gy)))
    de_abs = _de_from_dm(dm_abs, emb.abs()).float()
    limit = _bf16_ulp(de_want) + 2 * _bf16_ulp(de_abs)
    assert ((de.float() - de_want).abs() <= limit).all()
    torch.testing.assert_close(dw, dw_want, rtol=1e-4, atol=1e-4 * dw_want.abs().max().item())


def test_tap_window_layout():
    """Gwin[t*C1 + c, b*d + x] = g[b, c, x - t + k//2], zero outside [0, d)."""
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 5, 16)).astype(np.float32))
    k = 5
    gw = ic.tap_window(g, k)
    assert gw.shape == (k * 5, 3 * 16)
    for t in range(k):
        for c in (0, 4):
            for b in range(3):
                for x in range(16):
                    src = x - t + k // 2
                    want = g[b, c, src] if 0 <= src < 16 else 0.0
                    assert gw[t * 5 + c, b * 16 + x] == want


@pytest.mark.parametrize("k, c1, fields, pc", [(1, 64, 39, 128), (3, 32, 15, 128),
                                               (3, 64, 39, 128), (5, 48, 10, 64),
                                               (7, 64, 6, 64)])
def test_bwd_wgmma_weight_layout(k, c1, fields, pc):
    """Each (chunk, 8-pair group, 8-row group) block of the backward kernel's
    weight operand is one 8x8 core matrix of the zero-padded A^T, pairs by
    rows, and the blocks cover it once."""
    p = fields * (fields - 1) // 2
    w1 = torch.from_numpy(np.random.default_rng(k).normal(size=(c1, p, k)).astype(np.float32))
    got = ic.bwd_wgmma_weights(w1, pc)
    mt, nq = -(-k * c1 // ic.WG_ROWS), -(-p // pc)
    assert got.shape == (nq, pc // 8, mt * 8, 8, 8) and got.is_contiguous()
    at = torch.zeros((nq * pc, mt * ic.WG_ROWS))
    at[:p, :k * c1] = ic.stacked_weights(w1).t()
    for t in range(k):
        torch.testing.assert_close(at[:p, t * c1:(t + 1) * c1], w1[:, :, t].t(), rtol=0, atol=0)
    q, pg, rg = nq - 1, pc // 8 - 1, mt * 8 - 1
    torch.testing.assert_close(got[q, pg, rg],
                               at[q * pc + pg * 8:q * pc + pg * 8 + 8, rg * 8:rg * 8 + 8],
                               rtol=0, atol=0)
    back = got.permute(0, 1, 3, 2, 4).reshape(nq * pc, mt * ic.WG_ROWS)
    torch.testing.assert_close(back, at, rtol=0, atol=0)

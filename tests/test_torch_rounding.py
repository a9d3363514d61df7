"""The port's stochastic bf16 rounding vs `cffm_tpu.ops.rounding`.

Given the same dither bits the port's formula equals the JAX formula bit
for bit; the rounding is unbiased over many draws; NaN and inf pass
through undithered.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cffm_tpu.ops import rounding as jax_rounding
from cffm_tpu_torch.ops import rounding


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


def test_same_dither_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 128)) * 10.0 ** rng.integers(-6, 6, size=(64, 128))
         ).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1e-40, -1e-40]  # zeros and subnormals
    key = jax.random.key(3)
    want = jax_rounding.stochastic_round_bf16(jnp.asarray(x), key)
    # the bits JAX draws inside stochastic_round_bf16, handed to the port
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32)).astype(np.int64)
    got = rounding.stochastic_round_bf16(torch.from_numpy(x), torch.from_numpy(bits))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  _bits(np.asarray(want)))


def test_nan_and_inf_pass_through():
    x = torch.tensor([float("nan"), float("inf"), -float("inf"), 1.0, -2.5])
    got = rounding.stochastic_round_bf16(x, torch.full((5,), 0xFFFF))
    assert torch.isnan(got[0]) and got[1] == float("inf") and got[2] == -float("inf")
    # a full dither on an exact bf16 value stays in its ulp: never rounds up
    assert got[3] == 1.0 and got[4] == -2.5


def test_unbiased_over_many_draws():
    """Mean of 20000 stochastic roundings is within 4 standard errors of
    the f32 value (one draw errs by at most one ulp)."""
    x = torch.tensor([1.0 + 2.0**-9, 3.14159, -0.0123456, 1e-3 + 3e-7], dtype=torch.float32)
    n = 20000
    gen = torch.Generator().manual_seed(1)
    xs = x.repeat(n, 1)
    r = rounding.stochastic_round_bf16(xs, rounding.random_dither(xs.shape, gen, "cpu"))
    ulp = torch.ldexp(torch.ones(4), torch.frexp(x)[1] - 8)
    mean = r.float().mean(dim=0)
    assert ((mean - x).abs() <= 4 * ulp / np.sqrt(n)).all(), (mean - x) / ulp
    # and it does round both ways (nearest would give one value only)
    assert all(len(torch.unique(r[:, i])) == 2 for i in range(4))


@pytest.mark.parametrize("dtype,rounding_mode", [("float32", "nearest"),
                                                 ("bfloat16", "nearest")])
def test_round_table_delta_matches_jax(dtype, rounding_mode):
    rng = np.random.default_rng(2)
    rows = rng.normal(size=(16, 128)).astype(np.float32)
    delta = (rng.normal(size=(16, 128)) * 1e-3).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = jax_rounding.round_table_delta(jnp.asarray(rows).astype(jdt), jnp.asarray(delta),
                                          jdt, rounding_mode, None)
    tdt = getattr(torch, dtype)
    got = rounding.round_table_delta(torch.from_numpy(rows).to(tdt), torch.from_numpy(delta),
                                     tdt, rounding_mode, None)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_round_table_delta_needs_a_generator_for_stochastic():
    with pytest.raises(ValueError, match="generator"):
        rounding.round_table_delta(torch.zeros(2, dtype=torch.bfloat16), torch.zeros(2),
                                   torch.bfloat16, "stochastic", None)

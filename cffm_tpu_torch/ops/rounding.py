"""Stochastic rounding f32 -> bf16 for low-precision embedding tables.

The port's counterpart of `cffm_tpu/ops/rounding.py`. bf16 is the top 16
bits of the f32 pattern, and IEEE bit patterns are monotone within a
sign, so adding a uniform 16-bit integer to the f32 bits and truncating
the low 16 rounds up with probability equal to the dropped fraction:
the update's expectation is exact, across mantissa and binade
boundaries. NaN and inf pass through undithered.

The dither is an argument of `stochastic_round_bf16`, so a test can
hand the JAX formula and this one the same bits. `round_table_delta`
draws it with `random_dither`, on the rows' device: a CPU key seeds a
generator on the card with one draw (`draw_seed`), so no dither is drawn
on the host or copied over. The streamed-update kernels draw their own
from Philox (`ops/csrc/streamed_update.cu`), seeded by `draw_seed` too,
and count each launch that dithers as one draw on the card.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def stochastic_round_bf16(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Round f32 `x` to bf16 stochastically. bits: integers of x's shape
    whose low 16 bits are the dither (higher bits are ignored)."""
    if x.dtype != torch.float32:
        raise TypeError(f"stochastic_round_bf16 takes float32, got {x.dtype}")
    # uint32 arithmetic in int64: torch has no unsigned 32-bit adds
    pattern = x.view(torch.int32).to(torch.int64) & _MASK32
    dither = bits.to(torch.int64) & 0xFFFF
    dither = torch.where(torch.isfinite(x), dither, torch.zeros_like(dither))
    rounded = (pattern + dither) & 0xFFFF0000
    # back to the signed int32 pattern; the low 16 bits are zero, so the
    # f32 value is exactly a bf16 value and the cast below is exact
    signed = torch.where(rounded >= 1 << 31, rounded - (1 << 32), rounded)
    return signed.to(torch.int32).view(torch.float32).to(torch.bfloat16)


# dithers drawn, by the type of the device that drew them (plain counts,
# as the kernel wrappers count their launches)
DRAWS = {"cpu": 0, "cuda": 0}


def draw_seed(generator: torch.Generator) -> int:
    """One seed from generator: what a generator on another device, or a
    kernel's Philox, starts from."""
    return int(torch.randint(0, 2**31 - 1, (), generator=generator))


def random_dither(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform 16-bit dither, int32, on device. For a CUDA device and a
    generator elsewhere (the step's CPU key), a generator on the device,
    seeded with one `draw_seed` of the key, draws it there. Otherwise
    generator draws it on its own device (a CPU tensor's bits are those of
    the CPU generator's draw)."""
    device = torch.device(device)
    if device.type == "cuda" and generator.device.type != "cuda":
        generator = torch.Generator(device=device).manual_seed(draw_seed(generator))
    DRAWS[generator.device.type] = DRAWS.get(generator.device.type, 0) + 1
    return torch.randint(0, 1 << 16, tuple(shape), generator=generator,
                         device=generator.device, dtype=torch.int32).to(device)


def round_table_delta(rows: torch.Tensor, delta: torch.Tensor, dtype,
                      rounding: str, generator: torch.Generator | None
                      ) -> torch.Tensor:
    """rows + delta in the table's storage dtype.

    rows: current row values (any float dtype, promoted to f32); delta:
    f32 update. An f32 table takes the plain add; a bf16 table rounds
    to nearest or stochastically (with a dither from generator, drawn on
    the rows' device: `random_dither`)."""
    new = rows.float() + delta
    if dtype != torch.bfloat16:
        return new.to(dtype)
    if rounding == "stochastic":
        if generator is None:
            raise ValueError("stochastic table rounding needs a generator")
        return stochastic_round_bf16(new, random_dither(new.shape, generator,
                                                        new.device))
    if rounding == "nearest":
        return new.to(torch.bfloat16)
    raise ValueError(f"unknown table_rounding {rounding!r}")

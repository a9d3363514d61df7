"""Weights from the seed, on the device, in the layout the port takes.

The table is drawn N(0, 0.01) in f32 in blocks of BLOCK_ROWS rows, each
block from its own generator, and cast to the table's storage dtype; so
any block can be drawn again on its own (the reference and the checks
do). Conv and tower weights are He-scaled normals (Glorot for the logit
layer), biases zero: the port's initialiser's laws, drawn here.
"""

from __future__ import annotations

import math

import torch

BLOCK_ROWS = 1 << 17
_MASK64 = (1 << 64) - 1


def mix(*words: int) -> int:
    """splitmix64 over the words: a 63-bit generator seed."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


def dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def table_block(config: dict, seed: int, block: int, rows: int, device) -> torch.Tensor:
    """Block `block` of the table as drawn, f32: rows [block * BLOCK_ROWS,
    min(rows, (block + 1) * BLOCK_ROWS)) of a table of `rows` rows."""
    from benchmark.work import table_width

    n = min(BLOCK_ROWS, rows - block * BLOCK_ROWS)
    gen = torch.Generator(device=device).manual_seed(mix(seed, 1, block))
    return 0.01 * torch.randn((n, table_width(config)), generator=gen, device=device)


def blocks(rows: int) -> range:
    return range((rows + BLOCK_ROWS - 1) // BLOCK_ROWS)


def make_table(config: dict, seed: int, device) -> torch.Tensor:
    from benchmark.work import table_width

    rows = sum(config["vocab_sizes"])
    table = torch.empty((rows, table_width(config)), dtype=dtype(config["table_dtype"]),
                        device=device)
    for b in blocks(rows):
        part = table_block(config, seed, b, rows, device)
        table[b * BLOCK_ROWS: b * BLOCK_ROWS + part.shape[0]] = part
        del part
    return table


def make_dense(config: dict, seed: int, device) -> dict:
    """{"conv": [{"w", "b"}], "tower": [{"w", "b"}], "bias"}, f32."""
    gen = torch.Generator(device=device).manual_seed(mix(seed, 2))

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    def zeros(n):
        return torch.zeros((n,), device=device)

    k = config["conv_kernel"]
    f = config["num_fields"]
    c_in, length = f * (f - 1) // 2, config["embed_dim"]
    conv = []
    for c_out in config["conv_channels"]:
        conv.append({"w": normal((c_out, c_in, k), math.sqrt(2.0 / (c_in * k))),
                     "b": zeros(c_out)})
        c_in, length = c_out, length // config["conv_pool"]
    tower = []
    d_in = c_in * length + config["num_dense"]
    for d_out in config["tower_hidden"]:
        tower.append({"w": normal((d_in, d_out), math.sqrt(2.0 / d_in)), "b": zeros(d_out)})
        d_in = d_out
    tower.append({"w": normal((d_in, 1), math.sqrt(1.0 / d_in)), "b": zeros(1)})
    return {"conv": conv, "tower": tower, "bias": torch.zeros((), device=device)}


def make_params(config: dict, seed: int, device) -> dict:
    """The port's parameter tree: {"embed": {"table"}, "linear": {"bias"},
    "conv", "tower"}; the first-order weights ride in the table's padding
    column."""
    dense = make_dense(config, seed, device)
    return {"embed": {"table": make_table(config, seed, device)},
            "linear": {"bias": dense["bias"]},
            "conv": dense["conv"], "tower": dense["tower"]}

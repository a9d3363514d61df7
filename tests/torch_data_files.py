"""Data files and config pairs for the port's data-layer tests.

Every file is written from a seed, in the formats the readers parse: the
Criteo TSV and Avazu CSV of `cffm_tpu_torch/scripts/bench_input.py`,
small Criteo files with malformed rows and empty fields (as in
`tests/test_readers.py` and `tests/test_native_loader.py`), and a
MovieLens-1M directory (as in `tests/test_holdout.py`). `cfg_pair` gives
the same named config, with data overrides, from both packages, and
`assert_streams_equal` holds two batch streams bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cffm_tpu import config as jax_config
from cffm_tpu_torch import config


def cfg_pair(name: str, model=None, **data):
    """(JAX config, port config) of a named config with data overrides and,
    optionally, model overrides (a dict)."""
    out = []
    for mod in (jax_config, config):
        cfg = mod.get_config(name)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data))
        if model:
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))
        out.append(cfg)
    return tuple(out)


def write_criteo_messy(path: str, rows: int = 300, seed: int = 0) -> None:
    """A Criteo TSV with missing ints, empty categoricals and one malformed
    row after row 150 (which every reader skips)."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        label = rng.integers(0, 2)
        ints = [("" if rng.random() < 0.2 else str(rng.integers(-1, 5000))) for _ in range(13)]
        cats = [("" if rng.random() < 0.1 else f"{rng.integers(0, 2**32):08x}")
                for _ in range(26)]
        lines.append("\t".join([str(label)] + ints + cats))
        if i == 150:
            lines.append("1\tgarbage\trow")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_movielens(directory, ratings: int = 400, seed: int = 3) -> None:
    """users.dat, movies.dat and ratings.dat of 40 users and 30 movies,
    each (user, movie) pair unique per rating row."""
    rng = np.random.default_rng(seed)
    (directory / "users.dat").write_bytes(b"".join(
        b"%d::%s::%d::%d::9%04d\n" % (u, b"M" if u % 2 else b"F", (18, 25, 35)[u % 3],
                                      u % 21, u)
        for u in range(1, 41)))
    (directory / "movies.dat").write_bytes(b"".join(
        b"%d::T%d::Comedy|Drama\n" % (m, m) if m % 3 else b"%d::T%d::Action\n" % (m, m)
        for m in range(1, 31)))
    (directory / "ratings.dat").write_bytes(b"".join(
        b"%d::%d::%d::9780%05d\n" % (1 + i % 40, 1 + i // 40 % 30, int(rng.integers(1, 6)), i)
        for i in range(ratings)))


def assert_streams_equal(want, got, min_batches: int = 1) -> int:
    """Two streams of batches ((ids, dense, labels) tuples or Batch dicts)
    bit for bit, dtypes included; returns the number of batches."""
    want, got = list(want), list(got)
    assert len(got) == len(want) >= min_batches, (len(got), len(want))
    for a, b in zip(want, got):
        for x, y in zip(_leaves(a), _leaves(b), strict=True):
            if x is None:
                assert y is None
                continue
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    return len(got)


def _leaves(batch):
    if isinstance(batch, dict):
        return [leaf for k in sorted(batch) for leaf in _leaves(batch[k])]
    if isinstance(batch, tuple):
        return [leaf for x in batch for leaf in _leaves(x)]
    return [batch]


NARROW_CRITEO = dict(vocab_sizes=(64,) * 13 + (1000,) * 26, embed_dim=4, conv_channels=(8,),
                     tower_hidden=(16,), use_pallas=False, compute_dtype="float32")


def jax_state_as_numpy(state) -> dict:
    """A JAX TrainState as numpy in plain containers, the form
    `cffm_tpu_torch.convert.state_from_jax` takes (optax's state flattened)."""
    import jax

    dense = {}

    def walk(x):
        if hasattr(x, "mu"):
            dense.update(count=x.count, mu=x.mu, nu=x.nu)
        elif hasattr(x, "sum_of_squares"):
            dense.update(sum=x.sum_of_squares)
        elif isinstance(x, tuple):
            for y in x:
                walk(y)

    walk(state.dense_opt_state)
    return jax.tree.map(np.asarray, {"step": state.step, "params": state.params,
                                     "dense_opt_state": dense,
                                     "sparse_opt_state": state.sparse_opt_state})

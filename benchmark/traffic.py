"""The one traffic generator: planted click-through-rate batches, from
the parameters of a traffic file and a seed.

Each field's raw values follow zipf(a) truncated to the field's
cardinality (P(k) proportional to (k + 1)^-a, k < cardinality). Fields
from `hashed_from` on are categorical: a raw value is hashed (splitmix64
of the field and the value, a hash fixed for all seeds) into the field's
buckets, so hot values land on scattered rows and distinct values can
collide, as the port's hashing of the real data does. The fields before
are bucketized integers: the raw value is the id. Dense features are
N(0, 1); labels come from a planted second-order model of the raw
values (per-(field, value) latent factors of width 4 for the first 512
values of a field, pairwise field weights, a bias of -0.3 and half the
first dense feature), the law of the port's synthetic stream
(`data/synthetic.py`). Everything here is numpy on the host and depends
only on the seed and the traffic's parameters.
"""

from __future__ import annotations

import numpy as np

LATENT = 4
LATENT_IDS = 512
# values drawn from the exact CDF; rarer ones from its integral
HEAD = 1 << 16
_M64 = np.uint64((1 << 64) - 1)


def rng(seed: int, *words: int) -> np.random.Generator:
    """A numpy generator for (seed, words): any whole seed, negative too."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *words])


class TruncatedZipf:
    """Draws of k in [0, n) with P(k) proportional to (k + 1)^-a, a > 1:
    the first HEAD values by their exact CDF, the rest by inverting the
    midpoint integral of the tail (relative error under 1e-10 there)."""

    def __init__(self, a: float, n: int):
        self.a, self.n = float(a), int(n)
        head = np.cumsum(np.arange(1, min(n, HEAD) + 1, dtype=np.float64) ** -self.a)
        self.head_sum = float(head[-1])
        self.tail = 0.0
        if n > HEAD:
            self.tail = ((HEAD + 0.5) ** (1 - self.a) - (n + 0.5) ** (1 - self.a)) / (self.a - 1)
        self.total = self.head_sum + self.tail
        self.head_cdf = head / self.total

    def draw(self, u: np.ndarray) -> np.ndarray:
        """Values for uniforms u in [0, 1), int64."""
        k = np.searchsorted(self.head_cdf, u, side="right").astype(np.int64)
        far = k >= self.head_cdf.size
        if self.tail and far.any():
            a = self.a
            x = (HEAD + 0.5) ** (1 - a) - (a - 1) * (u[far] * self.total - self.head_sum)
            k[far] = np.ceil(np.maximum(x, 1e-300) ** (1 / (1 - a)) - 0.5).astype(np.int64) - 1
        return np.clip(k, 0, self.n - 1)


def bucket(field: int, values: np.ndarray, buckets: int) -> np.ndarray:
    """splitmix64(field, value) mod buckets: the fixed hash of a field's raw values."""
    with np.errstate(over="ignore"):
        x = values.astype(np.uint64) + np.uint64(field + 1) * np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(buckets)).astype(np.int64)


class PlantedCTR:
    """The planted world of a seed: ids, dense features and labels.

    law: {"kind": "zipf", "a", "cardinality": [per field, default the
    vocab], "hashed_from": first hashed field (default none)}."""

    def __init__(self, vocab_sizes, num_dense: int, seed: int, law: dict):
        if law["kind"] != "zipf":
            raise ValueError(f"unknown id law {law['kind']!r}")
        world = rng(seed, 0)
        self.vocab = np.asarray(vocab_sizes, dtype=np.int64)
        f = len(self.vocab)
        self.card = np.asarray(law.get("cardinality", self.vocab), dtype=np.int64)
        self.hashed_from = int(law.get("hashed_from", f))
        if self.card.shape != (f,) or (self.card[:self.hashed_from] > self.vocab[:self.hashed_from]).any():
            raise ValueError("a field's cardinality must be given, and fit its vocab unless hashed")
        self.num_dense = int(num_dense)
        self._laws = {int(n): TruncatedZipf(law["a"], int(n)) for n in set(self.card.tolist())}
        rows = np.minimum(self.card, LATENT_IDS)
        # every field's latent rows in one table; field i's start at _lat_off[i]
        self.latents = np.concatenate([world.normal(0.0, 1.0, size=(int(r), LATENT))
                                       .astype(np.float32) for r in rows])
        self._lat_last = rows - 1
        self._lat_off = np.concatenate([[0], np.cumsum(rows)[:-1]])
        self.pair_w = np.triu(world.normal(0.0, 1.0, size=(f, f)).astype(np.float32) / f, 1)
        self.bias = -0.3

    def values(self, gen: np.random.Generator, b: int) -> np.ndarray:
        """(b, F) int64 raw values."""
        u = gen.random((b, len(self.vocab)))
        return np.stack([self._laws[int(n)].draw(u[:, i]) for i, n in enumerate(self.card)], 1)

    def ids(self, values: np.ndarray) -> np.ndarray:
        """(b, F) int32 per-field local ids of raw values."""
        ids = values.copy()
        for i in range(self.hashed_from, len(self.vocab)):
            ids[:, i] = bucket(i, values[:, i], int(self.vocab[i]))
        return ids.astype(np.int32)

    def batch(self, gen: np.random.Generator, b: int):
        """(ids (b, F) int32 local, dense (b, num_dense) f32 | None, labels (b,) f32)."""
        raw = self.values(gen, b)
        f = len(self.vocab)
        rows = np.minimum(raw, self._lat_last) + self._lat_off              # (b, F)
        lt = self.latents[rows].transpose(0, 2, 1).reshape(b * LATENT, f)
        score = self.bias + np.einsum("ij,ij->i", lt @ self.pair_w, lt).reshape(b, LATENT).sum(axis=1)
        dense = None
        if self.num_dense:
            dense = gen.normal(0.0, 1.0, size=(b, self.num_dense)).astype(np.float32)
            score += 0.5 * dense[:, 0]
        p = 1.0 / (1.0 + np.exp(-score))
        labels = (gen.random(b) < p).astype(np.float32)
        return self.ids(raw), dense, labels


def field_offsets(vocab_sizes) -> np.ndarray:
    """Each field's first row in the one table."""
    v = np.asarray(vocab_sizes, dtype=np.int64)
    return np.concatenate([[0], np.cumsum(v)[:-1]])

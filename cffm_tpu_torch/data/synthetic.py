"""Synthetic CTR data with a learnable planted structure.

A numpy copy of the JAX package's generator: the same seeds give the
same batches, bit for bit. The label depends on second-order feature
interactions, so a cross/conv model can beat the logloss of a constant
predictor.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from cffm_tpu_torch.config import ModelConfig


class SyntheticCTR:
    """Streams batches of (ids, dense, labels).

    ids: (B, F) int32 per-field LOCAL ids (offsets applied by the loader).
    dense: (B, num_dense) float32 or None.
    labels: (B,) float32 in {0, 1}.
    """

    def __init__(self, cfg: ModelConfig, batch_size: int, seed: int = 0,
                 stream_seed: int | None = None):
        """seed fixes the planted WORLD (latents); stream_seed the SAMPLE
        stream, so train and val streams share the label function but
        draw disjoint samples."""
        self.cfg = cfg
        self.batch_size = batch_size
        world = np.random.default_rng(seed)
        self.rng = np.random.default_rng(
            seed if stream_seed is None else stream_seed)
        f = cfg.num_fields
        # Planted model: random per-(field-id) latent factors; label from
        # pairwise dot products of a low-dim latent + noise.
        k = 4
        self._latents = [
            world.normal(0.0, 1.0, size=(min(v, 512), k)).astype(np.float32)
            for v in cfg.vocab_sizes
        ]
        self._pair_w = world.normal(0.0, 1.0, size=(f, f)).astype(np.float32) / f
        self._bias = -0.3

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        cfg, b = self.cfg, self.batch_size
        f = cfg.num_fields
        # Zipf-ish id distribution (hot rows).
        ids = np.empty((b, f), dtype=np.int32)
        for i, v in enumerate(cfg.vocab_sizes):
            z = self.rng.zipf(1.3, size=b)
            ids[:, i] = np.minimum(z - 1, v - 1)
        lat = np.stack(
            [self._latents[i][np.minimum(ids[:, i], len(self._latents[i]) - 1)]
             for i in range(f)],
            axis=1,
        )  # (B, F, k)
        inter = np.einsum("bik,bjk->bij", lat, lat)
        score = np.einsum("bij,ij->b", inter, np.triu(self._pair_w, 1)) + self._bias
        if cfg.num_dense > 0:
            dense = self.rng.normal(0.0, 1.0, size=(b, cfg.num_dense)).astype(np.float32)
            score = score + 0.5 * dense[:, 0]
        else:
            dense = None
        p = 1.0 / (1.0 + np.exp(-score))
        labels = (self.rng.random(b) < p).astype(np.float32)
        return ids, dense, labels

    def __iter__(self) -> Iterator:
        while True:
            yield self.next_batch()

"""Pairwise cross construction + conv core: the plain PyTorch reference.

The port's counterpart of `cffm_tpu/ops/cross.py`: build the field-pair
× embedding-dim interaction map from pairwise Hadamard crosses
(FM-style) or field-aware crosses (FFM-style), then run a 1D conv stack
over the embedding-dim axis with the pair axis as input channels.
Conv weights keep the (C_out, C_in, k) layout of the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from cffm_tpu_torch.config import ModelConfig


@functools.lru_cache(maxsize=None)
def pair_indices(num_fields: int):
    """Static (i, j) index arrays for all ordered pairs i < j.

    Returns (pair_i, pair_j), each of shape (P,) with P = F(F-1)/2.
    """
    idx = [(i, j) for i in range(num_fields) for j in range(i + 1, num_fields)]
    pi = np.asarray([p[0] for p in idx], dtype=np.int64)
    pj = np.asarray([p[1] for p in idx], dtype=np.int64)
    return pi, pj


def build_cross_map(emb: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Interaction map M of shape (B, P, d), in emb's dtype.

    emb: (B, F, d) for "hadamard", (B, F, F, d) for "field_aware"
    (emb[b, i, j] is e_{i->j}, field i's embedding dedicated to peer j).
    """
    pi, pj = (torch.from_numpy(a).to(emb.device)
              for a in pair_indices(cfg.num_fields))
    if cfg.cross == "hadamard":
        if emb.ndim != 3:
            raise ValueError(f"hadamard cross wants (B, F, d), got {tuple(emb.shape)}")
        return emb[:, pi, :] * emb[:, pj, :]
    if emb.ndim != 4:
        raise ValueError(f"field-aware cross wants (B, F, F, d), got {tuple(emb.shape)}")
    return emb[:, pi, pj, :] * emb[:, pj, pi, :]


def conv1d_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv1d with SAME padding: (k-1)//2 zeros before, the rest after."""
    k = w.shape[-1]
    lo = (k - 1) // 2
    return F.conv1d(F.pad(x, (lo, k - 1 - lo)), w)


def max_pool_valid(x: torch.Tensor, k: int) -> torch.Tensor:
    """Max over non-overlapping windows of k along the last axis of
    (B, C, L), a ragged tail dropped (reduce_window VALID): a reshape and
    torch.max, whose backward scatters to each window's first max as
    max_pool1d's does, but runs far faster on the card at these shapes."""
    n = x.shape[-1] // k
    return x[..., : n * k].reshape(*x.shape[:-1], n, k).max(dim=-1).values


def conv_core_reference(cross_map: torch.Tensor, conv_params, cfg: ModelConfig
                        ) -> torch.Tensor:
    """1D conv stack over the interaction map.

    cross_map: (B, P, d). Channels = pair axis, spatial = embed-dim axis.
    Each layer: conv1d(SAME) -> bias -> relu -> maxpool(conv_pool).
    Returns flattened (B, C_last * d_final), channel-major.
    """
    x = cross_map
    for layer in conv_params:
        x = conv1d_same(x, layer["w"].to(x.dtype))
        x = x + layer["b"].to(x.dtype)[None, :, None]
        x = torch.relu(x)
        if cfg.conv_pool > 1:
            x = max_pool_valid(x, cfg.conv_pool)
    return x.reshape(x.shape[0], -1)


def interaction_conv_reference(emb: torch.Tensor, conv_params, cfg: ModelConfig
                               ) -> torch.Tensor:
    """Reference (unfused) path: cross build + conv core."""
    return conv_core_reference(build_cross_map(emb, cfg), conv_params, cfg)

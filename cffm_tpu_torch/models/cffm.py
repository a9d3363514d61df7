"""CFFM model: embeddings -> pairwise cross -> conv core -> MLP tower.

The port's counterpart of `cffm_tpu/models/cffm.py`. Parameters are a
plain dict of tensors with the JAX package's tree and layouts:

  {"embed": {"table": (total_vocab, table_width)},
   "linear": {"bias": (), ["table": (total_vocab, 1)]},
   "conv": [{"w": (C_out, C_in, k), "b": (C_out,)}, ...],
   "tower": [{"w": (in, out), "b": (out,)}, ...]}

The lookup is split from the rest of the forward, so a sharded lookup
can take its place and a train step can take grads w.r.t. the rows.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from cffm_tpu_torch.config import ModelConfig
from cffm_tpu_torch.ops import embed_lookup
from cffm_tpu_torch.ops.cross import build_cross_map, conv_core_reference
from cffm_tpu_torch.utils import profiling


def torch_dtype(name: str) -> torch.dtype:
    """"float32" | "bfloat16" | ... -> the torch dtype of that name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def field_offsets(cfg: ModelConfig) -> np.ndarray:
    """Per-field starting offset into the single combined vocab space."""
    return np.concatenate([[0], np.cumsum(cfg.vocab_sizes)[:-1]]).astype(np.int64)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                skip_tables: bool = False) -> Dict:
    """Initialize all parameters on the generator's device.

    Tables: N(0, 0.01), drawn in f32 then cast to table_dtype. Conv and
    tower: He for ReLU layers, Glorot for the final logit layer. The
    distributions are the JAX package's; the draws are torch's own.
    skip_tables: omit the (vocab, W) tables.
    """
    dev = generator.device
    pdt = torch_dtype(cfg.param_dtype)
    tdt = torch_dtype(cfg.table_dtype)

    def normal(shape, dtype=torch.float32):
        return torch.randn(shape, generator=generator, device=dev, dtype=dtype)

    params: Dict = {"embed": {} if skip_tables else {
        "table": (0.01 * normal((cfg.total_vocab, cfg.table_width))).to(tdt)}}
    if cfg.use_first_order:
        params["linear"] = {"bias": torch.zeros((), dtype=pdt, device=dev)}
        if not cfg.fused_linear and not skip_tables:
            params["linear"]["table"] = (
                0.01 * normal((cfg.total_vocab, 1))).to(tdt)

    conv_layers = []
    in_ch = cfg.num_pairs
    for out_ch in cfg.conv_channels:
        scale = math.sqrt(2.0 / (in_ch * cfg.conv_kernel))
        conv_layers.append({
            "w": normal((out_ch, in_ch, cfg.conv_kernel), pdt) * scale,
            "b": torch.zeros((out_ch,), dtype=pdt, device=dev)})
        in_ch = out_ch
    params["conv"] = conv_layers

    tower_layers = []
    in_dim = cfg.conv_out_dim + cfg.num_dense
    for out_dim in cfg.tower_hidden:
        tower_layers.append({
            "w": normal((in_dim, out_dim), pdt) * math.sqrt(2.0 / in_dim),
            "b": torch.zeros((out_dim,), dtype=pdt, device=dev)})
        in_dim = out_dim
    tower_layers.append({
        "w": normal((in_dim, 1), pdt) * math.sqrt(1.0 / in_dim),
        "b": torch.zeros((1,), dtype=pdt, device=dev)})
    params["tower"] = tower_layers
    return params


def embedding_lookup(params: Dict, ids: torch.Tensor, cfg: ModelConfig):
    """Replicated-table lookup. ids: (B, F) global (offset-applied) ids.

    Returns (emb_rows, lin_rows): (B, F, table_width) and (B, F, 1) | None.
    """
    emb_rows = embed_lookup.take_rows(params["embed"]["table"], ids)
    lin_rows = None
    if cfg.use_first_order and not cfg.fused_linear:
        lin_rows = embed_lookup.take_rows(params["linear"]["table"], ids)
    return emb_rows, lin_rows


def wants_field_major(params: Dict, cfg: ModelConfig, interaction_fn) -> bool:
    """Whether the forward runs the FIELD-MAJOR full-rows path: ids
    transposed to (F, B) before the gather, so the rows land (F, B, W),
    the layout the field-major kernel entries read."""
    return (getattr(interaction_fn, "full_rows_fm", None) is not None
            and cfg.fused_linear and cfg.cross == "field_aware"
            and cfg.conv_kernel % 2 == 1 and cfg.embed_dim % 2 == 0
            and bool(params["conv"]))


def embedding_lookup_fm(params: Dict, ids_fm: torch.Tensor, cfg: ModelConfig
                        ) -> torch.Tensor:
    """Field-major lookup. ids_fm: (F, B) global ids -> (F, B, table_width)."""
    return embed_lookup.take_rows(params["embed"]["table"], ids_fm)


@functools.lru_cache(maxsize=16)
def prefix_bounds(cfg: ModelConfig) -> tuple:
    """(0, v0, v0 + v1, ...): field f of the small-field prefix holds the
    global ids [bounds[f], bounds[f + 1]); () without a prefix."""
    fs = cfg.small_field_prefix
    return tuple(int(x) for x in np.cumsum([0, *cfg.vocab_sizes[:fs]])) if fs else ()


def onehot_lookup_fm(table_small: torch.Tensor, ids_fm_small: torch.Tensor,
                     cfg: ModelConfig, out_dtype=None) -> torch.Tensor:
    """Lookup of the small-field table prefix.

    table_small: (small_rows, table_width), the table's leading block.
    ids_fm_small: (small_field_prefix, B) GLOBAL ids. Returns
    (small_field_prefix, B, table_width) in out_dtype.

    The JAX package multiplies a one-hot matrix per field with that
    field's block of rows. This gathers the same rows instead, which is
    bit-equal to the one-hot product: each output row is 1.0 times one
    row of the block, and an id outside its field's block gives a row of
    zeros, as its all-zero one-hot row does. An f32 one-hot matmul under
    TF32 would round the table, so this path has no matmul at all. On the
    card it is one launch of `ops/embed_lookup`'s kernel."""
    dt = out_dtype or table_small.dtype
    return embed_lookup.lookup_fm(table_small, ids_fm_small.t(), prefix_bounds(cfg), dt)[0]


def _tower(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    layers = params["tower"]
    for layer in layers[:-1]:
        x = torch.relu(x @ layer["w"].to(x.dtype) + layer["b"].to(x.dtype))
    last = layers[-1]
    x = x @ last["w"].to(x.dtype) + last["b"].to(x.dtype)
    return x[:, 0]


def _logits(params: Dict, feats: torch.Tensor, lin_sum: torch.Tensor,
            dense: Optional[torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Tower over (feats ++ dense), plus the first-order sum and bias, f32."""
    if dense is not None and cfg.num_dense > 0:
        feats = torch.cat([feats, dense.to(feats.dtype)], dim=-1)
    logits = _tower(params, feats, cfg).float()
    return logits + lin_sum + params["linear"]["bias"].float()


def forward_from_rows_fm(params: Dict, emb3: torch.Tensor,
                         dense: Optional[torch.Tensor], cfg: ModelConfig, *,
                         interaction_fn) -> torch.Tensor:
    """Field-major full-rows forward: emb3 (F, B, table_width) raw
    physical rows; the fused kernel slices fields and sums the
    first-order column."""
    cdt = torch_dtype(cfg.compute_dtype)
    feats, lin_sum = interaction_fn.full_rows_fm(emb3.to(cdt), params["conv"], cfg)
    return _logits(params, feats, lin_sum, dense, cfg)


def forward_from_rows_fm2(params: Dict, emb_small: torch.Tensor,
                          emb_big: Optional[torch.Tensor],
                          dense: Optional[torch.Tensor], cfg: ModelConfig, *,
                          interaction_fn) -> torch.Tensor:
    """Split-operand twin of forward_from_rows_fm for the hybrid lookup:
    emb_small (Fs, B, W) from onehot_lookup_fm, emb_big (Fb, B, W) from
    the gather. Routes to interaction_fn.full_rows_fm2 when present,
    else concatenates and takes the single-operand path."""
    fn2 = getattr(interaction_fn, "full_rows_fm2", None)
    if emb_big is None:
        return forward_from_rows_fm(params, emb_small, dense, cfg,
                                    interaction_fn=interaction_fn)
    if fn2 is None:
        return forward_from_rows_fm(params, torch.cat([emb_small, emb_big]),
                                    dense, cfg, interaction_fn=interaction_fn)
    cdt = torch_dtype(cfg.compute_dtype)
    feats, lin_sum = fn2(emb_small.to(cdt), emb_big.to(cdt), params["conv"], cfg)
    return _logits(params, feats, lin_sum, dense, cfg)


def forward_from_rows(params: Dict, emb_rows: torch.Tensor,
                      lin_rows: Optional[torch.Tensor],
                      dense: Optional[torch.Tensor], cfg: ModelConfig, *,
                      interaction_fn=None) -> torch.Tensor:
    """Forward pass from looked-up rows (B, F, table_width) to logits (B,).

    interaction_fn(emb, conv_params, cfg) -> flat conv features; None
    takes the reference conv stack."""
    b = emb_rows.shape[0]
    cdt = torch_dtype(cfg.compute_dtype)

    full_rows = getattr(interaction_fn, "full_rows", None)
    if (full_rows is not None and cfg.fused_linear
            and cfg.cross == "field_aware" and cfg.conv_kernel % 2 == 1
            and cfg.embed_dim % 2 == 0 and params["conv"]):
        emb2d = emb_rows.reshape(b, cfg.num_fields * cfg.table_width).to(cdt)
        feats, lin_sum = full_rows(emb2d, params["conv"], cfg)
        return _logits(params, feats, lin_sum, dense, cfg)

    emb = emb_rows.to(cdt)
    if cfg.fused_linear:
        # first-order weights ride in the padding column
        lin_rows = emb_rows[..., cfg.row_width : cfg.row_width + 1]
    if cfg.table_width != cfg.row_width:
        emb = emb[..., : cfg.row_width]
    if cfg.cross == "field_aware":
        emb = emb.reshape(b, cfg.num_fields, cfg.num_fields, cfg.embed_dim)

    if interaction_fn is None:
        feats = conv_core_reference(build_cross_map(emb, cfg), params["conv"], cfg)
    else:
        feats = interaction_fn(emb, params["conv"], cfg)
    if dense is not None and cfg.num_dense > 0:
        feats = torch.cat([feats, dense.to(cdt)], dim=-1)
    logits = _tower(params, feats, cfg).float()
    if cfg.use_first_order:
        logits = logits + lin_rows.float().sum(dim=(1, 2))
        logits = logits + params["linear"]["bias"].float()
    return logits


def forward(params: Dict, ids: torch.Tensor, dense: Optional[torch.Tensor],
            cfg: ModelConfig, *, interaction_fn=None) -> torch.Tensor:
    """Full replicated-table forward: ids (B, F) int32 global -> logits (B,).

    Routes through the field-major hybrid small-field path (prefix
    lookup + big-field gather + split-operand kernel) when the config
    qualifies, else through the batch-major gather and forward_from_rows,
    exactly as the JAX package routes.

    Under a torch profiler it records the span cffm.forward and, inside
    it, cffm.lookup: on the hybrid path one launch of `ops/embed_lookup`'s
    kernel on the card, which writes both operands in the compute dtype;
    else the gathers (`utils/profiling.py`). The interaction fn records
    cffm.conv_tail around the conv tail: one launch of its kernel on the
    card when no gradient is taken (`ops/interaction_conv.conv_tail`)."""
    with profiling.span("cffm.forward"):
        fs = cfg.small_field_prefix
        if fs and wants_field_major(params, cfg, interaction_fn):
            with profiling.span("cffm.lookup"):
                emb_small, emb_big = embed_lookup.lookup_fm(
                    params["embed"]["table"], ids, prefix_bounds(cfg),
                    torch_dtype(cfg.compute_dtype))
                if fs == cfg.num_fields:
                    emb_big = None
            return forward_from_rows_fm2(params, emb_small, emb_big, dense, cfg,
                                         interaction_fn=interaction_fn)
        with profiling.span("cffm.lookup"):
            emb_rows, lin_rows = embedding_lookup(params, ids, cfg)
        return forward_from_rows(params, emb_rows, lin_rows, dense, cfg,
                                 interaction_fn=interaction_fn)

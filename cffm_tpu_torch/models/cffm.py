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
from typing import Dict, NamedTuple, Optional, Sequence

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


# A table whose f32 draw passes INIT_DRAW_BYTES is drawn INIT_ROWS rows a
# randn call: one draw holds two f32 copies beside the table, more than an
# 80 GB card has past 24 GiB (criteo_full's 26M x 640 rows on one card).
# Smaller tables keep the one draw, and with it their random stream.
INIT_DRAW_BYTES = 24 << 30
INIT_ROWS = 1 << 18


def draw_table(rows: int, width: int, dtype: torch.dtype, generator: torch.Generator
               ) -> torch.Tensor:
    """(rows, width) N(0, 0.01) drawn in f32 on the generator's device and
    cast to dtype: one draw, or INIT_ROWS rows a draw where the f32 draw
    passes INIT_DRAW_BYTES. On the CPU's generator the chunks follow the one
    draw's stream."""
    dev = generator.device
    if rows * width * 4 <= INIT_DRAW_BYTES:
        return (0.01 * torch.randn((rows, width), generator=generator, device=dev)).to(dtype)
    out = torch.empty((rows, width), dtype=dtype, device=dev)
    for r in range(0, rows, INIT_ROWS):
        n = min(INIT_ROWS, rows - r)
        out[r:r + n] = 0.01 * torch.randn((n, width), generator=generator, device=dev)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                skip_tables: bool = False) -> Dict:
    """Initialize all parameters on the generator's device.

    Tables: N(0, 0.01), drawn in f32 then cast to table_dtype
    (`draw_table`). Conv and tower: He for ReLU layers, Glorot for the
    final logit layer. The distributions are the JAX package's; the draws
    are torch's own. skip_tables: omit the (vocab, W) tables.
    """
    dev = generator.device
    pdt = torch_dtype(cfg.param_dtype)
    tdt = torch_dtype(cfg.table_dtype)

    def normal(shape, dtype=torch.float32):
        return torch.randn(shape, generator=generator, device=dev, dtype=dtype)

    params: Dict = {"embed": {} if skip_tables else {
        "table": draw_table(cfg.total_vocab, cfg.table_width, tdt, generator)}}
    if cfg.use_first_order:
        params["linear"] = {"bias": torch.zeros((), dtype=pdt, device=dev)}
        if not cfg.fused_linear and not skip_tables:
            params["linear"]["table"] = draw_table(cfg.total_vocab, 1, tdt, generator)

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


class Route(NamedTuple):
    """Which layout the looked-up rows take and which entry of the
    interaction fn reads them (`forward_from_rows`).

    full_rows: the fused entries read the raw physical rows and sum the
    first-order column; else the rows are sliced to (B, F, F, d) for the
    interaction fn itself. field_major: the rows are (F, B, W), ids
    transposed before the gather; else (B, F, W). prefix: the leading
    fields whose rows come from the small-field table prefix as an
    operand of their own (the hybrid route), 0 without."""
    full_rows: bool
    field_major: bool
    prefix: int

    def batch_major(self) -> "Route":
        """The same entries on batch-major rows, with no prefix."""
        return Route(self.full_rows, False, 0)


def route(params: Dict, cfg: ModelConfig, interaction_fn, prefix_update: bool = True
          ) -> Route:
    """The train step's route: field-major full rows where the interaction
    fn has the fused entries and the config their shapes (the first-order
    column fused, the field-aware cross, odd k, even d, a conv layer),
    with the small-field prefix apart where prefix_update says the caller
    can update the prefix in its dense form. Else batch-major."""
    full = (getattr(interaction_fn, "full_rows", None) is not None
            and cfg.fused_linear and cfg.cross == "field_aware"
            and cfg.conv_kernel % 2 == 1 and cfg.embed_dim % 2 == 0
            and bool(params["conv"]))
    return Route(full, full, cfg.small_field_prefix if full and prefix_update else 0)


def forward_route(params: Dict, cfg: ModelConfig, interaction_fn) -> Route:
    """The forward's route: field-major only with a small-field prefix,
    else the batch-major full rows (or the sliced rows)."""
    r = route(params, cfg, interaction_fn)
    return r if r.prefix else r.batch_major()


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


def lookup(params: Dict, route: Route, ids: torch.Tensor, cfg: ModelConfig) -> tuple:
    """The replicated table's rows of ids (B, F) int32 global, as
    `forward_from_rows` takes them on route. Field-major: one launch of
    `ops/embed_lookup`'s kernel on the card, the rows in the compute dtype,
    the prefix's (Fs, B, W) and then the other fields' (F - Fs, B, W), each
    only where it has a field. Batch-major: the gathers, (B, F, W) in the
    table dtype and, where a table of its own holds the first-order
    weights, their (B, F, 1)."""
    if route.field_major:
        emb_small, emb_big = embed_lookup.lookup_fm(
            params["embed"]["table"], ids, prefix_bounds(cfg) if route.prefix else (),
            torch_dtype(cfg.compute_dtype))
        return (((emb_small,) if route.prefix else ())
                + ((emb_big,) if route.prefix < cfg.num_fields else ()))
    emb_rows, lin_rows = embedding_lookup(params, ids, cfg)
    return (emb_rows,) if lin_rows is None else (emb_rows, lin_rows)


def forward_from_rows(params: Dict, route: Route, rows: Sequence[torch.Tensor],
                      dense: Optional[torch.Tensor], cfg: ModelConfig, *,
                      interaction_fn=None) -> torch.Tensor:
    """Forward pass from looked-up rows to logits (B,). rows are in the
    route's layout, as `lookup` returns them: on the field-major route
    the raw physical rows of one operand (F, B, W), or of two beside a
    prefix (Fs, B, W) + (F - Fs, B, W), which the split-operand entry
    reads in place; on the batch-major route (B, F, W) and, with a
    separate first-order table, its rows (B, F, 1).

    interaction_fn(emb, conv_params, cfg) -> flat conv features; None
    takes the reference conv stack."""
    cdt = torch_dtype(cfg.compute_dtype)
    if route.field_major:
        parts = [r.to(cdt) for r in rows]
        if len(parts) == 2:
            feats, lin_sum = interaction_fn.full_rows_fm2(*parts, params["conv"], cfg)
        else:
            feats, lin_sum = interaction_fn.full_rows_fm(parts[0], params["conv"], cfg)
        return _logits(params, feats, lin_sum, dense, cfg)

    emb_rows = rows[0]
    b = emb_rows.shape[0]
    if route.full_rows:
        emb2d = emb_rows.reshape(b, cfg.num_fields * cfg.table_width).to(cdt)
        feats, lin_sum = interaction_fn.full_rows(emb2d, params["conv"], cfg)
        return _logits(params, feats, lin_sum, dense, cfg)

    emb = emb_rows.to(cdt)
    # first-order weights: in the padding column, or the table of their own
    lin_rows = (emb_rows[..., cfg.row_width : cfg.row_width + 1] if cfg.fused_linear
                else rows[1] if len(rows) > 1 else None)
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
    """Full replicated-table forward: ids (B, F) int32 global -> logits (B,),
    on `forward_route`: the field-major hybrid small-field route (prefix
    and big fields in one lookup, the split-operand entry) where the
    config qualifies, else the batch-major gather, exactly as the JAX
    package routes.

    Under a torch profiler it records the span cffm.forward and, inside
    it, cffm.lookup: on the hybrid route one launch of `ops/embed_lookup`'s
    kernel on the card, which writes both operands in the compute dtype;
    else the gathers (`utils/profiling.py`). The interaction fn records
    cffm.conv_tail around the conv tail: one launch of its kernel on the
    card when no gradient is taken (`ops/interaction_conv.conv_tail`)."""
    with profiling.span("cffm.forward"):
        r = forward_route(params, cfg, interaction_fn)
        with profiling.span("cffm.lookup"):
            rows = lookup(params, r, ids, cfg)
        return forward_from_rows(params, r, rows, dense, cfg, interaction_fn=interaction_fn)

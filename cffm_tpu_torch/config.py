"""Frozen dataclass configs for the five CFFM configurations.

The port's own copy of the JAX package's configuration, field for field
and default for default, so that a config built by either package
describes the same model, optimizer, data stream and mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """CFFM model hyperparameters.

    The cross construction is pluggable:
      - "hadamard":    p_ij = e_i * e_j              (FM-style)
      - "field_aware": p_ij = e_{i->j} * e_{j->i}    (FFM-style, namesake)
    """

    num_fields: int
    vocab_sizes: Tuple[int, ...]  # per-field hash-bucket counts
    embed_dim: int = 16
    cross: str = "field_aware"  # "hadamard" | "field_aware"
    conv_channels: Tuple[int, ...] = (64, 64)
    conv_kernel: int = 3  # 1D kernel width along the embed-dim axis
    conv_pool: int = 2  # max-pool factor along embed-dim after each conv
    tower_hidden: Tuple[int, ...] = (256, 128)
    num_dense: int = 0  # continuous features appended to the tower input
    use_first_order: bool = True  # FM first-order linear term
    compute_dtype: str = "bfloat16"  # matmul/conv activations dtype
    param_dtype: str = "float32"
    # Embedding-table storage dtype. Optimizer state stays f32 either way.
    table_dtype: str = "float32"
    # Fused cross+conv1 kernel (the CUDA kernel on a CUDA tensor, its
    # plain version on a CPU tensor); False takes the reference conv stack.
    use_pallas: bool = True
    # Hybrid lookup: the LEADING fields whose vocab <= this threshold are
    # looked up from a small table prefix and passed to the fused kernel
    # as a separate operand; 0 = off.
    small_field_threshold: int = 512

    def __post_init__(self):
        if len(self.vocab_sizes) != self.num_fields:
            raise ValueError("vocab_sizes must have num_fields entries")
        if self.cross not in ("hadamard", "field_aware"):
            raise ValueError(f"unknown cross {self.cross!r}")

    @property
    def num_pairs(self) -> int:
        f = self.num_fields
        return f * (f - 1) // 2

    @property
    def row_width(self) -> int:
        """Logical embedding row width: d (hadamard) or F*d (field-aware)."""
        if self.cross == "field_aware":
            return self.num_fields * self.embed_dim
        return self.embed_dim

    @property
    def table_width(self) -> int:
        """Physical table row width: padded to a 128-lane multiple when
        the overhead is at most 10%."""
        w = self.row_width
        padded = ((w + 127) // 128) * 128
        if w > 128 and (padded - w) * 10 <= w:
            return padded
        return w

    @property
    def fused_linear(self) -> bool:
        """First-order weights live in the table's padding column
        (column row_width) when padding exists."""
        return self.use_first_order and self.table_width > self.row_width

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def small_field_prefix(self) -> int:
        """Number of LEADING fields with vocab <= small_field_threshold;
        the prefix is capped at 4096 table rows."""
        if self.small_field_threshold <= 0:
            return 0
        fs, rows = 0, 0
        for v in self.vocab_sizes:
            if v > self.small_field_threshold or rows + v > 4096:
                break
            fs += 1
            rows += int(v)
        return fs

    @property
    def small_rows(self) -> int:
        """Rows of the small-field table prefix ([0, small_rows))."""
        return int(sum(self.vocab_sizes[: self.small_field_prefix]))

    @property
    def conv_out_dim(self) -> int:
        """Flattened conv-core output size fed to the tower."""
        d = self.embed_dim
        for _ in self.conv_channels:
            d = d // self.conv_pool
        if d < 1:
            raise ValueError("embed_dim too small for this many pool layers")
        return d * (self.conv_channels[-1] if self.conv_channels else self.num_pairs)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Dense tower/conv optimizer and the per-row sparse table optimizer."""

    dense_optimizer: str = "adam"  # "adam" | "adagrad" | "sgd"
    dense_lr: float = 1e-3
    # "adagrad" | "adam" | "rowwise_adam" | "sgd"
    sparse_optimizer: str = "adagrad"
    sparse_lr: float = 1e-2
    adagrad_init: float = 0.1  # initial accumulator value
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    # Global-norm clip on the dense grads (0 = off); sparse row grads are
    # clipped per row to the same norm.
    clip_norm: float = 0.0
    # Learning-rate schedule for both the dense and the sparse path:
    # linear warmup, then "constant" | "cosine" | "linear" decay to
    # end_lr_factor of the base LR across decay_steps (0 = num_train_steps).
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 0
    end_lr_factor: float = 0.0
    # Rounding of updates into a bfloat16 table: "stochastic" | "nearest".
    table_rounding: str = "stochastic"
    # Streamed table update: "auto" | "on" | "off".
    streamed_update: str = "auto"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"  # synthetic | criteo | avazu | movielens | prehashed
    path: Optional[str] = None  # TSV/.cfb/file location (None -> synthetic)
    batch_size: int = 4096  # global batch size
    shuffle: bool = False  # train stream only
    shuffle_buffer: int = 1 << 14
    # Negative downsampling of the train stream; eval and score add
    # ln(rate) to the logit (metrics.calibration_offset).
    neg_downsample: float = 1.0
    num_train_steps: int = 1000
    eval_every: int = 0  # 0 = eval only at the end
    eval_batches: int = 32
    val_every: int = 10  # held-out split: every val_every-th chunk/example
    reader_threads: int = 4
    wire_format: str = "raw"  # "raw" | "packed" (train stream)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Mesh layout: data-parallel batch and row-sharded tables."""

    data_axis: str = "data"
    table_sharded: bool = False  # False -> tables replicated (1-device cfgs)
    table_axis: str = "global"  # "global" | "intra_host" | "hier"
    # Per-peer all-to-all bucket slack and absolute bucket budgets.
    id_capacity_factor: float = 2.0
    cap_rows: int = 0
    cap_rows_host: int = 0
    dedup: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    name: str
    model: ModelConfig
    optim: OptimizerConfig = OptimizerConfig()
    data: DataConfig = DataConfig()
    sharding: ShardingConfig = ShardingConfig()
    log_every: int = 50
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # steps; 0 = disabled
    tensorboard_dir: Optional[str] = None
    debug_barriers: bool = False


# ---------------------------------------------------------------------------
# The five named configs
# ---------------------------------------------------------------------------

# Criteo-Kaggle: 13 integer features (bucketized to categorical) + 26
# categorical = 39 fields.
_CRITEO_FIELDS = 39
_CRITEO_VOCABS = tuple([64] * 13 + [100_000] * 26)

# Avazu: hour expanded to (hour-of-day, day-of-week) -> 23 categorical fields.
_AVAZU_FIELDS = 23
_AVAZU_VOCABS = tuple([32, 8] + [50_000] * 21)

# MovieLens-1M: user, movie, gender, age, occupation, zip, genre -> 7 fields.
_ML1M_VOCABS = (6100, 4000, 2, 8, 22, 3500, 19)


def _movielens() -> TrainConfig:
    return TrainConfig(
        name="movielens",
        model=ModelConfig(
            num_fields=7,
            vocab_sizes=_ML1M_VOCABS,
            embed_dim=16,
            cross="field_aware",
            conv_channels=(32, 32),
            tower_hidden=(128, 64),
        ),
        data=DataConfig(dataset="movielens", batch_size=1024, num_train_steps=2000),
        optim=OptimizerConfig(sparse_optimizer="adagrad"),
        sharding=ShardingConfig(table_sharded=False),
    )


def _criteo_kaggle() -> TrainConfig:
    return TrainConfig(
        name="criteo_kaggle",
        model=ModelConfig(
            num_fields=_CRITEO_FIELDS,
            vocab_sizes=_CRITEO_VOCABS,
            embed_dim=16,
            cross="field_aware",
            num_dense=13,
        ),
        data=DataConfig(dataset="criteo", batch_size=4096),
        sharding=ShardingConfig(table_sharded=False),
    )


def _avazu() -> TrainConfig:
    return TrainConfig(
        name="avazu",
        model=ModelConfig(
            num_fields=_AVAZU_FIELDS,
            vocab_sizes=_AVAZU_VOCABS,
            embed_dim=16,
            cross="field_aware",
        ),
        data=DataConfig(dataset="avazu", batch_size=4096),
        optim=OptimizerConfig(sparse_optimizer="adagrad"),
        sharding=ShardingConfig(table_sharded=True),
    )


def _criteo_full() -> TrainConfig:
    return TrainConfig(
        name="criteo_full",
        model=ModelConfig(
            num_fields=_CRITEO_FIELDS,
            vocab_sizes=tuple([64] * 13 + [1_000_000] * 26),
            embed_dim=16,
            cross="field_aware",
            num_dense=13,
            table_dtype="bfloat16",
        ),
        data=DataConfig(dataset="criteo", batch_size=32768),
        sharding=ShardingConfig(table_sharded=True),
    )


def _multihost() -> TrainConfig:
    cfg = _criteo_full()
    # Two-stage exchange with host-level dedup and fixed bucket budgets.
    return dataclasses.replace(
        cfg, name="multihost",
        sharding=dataclasses.replace(cfg.sharding, table_axis="hier",
                                     cap_rows=8192, cap_rows_host=16384))


_CONFIGS = {
    "movielens": _movielens,
    "criteo_kaggle": _criteo_kaggle,
    "avazu": _avazu,
    "criteo_full": _criteo_full,
    "multihost": _multihost,
}


def get_config(name: str) -> TrainConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(_CONFIGS)}")
    return _CONFIGS[name]()


def list_configs():
    return sorted(_CONFIGS)

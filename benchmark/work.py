"""The yardstick's arithmetic: the card's peaks, the model's FLOPs per
example, and each kernel's least bytes and operations.

Counts follow the roofline rule: each input byte read once, each output
byte written once, and data-dependent work (distinct rows) counted from
the inputs the benchmark generated. The kernels' formulas are those of
the port's on-card smoke test (`chip_smoke.py`), kept here so that the
same work is counted whatever implements it. `config` is the model
section of a configuration file (a dict).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def pairs(config: dict) -> int:
    f = config["num_fields"]
    return f * (f - 1) // 2


def row_width(config: dict) -> int:
    d = config["embed_dim"]
    return config["num_fields"] * d if config["cross"] == "field_aware" else d


def table_width(config: dict) -> int:
    """The physical row width: padded to 128 lanes when that costs <= 10%."""
    w = row_width(config)
    padded = (w + 127) // 128 * 128
    return padded if w > 128 and (padded - w) * 10 <= w else w


def small_prefix(config: dict) -> int:
    """The leading fields looked up from the table's small prefix: vocab
    at most small_field_threshold, at most 4096 rows in all."""
    fs = rows = 0
    for v in config["vocab_sizes"]:
        if config["small_field_threshold"] <= 0 or v > config["small_field_threshold"] \
                or rows + v > 4096:
            break
        fs, rows = fs + 1, rows + v
    return fs


def forward_flops(config: dict) -> dict:
    """Model FLOPs of one example's forward, by part: the cross products
    (one multiply each), each conv layer (2 * C_in * k * C_out * L_out
    over SAME padding) and the tower's matmuls (2 * in * out). Bias,
    ReLU, pooling and the first-order sum are not counted."""
    d, k = config["embed_dim"], config["conv_kernel"]
    out = {"cross": pairs(config) * d}
    c_in, length = pairs(config), d
    for i, c_out in enumerate(config["conv_channels"]):
        out[f"conv{i + 1}"] = 2 * c_in * k * c_out * length
        c_in, length = c_out, length // config["conv_pool"]
    tower = 0
    dims = [c_in * length + config["num_dense"], *config["tower_hidden"], 1]
    for a, b in zip(dims[:-1], dims[1:]):
        tower += 2 * a * b
    out["tower"] = tower
    return out


def example_flops(config: dict, train: bool) -> int:
    """FLOPs of one example: the forward, times 3 when training (the
    backward at twice the forward)."""
    fwd = sum(forward_flops(config).values())
    return 3 * fwd if train else fwd


def bound_s(nbytes: float, ops: float, kind: str = "bfloat16") -> float:
    """Least time for the work: max(bytes / memory rate, ops / peak rate)."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[kind])


def k1(config: dict, batch: int) -> dict:
    """Kernel 1, the fused cross + conv1 forward over the split
    field-major bf16 rows: the rows and f32 weights read, y (B, C1, d)
    bf16 and the f32 first-order sums written; the conv's multiply-adds."""
    f, d, k = config["num_fields"], config["embed_dim"], config["conv_kernel"]
    c1 = config["conv_channels"][0]
    w1 = c1 * pairs(config) * k
    nbytes = batch * f * table_width(config) * 2 + w1 * 4 + batch * c1 * d * 2 + batch * 4
    ops = 2 * batch * c1 * d * pairs(config) * k
    return {"bytes": nbytes, "ops": ops, "kind": "bfloat16"}


def k2(config: dict, batch: int) -> dict:
    """Kernel 2, its backward: the rows read and their gradient written
    (bf16), gY (B, C1, d) bf16 and the f32 first-order gradient read, the
    bf16 weights read and the f32 weight gradient written; the multiply-
    adds of dM (and so dE) and of dW1."""
    f, d, k = config["num_fields"], config["embed_dim"], config["conv_kernel"]
    c1 = config["conv_channels"][0]
    w1 = c1 * pairs(config) * k
    nbytes = (2 * batch * f * table_width(config) * 2 + batch * c1 * d * 2 + batch * 4
              + w1 * 2 + w1 * 4)
    ops = 2 * (2 * batch * d * pairs(config) * k * c1)
    return {"bytes": nbytes, "ops": ops, "kind": "bfloat16"}


def k3(config: dict, ids: int, distinct: int) -> dict:
    """Kernel 3, the sorted-segment sum of the big fields' row gradients:
    the sorted int32 ids and bf16 gradients read, each distinct row's bf16
    sum and id written; one add per gradient element."""
    w = table_width(config)
    return {"bytes": ids * 4 + ids * w * 2 + distinct * (w * 2 + 4), "ops": ids * w,
            "kind": "bfloat16"}


def k4(config: dict, distinct: int, table_bytes: int, optimizer: str) -> dict:
    """Kernel 4, the touched-row apply: each distinct row's id and bf16
    summed gradient read, its table row read and written, its row-wise
    state (adagrad's accumulator) read and written; six f32 operations a
    element."""
    w = table_width(config)
    nbytes = distinct * 4 + distinct * w * 2 + distinct * w * table_bytes * 2
    if optimizer != "sgd":
        nbytes += distinct * 4 * 2
    return {"bytes": nbytes, "ops": distinct * w * 6, "kind": "float32"}


def bound_of(work: dict) -> float:
    return bound_s(work["bytes"], work["ops"], work["kind"])

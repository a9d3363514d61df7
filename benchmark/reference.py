"""The plain reference: CFFM's forward, loss and training step in plain
PyTorch, in float32 with TF32 off.

It follows the model's description (SURVEY.md and the configuration
file), not the port's code, and imports nothing of the port. A model is
the model section of a configuration file (a dict) and a parameter tree
{"embed": {"table"}, "linear": {"bias"}, "conv": [{"w", "b"}],
"tower": [{"w", "b"}]}:

  rows     E[b, f] = table[ids[b, f]], (F, table_width) per example; the
           first-order weight of a row is its column F * d
  cross    M[b, p] = e_{i->j} * e_{j->i} for the pairs i < j in order,
           e_{i->j} = E[b, i, j * d:(j + 1) * d] (field-aware)
  conv     per layer: conv1d with SAME padding ((k - 1) // 2 zeros
           before), + bias, ReLU, max-pool of conv_pool (ragged tail
           dropped); flattened channel-major
  tower    [conv features, dense] -> ReLU layers -> one logit, plus the
           sum of the first-order weights and the bias
  loss     mean binary cross-entropy with logits

Training: dense Adam (optax's order: mu, nu, bias-corrected, eps outside
the root) and row-wise Adagrad on the table (each touched row's summed
gradient g: accum += mean(g^2); row -= lr * g / (sqrt(accum) + eps)).

`low` puts the control in place of the reference: every value the
configuration computes in its compute dtype is rounded to fp8 instead
(e4m3 forward, e5m2 gradients, each tensor scaled to its format's range
first), with the arithmetic in between in f32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def _fp8(x: torch.Tensor, fmt: str) -> torch.Tensor:
    dt, top = _FP8[fmt]
    scale = top / x.detach().abs().amax().clamp(min=1e-30)
    return ((x * scale).to(dt).to(torch.float32) / scale)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, "e5m2")


def rounder(low: bool):
    """The rounding at each compute-dtype point: none, or fp8."""
    return _Fp8.apply if low else (lambda x: x)


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and convolutions, restored afterwards."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def _pairs(f: int, device):
    i, j = torch.triu_indices(f, f, offset=1, device=device)
    return i, j


def logits_from_rows(rows: torch.Tensor, dense_in, net: dict, model: dict, q) -> torch.Tensor:
    """rows (B, F, table_width) f32 -> logits (B,) f32."""
    if model["cross"] != "field_aware":
        raise ValueError("the reference is written for the field-aware cross")
    b, f, _ = rows.shape
    d = model["embed_dim"]
    rw = f * d
    if rows.shape[-1] <= rw:
        raise ValueError("the reference takes tables whose padding holds the first-order column")
    rows = q(rows)
    lin = rows[:, :, rw].sum(dim=1)
    emb = rows[:, :, :rw].reshape(b, f, f, d)
    pi, pj = _pairs(f, rows.device)
    x = q(emb[:, pi, pj, :] * emb[:, pj, pi, :])                       # (B, P, d)
    k = model["conv_kernel"]
    lo = (k - 1) // 2
    for layer in net["conv"]:
        x = q(F.conv1d(F.pad(x, (lo, k - 1 - lo)), q(layer["w"])))
        x = q(torch.relu(q(x + layer["b"][None, :, None])))
        p = model["conv_pool"]
        if p > 1:
            n = x.shape[-1] // p
            x = x[..., : n * p].reshape(*x.shape[:-1], n, p).amax(dim=-1)
    x = x.reshape(b, -1)
    if model["num_dense"]:
        x = torch.cat([x, q(dense_in)], dim=-1)
    layers = net["tower"]
    for i, layer in enumerate(layers):
        x = q(x @ q(layer["w"]) + layer["b"])
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x[:, 0] + lin + net["bias"]


def forward(params: dict, ids: torch.Tensor, dense_in, model: dict, low: bool = False,
            chunk: int = 8192) -> torch.Tensor:
    """Logits (B,) of global ids (B, F), in blocks of `chunk` examples."""
    q = rounder(low)
    table = params["embed"]["table"]
    net = {"conv": params["conv"], "tower": params["tower"], "bias": params["linear"]["bias"]}
    out = []
    with exact_f32(), torch.no_grad():
        for s in range(0, ids.shape[0], chunk):
            rows = table.index_select(0, ids[s:s + chunk].reshape(-1).long()).float()
            rows = rows.reshape(-1, ids.shape[1], table.shape[1])
            dn = None if dense_in is None else dense_in[s:s + chunk].float()
            out.append(logits_from_rows(rows, dn, net, model, q))
    return torch.cat(out)


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed binary cross-entropy with logits."""
    return torch.sum(torch.clamp(logits, min=0.0) - logits * labels
                     + torch.log1p(torch.exp(-torch.abs(logits))))


def dense_leaves(params: dict) -> dict:
    """The dense parameters by name, in a fixed order."""
    out = {}
    for i, layer in enumerate(params["conv"]):
        out[f"conv.{i}.w"], out[f"conv.{i}.b"] = layer["w"], layer["b"]
    for i, layer in enumerate(params["tower"]):
        out[f"tower.{i}.w"], out[f"tower.{i}.b"] = layer["w"], layer["b"]
    out["linear.bias"] = params["linear"]["bias"]
    return out


def train(params: dict, batches, model: dict, optim: dict, low: bool = False,
          chunk: int = 16384, on_step=None) -> dict:
    """Train `params` (updated in place; the table in f32) for one step per
    batch (ids (B, F) global, dense, labels). Returns {"loss": [per step],
    "grad": {leaf: norm of the first step's gradient}, "accum": the
    row-wise accumulator}; on_step(step, params, accum) runs after each
    step."""
    if optim["sparse_optimizer"] != "adagrad" or optim["dense_optimizer"] != "adam":
        raise ValueError("the reference trains row-wise adagrad and dense adam")
    if optim.get("clip_norm", 0) or optim.get("weight_decay", 0) or optim["lr_schedule"] != "constant":
        raise ValueError("the reference has no clip, decay or schedule")
    q = rounder(low)
    table = params["embed"]["table"]
    v, w = table.shape
    accum = torch.full((v, 1), float(optim["adagrad_init"]), device=table.device)
    leaves = dense_leaves(params)
    mu = {k: torch.zeros_like(p) for k, p in leaves.items()}
    nu = {k: torch.zeros_like(p) for k, p in leaves.items()}
    b1, b2, eps = optim["adam_b1"], optim["adam_b2"], optim["eps"]
    out = {"loss": [], "grad": {}}
    with exact_f32():
        for step, (ids, dense_in, labels) in enumerate(batches):
            b, f = ids.shape
            ids = ids.long()
            dgrad = {k: torch.zeros_like(p) for k, p in leaves.items()}
            rgrad = torch.empty((b, f, w), device=table.device)
            loss = 0.0
            for s in range(0, b, chunk):
                lv = {k: p.detach().requires_grad_() for k, p in leaves.items()}
                rows = table.index_select(0, ids[s:s + chunk].reshape(-1)).reshape(-1, f, w)
                rows.requires_grad_()
                net = {"conv": [{"w": lv[f"conv.{i}.w"], "b": lv[f"conv.{i}.b"]}
                                for i in range(len(params["conv"]))],
                       "tower": [{"w": lv[f"tower.{i}.w"], "b": lv[f"tower.{i}.b"]}
                                 for i in range(len(params["tower"]))],
                       "bias": lv["linear.bias"]}
                dn = None if dense_in is None else dense_in[s:s + chunk].float()
                part = bce(logits_from_rows(rows, dn, net, model, q), labels[s:s + chunk]) / b
                grads = torch.autograd.grad(part, list(lv.values()) + [rows])
                for k, g in zip(lv, grads[:-1]):
                    dgrad[k] += g
                rgrad[s:s + chunk] = grads[-1]
                loss += float(part.detach())
            out["loss"].append(loss)
            with torch.no_grad():
                uniq, inv = torch.unique(ids.reshape(-1), return_inverse=True)
                g = torch.zeros((uniq.shape[0], w), device=table.device)
                g.index_add_(0, inv, rgrad.reshape(-1, w))
                del rgrad
                if step == 0:
                    out["grad"] = {k: float(x.norm()) for k, x in dgrad.items()}
                    out["grad"]["embed.table"] = float(g.norm())
                accum[uniq] += torch.mean(g * g, dim=-1, keepdim=True)
                table[uniq] += -optim["sparse_lr"] * g / (torch.sqrt(accum[uniq]) + eps)
                del g
                t = step + 1
                for k, p in leaves.items():
                    mu[k] = (1 - b1) * dgrad[k] + b1 * mu[k]
                    nu[k] = (1 - b2) * dgrad[k] ** 2 + b2 * nu[k]
                    upd = (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t)) + eps)
                    p -= optim["dense_lr"] * upd
            if on_step is not None:
                on_step(step, params, accum)
    out["accum"] = accum
    return out


def probabilities(logits: torch.Tensor, calibration: float = 0.0) -> torch.Tensor:
    return torch.sigmoid(logits + calibration)


def log_downsample(rate: float) -> float:
    """The logit offset that undoes negative downsampling at `rate`."""
    return math.log(rate) if 0.0 < rate < 1.0 else 0.0

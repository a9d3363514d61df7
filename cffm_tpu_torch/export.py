"""Serving export: the scoring function as a `torch.export` artifact.

The port's counterpart of `cffm_tpu/export.py`. A serving process loads
the artifact WITHOUT the model code: `torch.export` traces the scoring
computation (params, ids[, dense]) -> probabilities with a SYMBOLIC
batch dimension, so one artifact serves any batch size.
Params stay call arguments (restored from a checkpoint at serving
init), which keeps the artifact small and the weights swappable.

The graph takes the reference interaction (`forward(...,
interaction_fn=None)`), not the CUDA kernel: scoring is forward-only,
and an artifact without a custom kernel loads without the port's
library, as JAX's artifact carries no Mosaic kernel. JAX lowers one
artifact for the TPU and the CPU at once; a torch trace is for the
device it ran on, so `--platforms` names one device.

Usage:
  python -m cffm_tpu_torch.export --config=<name> --checkpoint_dir=... \\
      --out=/path/model.cffm [--platforms=cuda|cpu]
Serving:
  fn = load_scoring_fn("/path/model.cffm")
  probs = fn(params, ids, dense)   # any batch size
"""

from __future__ import annotations

import io
import json
import sys

import torch

from cffm_tpu_torch import resolve_device
from cffm_tpu_torch.config import TrainConfig
from cffm_tpu_torch.metrics import calibration_offset

_MAGIC = b"CFFM-EXPORT-v1\n"


def scoring_fn(cfg: TrainConfig):
    """(params, ids[, dense]) -> probabilities on the reference path,
    with the negative-downsampling calibration offset baked in: the
    artifact serves the true distribution however the training stream
    was sampled."""
    from cffm_tpu_torch.models.cffm import forward

    mcfg = cfg.model
    cal = calibration_offset(cfg.data)
    if mcfg.num_dense > 0:
        def predict(params, ids, dense):
            return torch.sigmoid(forward(params, ids, dense, mcfg) + cal)
    else:
        def predict(params, ids):
            return torch.sigmoid(forward(params, ids, None, mcfg) + cal)
    return predict


class _Scoring(torch.nn.Module):
    def __init__(self, cfg: TrainConfig):
        super().__init__()
        self.predict = scoring_fn(cfg)

    def forward(self, params, ids, dense=None):
        if dense is None:
            return self.predict(params, ids)
        return self.predict(params, ids, dense)


def export_scoring(cfg: TrainConfig, params, device=None) -> bytes:
    """The scoring computation traced on device with a symbolic batch
    dimension, as `torch.export.save` bytes. The trace runs at batch 8:
    torch.export would pin a batch of 0 or 1 seen while tracing, but the
    program it gives takes a batch of 1 (tests/test_torch_export.py)."""
    from cffm_tpu_torch.score import _to_device

    device = resolve_device(device)
    mcfg = cfg.model
    params = _to_device(params, device)
    ids = torch.zeros((8, mcfg.num_fields), dtype=torch.int32, device=device)
    batch = torch.export.Dim("batch", min=1)
    args = (params, ids)
    shapes = (_static(params), {0: batch})
    if mcfg.num_dense > 0:
        args += (torch.zeros((8, mcfg.num_dense), dtype=torch.float32, device=device),)
        shapes += ({0: batch},)
    with torch.no_grad():
        program = torch.export.export(_Scoring(cfg), args, dynamic_shapes=shapes)
    program.example_inputs = None  # they hold the params: the whole table
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _static(tree):
    """A dynamic_shapes entry that fixes every dimension of tree's leaves."""
    if isinstance(tree, dict):
        return {k: _static(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_static(v) for v in tree]
    return None


def save_artifact(path: str, blob: bytes, cfg: TrainConfig, step=None,
                  device: str = "cuda") -> None:
    """MAGIC + a meta JSON line + the exported program, one file."""
    meta = {
        "config": cfg.name,
        "num_fields": cfg.model.num_fields,
        "num_dense": cfg.model.num_dense,
        "table_dtype": cfg.model.table_dtype,
        "calibration_offset": calibration_offset(cfg.data),
        "step": step,
        "torch": torch.__version__,
        "device": str(device),
    }
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write((json.dumps(meta) + "\n").encode())
        f.write(blob)


def load_artifact(path: str):
    """(meta dict, torch.export.ExportedProgram)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_MAGIC):
        raise ValueError(f"{path}: not a CFFM export artifact")
    rest = data[len(_MAGIC):]
    nl = rest.index(b"\n")
    meta = json.loads(rest[:nl].decode())
    return meta, torch.export.load(io.BytesIO(rest[nl + 1:]))


def load_scoring_fn(path: str):
    """Callable (params, ids[, dense]) -> probabilities."""
    _, program = load_artifact(path)
    return program.module()


def main(argv=None) -> int:
    import argparse

    from cffm_tpu_torch.cli import _apply_override
    from cffm_tpu_torch.config import get_config, list_configs

    ap = argparse.ArgumentParser(prog="cffm_tpu_torch.export")
    ap.add_argument("--config", required=True, help=f"one of {list_configs()}")
    ap.add_argument("--out", required=True, help="artifact output path")
    ap.add_argument("--platforms", default=None,
                    help="the one torch device to trace on (default: cuda)")
    args, rest = ap.parse_known_args(argv)

    if args.platforms is not None and "," in args.platforms:
        raise SystemExit("error: --platforms names one device: a torch trace "
                         "is for the device it ran on")
    cfg = get_config(args.config)
    for item in rest:
        if not item.startswith("--") or "=" not in item:
            raise SystemExit(f"error: unrecognized argument {item!r}")
        dotted, raw = item[2:].split("=", 1)
        cfg = _apply_override(cfg, dotted, raw)

    from cffm_tpu_torch.train import create_state

    device = resolve_device(args.platforms)
    state = create_state(cfg, torch.Generator(device=device).manual_seed(0))
    step = None
    if cfg.checkpoint_dir:
        from cffm_tpu_torch.checkpoint import CheckpointManager

        mgr = CheckpointManager(cfg.checkpoint_dir)
        state, _ = mgr.restore_auto(state, cfg, num_shards=1)
        mgr.close()
        step = state.step

    blob = export_scoring(cfg, state.params, device)
    save_artifact(args.out, blob, cfg, step=step, device=device)
    print(json.dumps({"exported": args.out, "bytes": len(blob),
                      "device": str(device), "step": step}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

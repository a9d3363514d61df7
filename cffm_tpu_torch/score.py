"""Batch scoring (inference) path: checkpoint -> CTR probabilities.

The port's counterpart of `cffm_tpu/score.py`. Restores the params from
a checkpoint (or takes them from the caller), streams the val split,
computes p = sigmoid(forward + calibration offset) per example, folds
the recovered logits into the binned AUC state and optionally writes one
probability per line.

Usage: python -m cffm_tpu_torch.score --config=<name> --checkpoint_dir=...
           [--output=preds.txt] [--num_batches=N] [--platform=cuda|cpu]
"""

from __future__ import annotations

import contextlib
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from cffm_tpu_torch import metrics, resolve_device
from cffm_tpu_torch.config import TrainConfig


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def restore_params(cfg: TrainConfig, device, log_fn=print) -> Dict:
    """The params of the latest checkpoint in cfg.checkpoint_dir on device,
    as one table shard (restore_auto reshards a checkpoint saved by a
    group)."""
    from cffm_tpu_torch.checkpoint import CheckpointManager
    from cffm_tpu_torch.train import create_state

    state = create_state(cfg, torch.Generator(device=device).manual_seed(0))
    mgr = CheckpointManager(cfg.checkpoint_dir)
    state, meta = mgr.restore_auto(state, cfg, num_shards=1)
    mgr.close()
    log_fn(json.dumps({"restored": meta, "step": state.step}))
    return state.params


def score(cfg: TrainConfig, params: Optional[Dict] = None, num_batches: int = 0,
          output: Optional[str] = None, device=None, log_fn=print) -> dict:
    """Returns {"auc", "logloss", "calibration", "count"} over the scored
    stream. params None: restored from cfg.checkpoint_dir. Runs on the
    CUDA device unless device says otherwise; with no CUDA device and no
    device given it raises."""
    from cffm_tpu_torch.data.loader import make_dataset
    from cffm_tpu_torch.models.cffm import forward
    from cffm_tpu_torch.train import batch_to_device, default_interaction_fn

    if params is None and not cfg.checkpoint_dir:
        raise SystemExit("error: --checkpoint_dir is required for scoring")
    device = resolve_device(device)
    if params is None:
        params = restore_params(cfg, device, log_fn)
    params = _to_device(params, device)
    interaction_fn = default_interaction_fn(cfg)
    ds = make_dataset(cfg, split="val")
    # +ln(neg_downsample): undo train-time negative-downsampling odds
    # inflation (0 when not configured)
    cal = metrics.calibration_offset(cfg.data)

    auc_state = metrics.auc_state_init(device=device)
    n = num_batches or cfg.data.eval_batches
    out_cm = open(output, "w") if output else contextlib.nullcontext()
    with out_cm as out_fh, torch.inference_mode():
        for _ in range(n):
            ids, dense, labels = batch_to_device(next(ds), device)
            probs = torch.sigmoid(
                forward(params, ids, dense, cfg.model,
                        interaction_fn=interaction_fn) + cal)
            logits = torch.log(probs) - torch.log1p(-probs)
            auc_state = metrics.auc_state_update(auc_state, logits, labels)
            if out_fh is not None:
                np.savetxt(out_fh, probs.cpu().numpy(), fmt="%.6f")
    result = {k: float(v) for k, v in metrics.auc_state_finalize(auc_state).items()}
    log_fn(json.dumps({"score": result}))
    return result


def main(argv=None):
    import argparse

    from cffm_tpu_torch.cli import _apply_override
    from cffm_tpu_torch.config import get_config, list_configs

    parser = argparse.ArgumentParser(prog="cffm_tpu_torch.score")
    parser.add_argument("--config", required=True, help=f"one of {list_configs()}")
    parser.add_argument("--output", default=None, help="write probabilities here")
    parser.add_argument("--num_batches", type=int, default=0)
    parser.add_argument("--platform", default=None,
                        help="torch device to score on (default: cuda)")
    args, rest = parser.parse_known_args(argv)

    cfg = get_config(args.config)
    for item in rest:
        if not item.startswith("--") or "=" not in item:
            raise SystemExit(f"error: unrecognized argument {item!r}")
        dotted, raw = item[2:].split("=", 1)
        cfg = _apply_override(cfg, dotted, raw)
    score(cfg, num_batches=args.num_batches, output=args.output, device=args.platform)
    return 0


if __name__ == "__main__":
    sys.exit(main())

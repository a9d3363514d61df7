"""Evaluation over a stream of batches, and the default interaction fn.

The port's counterpart of the eval half of `cffm_tpu/train.py`:
`eval_step`, `evaluate` and `default_interaction_fn`. The train state,
train step and run loop arrive with the port's training slice; until
then these take the params dict itself where the JAX package takes a
TrainState.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from cffm_tpu_torch import metrics
from cffm_tpu_torch.config import TrainConfig
from cffm_tpu_torch.models import cffm as model_lib


def params_device(params: Dict) -> torch.device:
    return params["tower"][0]["w"].device


def batch_to_device(batch, device: torch.device):
    """(ids, dense | None, labels) tensors on device from a host batch."""
    def put(a):
        return None if a is None else torch.from_numpy(np.asarray(a)).to(device)

    return put(batch["ids"]), put(batch["dense"]), put(batch["labels"])


@torch.inference_mode()
def eval_step(params: Dict, auc_state, ids: torch.Tensor,
              dense: Optional[torch.Tensor], labels: torch.Tensor,
              cfg: TrainConfig, interaction_fn=None,
              mask: Optional[torch.Tensor] = None):
    logits = model_lib.forward(params, ids, dense, cfg.model,
                               interaction_fn=interaction_fn)
    logits = logits + metrics.calibration_offset(cfg.data)
    return metrics.auc_state_update(auc_state, logits, labels, mask=mask)


def evaluate(params: Dict, batches: Iterable, cfg: TrainConfig,
             interaction_fn=None) -> Dict:
    """Binned AUC, logloss, calibration and count over host batches, on
    the device the params live on."""
    device = params_device(params)
    auc_state = metrics.auc_state_init(device=device)
    for batch in batches:
        ids, dense, labels = batch_to_device(batch, device)
        auc_state = eval_step(params, auc_state, ids, dense, labels, cfg,
                              interaction_fn)
    out = metrics.auc_state_finalize(auc_state)
    return {k: float(v) for k, v in out.items()}


def default_interaction_fn(cfg: TrainConfig):
    """The fused cross+conv1 path when enabled; None -> reference conv."""
    if cfg.model.use_pallas and cfg.model.conv_channels:
        from cffm_tpu_torch.ops.interaction_conv import make_interaction_fn

        return make_interaction_fn(use_kernel=True)
    return None

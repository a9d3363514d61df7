"""Loss and metrics: binary logloss, exact AUC, streaming binned AUC.

The port's counterpart of `cffm_tpu/metrics.py`. The streaming
accumulator is a fixed-size histogram, so partial states from several
workers merge by addition (`auc_state_merge`) before `auc_state_finalize`.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

AUC_NUM_BINS = 8192


def sigmoid_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                            ) -> torch.Tensor:
    """Numerically stable binary cross-entropy with logits, per example."""
    # max(x,0) - x*y + log1p(exp(-|x|))
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def logloss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(sigmoid_bce_with_logits(logits.float(), labels))


def auc_exact(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Exact ROC-AUC via the Mann-Whitney rank-sum statistic, with tied
    scores given their average rank (as sklearn does). NaN when one
    class is absent."""
    scores = scores if scores.dtype == torch.float64 else scores.float()
    labels = labels.float()
    n = scores.shape[0]
    sorted_scores, order = torch.sort(scores, stable=True)
    sorted_labels = labels[order]
    _, group_id, counts = torch.unique_consecutive(
        sorted_scores, return_inverse=True, return_counts=True)
    group_max = torch.cumsum(counts, 0).float()  # 1-based rank of a group's last
    group_min = group_max - counts.float() + 1.0
    avg_rank = (group_min[group_id] + group_max[group_id]) / 2.0
    n_pos = sorted_labels.sum()
    n_neg = n - n_pos
    rank_sum_pos = torch.sum(avg_rank * sorted_labels)
    auc = (rank_sum_pos - n_pos * (n_pos + 1) / 2.0) / torch.clamp(n_pos * n_neg, min=1.0)
    return torch.where((n_pos == 0) | (n_neg == 0),
                       torch.full_like(auc, float("nan")), auc)


def calibration_offset(data_cfg) -> float:
    """Logit offset undoing train-time negative downsampling: ln(r) for a
    keep rate 0 < r < 1, else 0."""
    r = float(getattr(data_cfg, "neg_downsample", 1.0))
    return math.log(r) if 0.0 < r < 1.0 else 0.0


def auc_state_init(num_bins: int = AUC_NUM_BINS, device=None) -> Dict[str, torch.Tensor]:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"pos": zeros(num_bins), "neg": zeros(num_bins), "loss_sum": zeros(),
            "p_sum": zeros(), "count": zeros()}


def auc_state_update(state: Dict[str, torch.Tensor], logits: torch.Tensor,
                     labels: torch.Tensor, mask: torch.Tensor | None = None
                     ) -> Dict[str, torch.Tensor]:
    """Bin sigmoid(logit) into [0,1) histogram buckets per class.

    mask (B,): optional 0/1 example weights; masked examples add nothing
    to the histogram, the loss or the count. Returns a new state."""
    num_bins = state["pos"].shape[0]
    logits = logits.float()
    p = torch.sigmoid(logits)
    idx = torch.clamp((p * num_bins).to(torch.int64), 0, num_bins - 1)
    labels = labels.float()
    m = torch.ones_like(labels) if mask is None else mask.float()
    loss = torch.sum(sigmoid_bce_with_logits(logits, labels) * m)
    return {
        "pos": state["pos"].index_add(0, idx, labels * m),
        "neg": state["neg"].index_add(0, idx, (1.0 - labels) * m),
        "loss_sum": state["loss_sum"] + loss,
        "p_sum": state["p_sum"] + torch.sum(p * m),
        "count": state["count"] + torch.sum(m),
    }


def auc_state_merge(a: Dict, b: Dict) -> Dict:
    return {k: a[k] + b[k] for k in a}


def auc_state_finalize(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Trapezoidal AUC from the class histograms (descending threshold),
    logloss, calibration (mean predicted CTR / observed CTR) and count."""
    tp = torch.cumsum(state["pos"].flip(0), 0)  # high score -> low score
    fp = torch.cumsum(state["neg"].flip(0), 0)
    n_pos, n_neg = tp[-1], fp[-1]
    zero = torch.zeros(1, dtype=tp.dtype, device=tp.device)
    tpr = torch.cat([zero, tp / torch.clamp(n_pos, min=1.0)])
    fpr = torch.cat([zero, fp / torch.clamp(n_neg, min=1.0)])
    auc = torch.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0)
    count = state["count"]
    mean_p = state["p_sum"] / torch.clamp(count, min=1.0)
    ctr = n_pos / torch.clamp(count, min=1.0)
    nan = torch.full_like(auc, float("nan"))
    return {
        "auc": torch.where((n_pos == 0) | (n_neg == 0), nan, auc),
        "logloss": state["loss_sum"] / torch.clamp(count, min=1.0),
        "calibration": torch.where(n_pos > 0, mean_p / torch.clamp(ctr, min=1e-12), nan),
        "count": count,
    }

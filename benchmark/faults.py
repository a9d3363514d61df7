"""Faults planted under the timed path, for the tests and the limits'
fault readings: each wraps a driver's step (`Job.wrap_step`).

Training steps take (state, (ids, dense, labels)) and return (state,
{"loss"}); scoring steps take (ids, dense) and return probabilities.
"""

from __future__ import annotations

import torch


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def unchanged(step):
    """A training step that returns its state unchanged (the loss is real)."""
    def wrapped(state, batch):
        _, m = step(type(state)(*_clone(tuple(state))), batch)
        return state, m
    return wrapped


def half_batch(step):
    """A training step on the first half of the batch, the mean over it."""
    def wrapped(state, batch):
        half = batch[0].shape[0] // 2
        return step(state, tuple(None if x is None else x[:half] for x in batch))
    return wrapped


def doubled_row_grads(step):
    """A training step whose sparse update gets the table's row gradients
    doubled, as from a kernel 2 whose dE, or a kernel 3 whose row sums,
    come out twice as large (planted where the port's step calls the
    sparse update)."""
    from cffm_tpu_torch import train

    def wrapped(state, batch):
        sound = train.rowwise_update

        def doubled(table, opt_state, row_ids, grads, *args, **kwargs):
            return sound(table, opt_state, row_ids, 2 * grads, *args, **kwargs)

        train.rowwise_update = doubled
        try:
            return step(state, batch)
        finally:
            train.rowwise_update = sound
    return wrapped


def altered(score):
    """Scoring that alters one answer of every request where it is produced."""
    def wrapped(ids, dense):
        p = score(ids, dense).clone()
        p[0] = 1.0 - p[0]
        return p
    return wrapped


def half_scored(score):
    """Scoring that leaves the second half of every request unscored."""
    def wrapped(ids, dense):
        half = ids.shape[0] // 2
        p = score(ids[:half], None if dense is None else dense[:half])
        return torch.cat([p, torch.zeros(ids.shape[0] - half, dtype=p.dtype, device=p.device)])
    return wrapped


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "doubled_row_grads": doubled_row_grads, "altered": altered, "half_scored": half_scored}

"""The numbers that decide `correct`, each against its limit.

Training: each leaf's change after the three check steps, the port's
norm against the reference's (the norms' gap, not the norm of the
difference): the median over the leaves the rule below keeps, against
the reference's norm of that leaf or of the median leaf, whichever is
larger; conv.0.w's on its own, on the same measure; the table's and the
row-wise accumulator's each against the reference's norm of its own
change (the table's change is far below the median leaf's: only the
touched rows move). The touched rows' values after the three steps: the
median row's norm of its difference from the reference's over the norm
of the reference's change (a gap of norms barely sees noise in the row
gradients, which this sees at first order). Then the rows that changed
though no id of the three batches touched them, and the touched rows
that did not move. Scoring:
the widest gap between a served probability and the reference's.
"""

from __future__ import annotations

import math
import statistics

# A leaf whose reference gradient is under this share of the median leaf's
# is moved by round-off alone: it is left out of the median change.
NEGLIGIBLE = 1e-3
GRAD_OF = {"embed.accum": "embed.table"}
OWN_NORM = ("embed.table", "embed.accum")


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """Each kept leaf's |norm(prog) - norm(ref)| / max(norm(ref), median)."""
    med = statistics.median(ref[k] for k in keep)
    return {k: _finite(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)) for k in keep}


def moving(ref: dict, grads: dict) -> list:
    """The leaves whose reference gradient is at least NEGLIGIBLE of the
    median leaf's (the row-wise accumulator moves with the table)."""
    med = statistics.median(grads.values())
    return [k for k in ref if grads[GRAD_OF.get(k, k)] >= NEGLIGIBLE * med]


def rows_gap(prog_rows, ref_rows, rows0) -> float:
    """The median over the rows (tensors, one row each) of norm(prog_row -
    ref_row) / norm(ref_row - row0): each row's error at first order, the
    median steady from seed to seed where one norm over all rows follows
    the few hot rows whose summed gradients nearly cancel."""
    gap = (prog_rows - ref_rows).norm(dim=1) / (ref_rows - rows0).norm(dim=1).clamp(min=1e-30)
    return _finite(float(gap.median()))


def train_numbers(prog: dict, ref: dict) -> dict:
    """The numbers a training cell compares."""
    pc, rc = prog["change"], ref["change"]
    change = leaf_gaps(pc, rc, moving(rc, ref["grad"]))
    own = {k: _finite(abs(pc[k] - rc[k]) / max(rc[k], 1e-30)) for k in OWN_NORM}
    return {"change_gap_median": statistics.median(change.values()),
            "conv0_w_change_gap": leaf_gaps(pc, rc, list(rc))["conv.0.w"],
            "table_change_gap": own["embed.table"],
            "accum_change_gap": own["embed.accum"],
            "table_rows_gap": prog["rows_gap"],
            "untouched_rows_changed": float(prog["untouched_changed"]),
            "touched_rows_unmoved": float(prog["touched_unmoved"])}


def train_readings(prog: dict, ref: dict) -> dict:
    """Numbers no limit compares (benchmark/control.py reads them): the
    worst step's loss gap, the worst leaf's first gradient and change."""
    keep = moving(ref["change"], ref["grad"])
    return {"loss_gap": max(_finite(abs(p - r) / abs(r)) for p, r in zip(prog["loss"], ref["loss"])),
            "grad_gap": max(leaf_gaps(prog["grad"], ref["grad"], list(ref["grad"])).values()),
            "change_gap": max(leaf_gaps(prog["change"], ref["change"], keep).values())}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name: each at or under its limit (a number never read fails)."""
    out = {k: {"value": numbers.get(k, math.inf), "limit": v} for k, v in limits.items()}
    return all(c["value"] <= c["limit"] for c in out.values()), out

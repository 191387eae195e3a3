"""The comparison that decides ``correct`` for a training cell.

Both sides give the same readings of their first three steps from the
same weights and rows (``reference.common.train_steps`` for the
reference; the driver for the program): each step's loss, each
parameter's norm of the first gradient as AdamW takes it (clipped), and
each parameter's norm of its change after the three steps.  The numbers:

  loss_gap    the largest |loss_p - loss_r| / |loss_r| of the cell's
              first ``loss_steps`` steps (all of them where it gives none)
  grad_gap    the worst parameter's |norm_p - norm_r| / max(norm_r, the
              median parameter's norm_r), of the first gradient
  change_gap  the same of the change, over the parameters whose
              reference first gradient is at least a thousandth of the
              median parameter's (below that, AdamW moves a parameter by
              rounding alone)

A gap of norms, not the norm of a difference: the two sides round
differently, and what is judged is whether each parameter got the
gradient and moved as far as the reference says.
"""
from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
MOVED = 1e-3
NOT_FINITE = 1e30     # the gap of a reading that is not a finite number


def _gap(p: float, r: float, scale: float) -> float:
    g = abs(p - r) / max(scale, 1e-30)
    return g if math.isfinite(g) else NOT_FINITE


def _worst(prog: dict, ref: dict, names) -> tuple:
    floor = statistics.median(ref[k] for k in names)
    worst, at = 0.0, ""
    for k in names:
        gap = _gap(prog[k], ref[k], max(ref[k], floor))
        if gap > worst:
            worst, at = gap, k
    return worst, at


def gaps(prog: dict, ref: dict, loss_steps=None) -> dict:
    """{number: (value, where)} for the readings of both sides."""
    if set(prog["first_grad"]) != set(ref["first_grad"]):
        raise ValueError("the two sides name different parameters")
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides ran different numbers of steps")
    pairs = list(zip(prog["losses"], ref["losses"]))[:loss_steps]
    loss = max((_gap(p, r, abs(r)), f"step {i + 1}")
               for i, (p, r) in enumerate(pairs))
    names = sorted(ref["first_grad"])
    floor = statistics.median(ref["first_grad"][k] for k in names)
    moved = [k for k in names if ref["first_grad"][k] >= MOVED * floor]
    return {"loss_gap": loss,
            "grad_gap": _worst(prog["first_grad"], ref["first_grad"], names),
            "change_gap": _worst(prog["change"], ref["change"], moved)}


def judge(prog: dict, ref: dict, limits: dict, loss_steps=None) -> tuple:
    """(correct, checks): ``checks`` maps each number to its value, its
    limit and the step or parameter where it was worst."""
    got = gaps(prog, ref, loss_steps)
    checks = {k: {"value": got[k][0], "limit": float(limits[k]),
                  "at": got[k][1]} for k in NUMBERS}
    return all(v["value"] <= v["limit"] for v in checks.values()), checks

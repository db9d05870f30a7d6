"""The comparison that decides ``correct``.

The program's readings after its first steps against the reference's
(``reference/<method>.py::follow``), each number with its limit
(``limits/<workload>.json``):

* ``loss_gap`` - the largest |loss - reference loss| / |reference loss|
  over the checked steps;
* ``grad_gap`` - the worst leaf's gap between the norms of its first
  gradient (with weight decay, as SGD's momentum holds it after step 1),
  |a - b| / max(b, the median leaf's b);
* ``update_gap`` - the same for each leaf's change over the checked
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding moves by round-off alone);
* ``batch_mismatch`` - the values of the batches the program's loader
  fed to the checked steps that differ from the reference's batches
  (limit 0).

A number that is not finite, or a leaf that one side lacks, fails.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

GRAD_FLOOR = 1e-3  # of the median leaf's gradient norm


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[List[str]] = None) -> Tuple[float, str]:
    names = list(ref) if keep is None else keep
    floor = float(np.median([ref[n] for n in ref]))
    worst, leaf = 0.0, ""
    for n in names:
        if n not in prog or not math.isfinite(prog[n]):
            return math.inf, n
        gap = abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30)
        if gap > worst:
            worst, leaf = gap, n
    return worst, leaf


def numbers(prog: dict, ref: dict) -> Dict[str, Tuple[float, str]]:
    """Each compared number (but the batches) with what it was read at."""
    losses = [(abs(a - b) / max(abs(b), 1e-30), f"step {k + 1}")
              for k, (a, b) in enumerate(zip(prog["losses"], ref["losses"]))]
    if len(prog["losses"]) != len(ref["losses"]) or any(
            not math.isfinite(a) for a in prog["losses"]):
        losses.append((math.inf, "losses"))
    out = {"loss_gap": max(losses)}
    out["grad_gap"] = worst_leaf(prog["grad_norms"], ref["grad_norms"])
    gmed = float(np.median(list(ref["grad_norms"].values())))
    moving = [n for n, g in ref["grad_norms"].items()
              if g >= GRAD_FLOOR * gmed]
    out["update_gap"] = worst_leaf(prog["update_norms"], ref["update_norms"],
                                   moving)
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {value, limit}}) over the numbers ``limits``
    names; a number missing from ``values`` fails."""
    report, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name, math.inf)
        good = math.isfinite(v) and v <= limit
        ok = ok and good
        report[name] = {"value": v if math.isfinite(v) else str(v),
                        "limit": limit}
    return ok, report

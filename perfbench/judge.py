"""The comparisons that decide ``correct``, each number beside its limit.

Training: the program's loss at the first step, each leaf's norm of
the first step's clipped gradient (read from the optimizer's first
moment after one step, m = (1 - b1) g), and each leaf's norm of its
change over the checked steps, against the reference's.  A leaf's gap
is |program - reference| over the larger of the reference's norm of
that leaf and of the median leaf; the worst leaf is compared.  Leaves
whose reference gradient is under a thousandth of the median leaf's
(nought to rounding) are left out of the change.

Serving: the widest gap by which a served token's reference logit lies
below the reference's best at that position.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

NEGLIGIBLE = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: Sequence[str]) -> Dict[str, float]:
    floor = statistics.median(ref[n] for n in ref)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30)
            for n in names}


def moving(ref: Dict) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding."""
    g = ref["first_grad"]
    floor = statistics.median(g.values())
    return [n for n in g if g[n] >= NEGLIGIBLE * floor]


def loss_gaps(prog: Dict, ref: Dict) -> List[float]:
    return [abs(p - r) / abs(r)
            for p, r in zip(prog["losses"], ref["losses"])]


def training(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog``/``ref``: {"losses": [..], "first_grad": {leaf: norm},
    "change": {leaf: norm}}."""
    grads = leaf_gaps(prog["first_grad"], ref["first_grad"],
                      list(ref["first_grad"]))
    change = leaf_gaps(prog["change"], ref["change"], moving(ref))
    return {"loss_gap": loss_gaps(prog, ref)[0],
            "grad_gap": max(grads.values(), default=0.0),
            "change_gap": max(change.values(), default=0.0)}


def training_detail(prog: Dict, ref: Dict) -> Dict:
    """Every step's loss gap and the three worst leaves of each norm."""
    worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:3]
    return {"loss_gaps": loss_gaps(prog, ref),
            "grad_worst": worst(leaf_gaps(prog["first_grad"],
                                          ref["first_grad"],
                                          list(ref["first_grad"]))),
            "change_worst": worst(leaf_gaps(prog["change"], ref["change"],
                                            moving(ref)))}


def serving(gaps: List[float]) -> Dict[str, float]:
    return {"logit_gap": max(gaps)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {"value", "limit", "ok"}} for every limited number."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading of {sorted(missing)}")
    return {n: {"value": numbers[n], "limit": limits[n],
                "ok": bool(numbers[n] <= limits[n])} for n in limits}

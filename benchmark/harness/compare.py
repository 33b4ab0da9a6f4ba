"""The numbers that decide `correct`, each held against its limit.

Training (the program's first steps against the reference's); the
cell's `limits` name those that decide, the rest are reported:

- `loss_gap`: the widest gap of a step's loss, |program - reference| /
  |reference|, over the compared steps;
- `grad_gap`: by the worst leaf, |program norm - reference norm| of the
  first gradient (the program's worked out from its optimizer's first
  moment after one step), over the larger of the reference's norm of
  that leaf and of the median leaf;
- `change_median_gap`: the median leaf's gap of the change;
- `grad_diff_gap`: the median leaf's norm of the difference of the two
  first gradients, over the larger of the reference's norm of that leaf
  and of the median leaf;
- `head_grad_gap`: |program - reference| of the first gradient of the
  configuration's `head_leaves` (the output layer, after the last
  operation that selects among its inputs, such as a max over the
  sequence), over the reference's norm;
- `change_gap`: the same of each leaf's change after the third step,
  over the leaf's elements whose first gradient in the reference is at
  least a thousandth of the median leaf's root-mean-square gradient
  (round-off alone moves the others under Adam, as it does a key's bias
  under softmax; benchmark/reference/steps.py).

Serving, over the sampled requests' logits:

- `logit_gap`: the widest |served - reference| logit over the largest
  |reference| logit;
- `logit_spread_gap`: the root-mean-square of served - reference over
  the reference's spread across the rows (the root-mean-square over
  classes of each class's standard deviation over rows).  Not over the
  logits' own size, which a seed's output layer can all but cancel
  while the error stays (`reference_rms` beside it).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional, Sequence, Tuple


def loss_gap(program, reference) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    names = sorted(reference if keep is None else keep)
    median = statistics.median(reference[k] for k in names)
    worst, leaf = -1.0, ""
    for k in names:
        gap = abs(program[k] - reference[k]) / max(reference[k], median)
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def training(program: dict, reference: dict,
             head: Sequence[str] = ()) -> Dict[str, dict]:
    """Every number the comparison can hold; `reference` from
    `steps.train_steps`, given the program's first gradient and change
    (`other_*` there are the program's).  The cell's `limits` name the
    numbers that are held."""
    grad, grad_leaf = leaf_gap(reference["other_first_grad"],
                               reference["first_grad"])
    change, change_leaf = leaf_gap(reference["other_change"],
                                   reference["change"])
    numbers = {
        "loss_gap": {"value": loss_gap(program["losses"],
                                       reference["losses"])},
        "grad_gap": {"value": grad, "leaf": grad_leaf},
        "grad_diff_gap": {"value": diff_median(reference["first_grad_diff"],
                                               reference["first_grad"])},
        "change_gap": {"value": change, "leaf": change_leaf,
                       "elements_left_out": reference["elements_left_out"]},
        "change_median_gap": {"value": median_gap(reference["other_change"],
                                                  reference["change"])},
    }
    if head:
        numbers["head_grad_gap"] = {"value": math.sqrt(
            sum(reference["first_grad_diff"][k] ** 2 for k in head)
            / sum(reference["first_grad"][k] ** 2 for k in head))}
    return numbers


def diff_median(diff: Dict[str, float], reference: Dict[str, float]):
    """The median over leaves of |program - reference| of each leaf's
    first gradient over the larger of its reference norm and the median
    leaf's."""
    median = statistics.median(reference.values())
    return statistics.median(diff[k] / max(reference[k], median)
                             for k in reference)


def median_gap(program: Dict[str, float], reference: Dict[str, float]):
    """The median over leaves of each leaf's gap (as `leaf_gap` takes
    it)."""
    median = statistics.median(reference.values())
    return statistics.median(
        abs(program[k] - reference[k]) / max(reference[k], median)
        for k in reference)


def serving(served, reference) -> Dict[str, dict]:
    """served, reference: (rows, classes) float tensors."""
    served, reference = served.float(), reference.float()
    diff = served - reference
    scale = float(reference.abs().max())
    rms = float(reference.square().mean().sqrt())
    spread = float(reference.var(dim=0, unbiased=False).mean().sqrt())
    gap = float(diff.square().mean().sqrt())
    return {"logit_gap": {"value": float(diff.abs().max()) / scale
                          if scale else float("inf")},
            "logit_spread_gap": {"value": gap / spread if spread
                                 else float("inf"),
                                 "reference_rms": rms,
                                 "reference_spread": spread}}


def judge(numbers: Dict[str, dict], limits: Dict[str, float]):
    """(correct, checks): every number the cell's `limits` name within
    its limit; `checks` holds those numbers beside their limits.  A
    limit whose number is missing fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, {}).get("value", float("inf"))
        checks[name] = {"value": value, "limit": limit}
        if not value <= limit:
            ok = False
    return ok, checks

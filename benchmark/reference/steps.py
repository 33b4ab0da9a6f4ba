"""What the reference works out for a comparison: its training steps
(losses, the first gradient and the parameters' change by leaf) and its
served logits, from the same seed-made weights and inputs the program
was given.  Runs in blocks of rows, so that float32 activations of a
full-width model fit beside nothing else on the card."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

from benchmark.reference import optim
from benchmark.reference.precision import Precision


def _blocks(features: dict, labels, rows: int):
    total = int(labels.shape[0])
    for lo in range(0, total, rows):
        yield ({k: v[lo:lo + rows] for k, v in features.items()},
               labels[lo:lo + rows])


def loss_and_grads(model, P: Dict[str, torch.Tensor], batch: dict,
                   cfg: dict, prec: Precision):
    """The batch's mean loss and every parameter's gradient, summed over
    blocks of rows."""
    features, labels = batch["features"], batch["labels"]
    total = int(labels.shape[0])
    for p in P.values():
        p.grad = None
    loss = 0.0
    for feats, labs in _blocks(features, labels, model.block_rows(features)):
        part = model.loss_sum(model.forward(P, feats, cfg, prec), labs) / total
        part.backward()
        loss += float(part.detach())
    return loss, {k: p.grad for k, p in P.items()}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.detach().float()))
            for k, t in tensors.items()}


# an element whose first gradient in the reference is under this share
# of the median leaf's root-mean-square gradient is left out of the
# change: Adam moves it by round-off (a key's bias under softmax)
NOUGHT_GRADIENT = 1e-3


def train_steps(model, cfg: dict, weights: Dict[str, torch.Tensor],
                batches: Sequence[dict], prec: Precision,
                change_after: int, other_change: Dict[str, torch.Tensor],
                other_first_grad: Dict[str, torch.Tensor] = None,
                keep_change: bool = False) -> dict:
    """len(batches) steps from `weights` (left as they are): each step's
    loss, each leaf's norm of the first gradient, and each leaf's norm of
    the change after `change_after` steps, over the elements whose first
    gradient is not nought to round-off, for the reference and for
    `other_change` (another run's change of each leaf, on the host; None
    for none); with `other_first_grad` (that run's first gradient), each
    leaf's norm of that gradient and of its difference from this one's.
    `keep_change` adds this run's change and first gradient of each leaf,
    on the host, as `change_tensors` and `first_grad_tensors`."""
    P = {k: v.detach().clone().requires_grad_(True)
         for k, v in weights.items()}
    opt = optim.from_config(P, cfg["optimizer"])
    losses: List[float] = []
    first_grad = change = other = None
    kept, other_grad, grad_diff, grad_tensors = {}, {}, {}, {}
    for step, batch in enumerate(batches, 1):
        loss, grads = loss_and_grads(model, P, batch, cfg, prec)
        losses.append(loss)
        if step == 1:
            first_grad = norms(grads)
            if keep_change:
                grad_tensors = {k: g.detach().cpu() for k, g in grads.items()}
            if other_first_grad is not None:
                for k, g in grads.items():
                    theirs = other_first_grad[k].to(g.device)
                    other_grad[k] = float(torch.linalg.vector_norm(theirs))
                    grad_diff[k] = float(torch.linalg.vector_norm(
                        theirs - g.detach()))
            rms = statistics.median(
                first_grad[k] / math.sqrt(grads[k].numel()) for k in grads)
            kept = {k: g.detach().abs() >= NOUGHT_GRADIENT * rms
                    for k, g in grads.items()}
        opt.step(grads)
        if step == change_after:
            change, other, tensors = {}, {}, {}
            for k, mask in kept.items():
                delta = P[k].detach() - weights[k]
                if keep_change:
                    tensors[k] = delta.cpu()
                if not bool(mask.any()):
                    continue
                change[k] = float(torch.linalg.vector_norm(delta[mask]))
                if other_change is not None:
                    other[k] = float(torch.linalg.vector_norm(
                        other_change[k].to(mask.device)[mask]))
    left_out = sum(int((~m).sum()) for m in kept.values())
    del P, opt, kept
    out = {"losses": losses, "first_grad": first_grad, "change": change,
           "other_change": other, "elements_left_out": left_out,
           "other_first_grad": other_grad, "first_grad_diff": grad_diff}
    if keep_change:
        out["change_tensors"] = tensors
        out["first_grad_tensors"] = grad_tensors
    return out


@torch.no_grad()
def logits(model, cfg: dict, weights: Dict[str, torch.Tensor],
           features: dict, prec: Precision) -> torch.Tensor:
    """float32 logits of every row, in blocks."""
    rows = model.block_rows(features)
    total = int(next(iter(features.values())).shape[0])
    out = []
    for lo in range(0, total, rows):
        out.append(model.forward(
            weights, {k: v[lo:lo + rows] for k, v in features.items()},
            cfg, prec).float())
    return torch.cat(out)

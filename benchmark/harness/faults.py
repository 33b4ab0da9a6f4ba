"""Faults planted under the timed path, for the check that `correct`
catches them (benchmark/control.py on the card, benchmark/tests on the
CPU).  Each is an entry's `hooks["program"]` callback: it breaks the
program object it is handed, not the harness.

- `unchanged`: the optimizer's step does nothing, so a step returns the
  state as it found it;
- `half_batch`: the loss is the mean over the first half of the batch's
  rows, the rest left out;
- `first_batch_only`: a call of K steps trains its first batch alone,
  one step, and skips the rest;
- `stale_batches`: a call of K steps trains K times on its first batch,
  the other batches' inputs left stale;
- `altered_answer`: each served batch's first row comes back with its
  first logit one higher.
"""

from __future__ import annotations


def unchanged(trainer=None, state=None, **_):
    state.optimizer.step = lambda *args, **kwargs: None


def half_batch(trainer=None, state=None, **_):
    inner = trainer.loss_fn

    def loss(labels, predictions):
        half = labels.shape[0] // 2
        return inner(labels[:half], predictions[:half])

    trainer.loss_fn = loss


def first_batch_only(trainer=None, state=None, **_):
    inner = trainer.train_on_batch_stack

    def stack(state_, batches):
        return inner(state_, list(batches)[:1])

    trainer.train_on_batch_stack = stack


def stale_batches(trainer=None, state=None, **_):
    inner = trainer.train_on_batch_stack

    def stack(state_, batches):
        batches = list(batches)
        return inner(state_, batches[:1] * len(batches))

    trainer.train_on_batch_stack = stack


def altered_answer(engine=None, **_):
    inner = engine.predict

    def predict(features, rows, phase_out=None):
        out, step = inner(features, rows, phase_out=phase_out)
        out = out.copy()
        out[0, 0] += 1.0
        return out, step

    engine.predict = predict


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "first_batch_only": first_batch_only,
          "stale_batches": stale_batches, "altered_answer": altered_answer}


def hooks(name: str) -> dict:
    return {"program": FAULTS[name]}

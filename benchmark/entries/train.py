"""The `train` entry: the port's Trainer stepping a zoo model on a pool
of seed-made batches.

Set-up builds one `Trainer` and one state, loads the seed-made weights
into it, and drives it through its first calls in the cell's own call
shape, K batches a call, on distinct batches, each staged by
`Trainer.stage_batch` and trained by `Trainer.train_on_batch_stack`:
the first call runs eagerly, the second captures the K steps' CUDA
graph, the third replays it, as every call of the window does.  Their
losses, the first gradient (from the optimizer's first moment after its
first step) and each parameter's change after the three calls are the
program's side of the comparison.  Set-up then replays the call twice
more, and the window calls it on the pool's batches, round and round,
for `--seconds`.  The same state trains throughout.

After the window: the peak memory is read, the program is freed, and
the reference (benchmark/reference/) repeats the first 3 K steps in
float32 from the same weights and batches.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark.harness import compare, inputs, spec
from benchmark.harness.record import PROCESS_START, Record
from benchmark.harness.trace import Profiler
from benchmark.harness.weights import make_weights
from benchmark.reference import steps as ref_steps
from benchmark.reference.precision import REFERENCE, no_tf32

# calls compared: eager, capture, replay
CHECK_CALLS = 3


def model_params(params: dict) -> str:
    """The zoo's `--model_params` string for a configuration's dict."""
    return ";".join(f"{k}={v!r}" for k, v in params.items())


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_batch(batch: dict, device) -> dict:
    import torch
    return {"features": {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device) for k, v in batch["features"].items()},
        "labels": torch.from_numpy(np.ascontiguousarray(
            batch["labels"])).to(device)}


def build_trainer(cell, device):
    import torch
    from elasticdl_tpu_torch.common import model_handler
    from elasticdl_tpu_torch.worker.trainer import Trainer

    cfg = cell.config
    # the zoo's template is built on the device: a 2^25-row table is
    # not drawn on the host
    with torch.device(device):
        mspec = model_handler.get_model_spec(
            model_handler.ZOO_DIR, cfg["model_def"],
            model_params=model_params(cfg["model_params"]))
    return Trainer(mspec.model, mspec.optimizer, mspec.loss,
                   use_bf16=cfg["use_bf16"], device=device)


def first_gradient(state, beta1: float) -> dict:
    """Each parameter's first gradient as Adam holds it after its first
    step, on the host: its first moment over (1 - beta1).  Zeros for
    every parameter until that step has run: the hook set here reads
    the moments once, after the optimizer's first step, and removes
    itself (a K-step call runs K steps before it returns)."""
    import torch
    out = {name: torch.zeros(p.shape)
           for name, p in state.model.named_parameters()}

    def read(optimizer, args, kwargs):
        handle.remove()
        for name, p in state.model.named_parameters():
            m = optimizer.state.get(p, {}).get("exp_avg")
            if m is not None:
                out[name] = (m.float() / (1 - beta1)).cpu()

    handle = state.optimizer.register_step_post_hook(read)
    return out


def change(state, initial: dict) -> dict:
    """Each parameter's change from `initial`, on the host."""
    import torch
    with torch.no_grad():
        return {name: (p.detach() - initial[name]).float().cpu()
                for name, p in state.model.named_parameters()}


def optimizer_profile(call, nxt: int, k: int, pool, device) -> dict:
    """The optimizer's device seconds a step, from one more call after
    the window, run eagerly under the profiler: a graph's replay runs no
    Python, so its kernels carry no annotation, and the eager call runs
    the same kernels inside the optimizer's own `Optimizer.step` range.
    Empty where the trace has no such range."""
    from elasticdl_tpu_torch.worker import graphs as graphs_lib

    sync(device)
    prof = Profiler(device.type)
    prof.start()
    with graphs_lib.eager_loop():
        call([j % len(pool) for j in range(nxt, nxt + k)])
    sync(device)
    seconds, steps = prof.stop().seconds_within("Optimizer.step")
    return {"optimizer_s_per_step": seconds / steps} if steps else {}


def run(cell, seed: int, seconds: float, trace: bool, device,
        hooks=None) -> Record:
    import torch

    ref_model, cost_model = spec.model_modules(cell)
    cfg, traffic = cell.config, cell.traffic
    rec = Record(cell=cell, seed=seed, seconds=seconds, trace=trace,
                 device=device)
    k, rows = int(traffic["steps_per_call"]), int(traffic["batch"])
    beta1 = float(cfg["optimizer"]["betas"][0])

    trainer = build_trainer(cell, device)
    pool = inputs.training_pool(cfg, traffic, seed, device)
    weights = make_weights(ref_model.param_spec(cfg), seed, device)
    sample = {n: v[:1] for n, v in pool[0]["features"].items()}
    state = trainer.init_state(inputs.derive(seed, "init"), sample)
    with torch.no_grad():
        state.model.load_state_dict(weights, strict=True)
    del weights
    if hooks and "program" in hooks:
        hooks["program"](trainer=trainer, state=state)

    def call(indices):
        staged = []
        for i in indices:
            with rec.spans.span("stage"):
                staged.append(trainer.stage_batch(pool[i % len(pool)]))
        with rec.spans.span("train_call"):
            return trainer.train_on_batch_stack(state, staged)[1]

    # the program's side of the comparison, in the window's call shape
    first_grad = first_gradient(state, beta1)
    program = {"losses": []}
    compared = CHECK_CALLS * k
    for c in range(CHECK_CALLS):
        program["losses"] += [float(x) for x in
                              call(range(c * k, (c + 1) * k))]
    program["change"] = change(
        state, make_weights(ref_model.param_spec(cfg), seed, device))
    nxt = compared
    for _ in range(2):
        call(range(nxt, nxt + k))
        nxt += k
    sync(device)
    rec.setup_s = time.perf_counter() - PROCESS_START[0]

    # the window
    losses = []
    calls = 0
    prof = None
    slice_from = seconds - min(float(traffic.get("trace_slice_s", 2.0)),
                               seconds)
    slice_calls = 0
    slice_batches = []
    slice_t0 = 0.0
    t0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
        if trace and prof is None and elapsed >= slice_from:
            sync(device)
            prof = Profiler(device.type)
            prof.start()
            slice_t0 = time.perf_counter()
            slice_calls = calls
        indices = [j % len(pool) for j in range(nxt, nxt + k)]
        nxt += k
        losses.append(call(indices))
        calls += 1
        if prof is not None:
            slice_batches += indices
    sync(device)
    t1 = time.perf_counter()
    rec.window_s = t1 - t0
    rec.attempted = calls
    rec.examples = calls * k * rows
    if losses:
        finite = torch.isfinite(torch.stack(losses)).all(dim=1)
        rec.failed = int((~finite).sum())
    if prof is not None:
        rec.profile = prof.stop(rec.spans)
        rec.slice_s = t1 - slice_t0
        rec.slice_examples = (calls - slice_calls) * k * rows
        rec.counts.update(optimizer_profile(call, nxt, k, pool, device))
    if device.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))

    # counts the readers need, from the shapes and the data
    rec.counts["flops_per_example"] = cost_model.train_flops_per_example(
        cfg, device_batch(pool[0], device)["features"])
    rec.counts["params"] = float(cost_model.param_count(cfg))
    rec.counts["steps_in_slice"] = float(len(slice_batches))
    calls_by_batch = {}
    for i in slice_batches:
        if i not in calls_by_batch:
            calls_by_batch[i] = cost_model.train_kernel_calls(
                cfg, device_batch(pool[i], device)["features"])
        for kernel, kw in calls_by_batch[i].items():
            rec.kernel_calls.setdefault(kernel, []).extend(kw)

    # free the program, then the reference
    del state, trainer, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    no_tf32()
    weights = make_weights(ref_model.param_spec(cfg), seed, device)
    reference = ref_steps.train_steps(
        ref_model, cfg, weights,
        [device_batch(pool[i % len(pool)], device) for i in range(compared)],
        REFERENCE, change_after=compared,
        other_change=program.pop("change"), other_first_grad=first_grad)
    rec.numbers = compare.training(program, reference,
                                  cfg.get("head_leaves", ()))
    ok, rec.checks = compare.judge(rec.numbers, cell.limits)
    rec.correct = ok and rec.failed == 0
    rec.notes["program_losses"] = program["losses"]
    rec.notes["reference_losses"] = reference["losses"]
    return rec

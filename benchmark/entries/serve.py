"""The `serve` entry: an open loop of requests into the port's
`DynamicBatcher` over a `ServingEngine`, in process, as `serve` builds
them.

Set-up loads the seed-made weights into an engine over the zoo model
(its warm-up runs and captures each bucket's forward), builds the
batcher with the traffic's batching deadline, makes the schedule and
every request's rows, and sends one request through the batcher.  The
window sends each request at its due time, whatever the state of
earlier ones (an open loop), and then waits for every answer, a minute
past the close at most.  A request's latency runs from its due time to
its answer; a request that fails or never comes counts in `failed` and
in the latencies as lasting until the wait ended.

After the window: the peak memory is read, a sample of the answered
requests drawn from the seed (the longest among them, and requests
served at each bucket the traffic reached) is kept, the program is
freed, and the reference computes those rows' logits in float32.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np

from benchmark.entries.train import model_params, sync
from benchmark.harness import compare, inputs, spec
from benchmark.harness.record import PROCESS_START, Record
from benchmark.harness.trace import Profiler
from benchmark.harness.weights import make_weights
from benchmark.reference import steps as ref_steps
from benchmark.reference.precision import REFERENCE, no_tf32

# tokens of a row's start that identify it across the batcher
FINGERPRINT = 8
ANSWER_WAIT_S = 60.0
SPIN_S = 0.0002


def build_engine(cell, weights, device):
    import torch
    from elasticdl_tpu_torch.common import model_handler
    from elasticdl_tpu_torch.serving.engine import ServingEngine

    cfg, traffic = cell.config, cell.traffic
    with torch.device(device):
        mspec = model_handler.get_model_spec(
            model_handler.ZOO_DIR, cfg["model_def"],
            model_params=model_params(cfg["model_params"]))
    features = {name: {"shape": list(f["shape"]), "dtype": f["dtype"]}
                for name, f in sorted(traffic["features"].items())}
    return ServingEngine(mspec.model, weights, step=0,
                         feature_spec=features,
                         buckets=tuple(traffic["buckets"]), device=device)


class _Spy:
    """Wraps the engine's predict: records each batch's rows, bucket,
    host interval and its rows' fingerprints."""

    def __init__(self, engine, spans, key: str):
        self.engine = engine
        self.inner = engine.predict
        self.spans = spans
        self.key = key
        self.calls = []

    def predict(self, features, rows, phase_out=None):
        start = time.perf_counter()
        with self.spans.span("engine_predict"):
            out = self.inner(features, rows, phase_out=phase_out)
        ids = np.asarray(features[self.key])[:rows, :FINGERPRINT]
        self.calls.append((start, time.perf_counter(), rows,
                           self.engine.bucket_for(rows), ids.copy()))
        return out


def run(cell, seed: int, seconds: float, trace: bool, device,
        hooks=None) -> Record:
    import torch
    from elasticdl_tpu_torch.serving.batcher import OK, DynamicBatcher

    ref_model, cost_model = spec.model_modules(cell)
    cfg, traffic = cell.config, cell.traffic
    rec = Record(cell=cell, seed=seed, seconds=seconds, trace=trace,
                 device=device)
    key = sorted(traffic["features"])[0]

    weights = make_weights(ref_model.param_spec(cfg), seed, device)
    engine = build_engine(cell, weights, device)
    del weights
    if hooks and "program" in hooks:
        hooks["program"](engine=engine)
    spy = _Spy(engine, rec.spans, key)
    engine.predict = spy.predict
    batcher = DynamicBatcher(
        engine, max_latency_s=float(traffic["max_batch_latency_ms"]) / 1e3)

    due, sizes = inputs.schedule(traffic, seed, seconds)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    feats = inputs.request_features(cfg, traffic, seed, int(starts[-1]),
                                    device)
    warm = batcher.submit({n: v[:1] for n, v in feats.items()})
    if warm.result(timeout=ANSWER_WAIT_S).code != OK:
        raise RuntimeError("the warm-up request failed")
    spy.calls.clear()
    snap0 = batcher.metrics.snapshot()
    sync(device)
    rec.setup_s = time.perf_counter() - PROCESS_START[0]

    n = len(due)
    done_at = [None] * n
    futures = [None] * n
    sent_at = np.zeros(n)
    remaining = [n]
    lock = threading.Lock()
    all_done = threading.Event()

    def finished(i):
        def cb(_future):
            done_at[i] = time.perf_counter()
            with lock:
                remaining[0] -= 1
                if remaining[0] == 0:
                    all_done.set()
        return cb

    prof = None
    slice_from = seconds - min(float(traffic.get("trace_slice_s", 3.0)),
                               seconds)
    t0 = time.perf_counter()
    for i in range(n):
        target = t0 + due[i]
        if trace and prof is None and due[i] >= slice_from:
            prof = Profiler(device.type)
            prof.start()
        wait = target - time.perf_counter()
        if wait > SPIN_S:
            time.sleep(wait - SPIN_S)
        while time.perf_counter() < target:
            pass
        sent_at[i] = time.perf_counter()
        with rec.spans.span("submit"):
            fut = batcher.submit(
                {k: v[starts[i]:starts[i + 1]] for k, v in feats.items()},
                request_id=str(i))
        futures[i] = fut
        fut.add_done_callback(finished(i))
    closed = t0 + seconds
    all_done.wait(timeout=max(0.0, closed + ANSWER_WAIT_S
                              - time.perf_counter()))
    ended = time.perf_counter()
    if prof is not None:
        rec.profile = prof.stop(rec.spans)
    rec.window_s = ended - t0
    if device.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))

    # answers
    answered = {}
    never = 0
    for i, fut in enumerate(futures):
        result = fut.result(timeout=0) if fut.done() else None
        due_abs = t0 + due[i]
        rec.late_s.append(sent_at[i] - due_abs)
        if result is not None and result.code == OK:
            rec.latency_s.append(done_at[i] - due_abs)
            rec.queue_wait_s.append((result.phases_s or {}).get(
                "queue_wait", 0.0))
            answered[i] = result.predictions
        else:
            # refused or never answered: it lasted until the wait ended
            rec.failed += 1
            never += result is None
            rec.latency_s.append(ended - due_abs)
    rec.attempted = n
    rec.notes["never_answered"] = never
    snap1 = batcher.metrics.snapshot()
    batches = snap1["batches"] - snap0["batches"]
    rec.batcher = {
        "batches": batches,
        "rows": snap1["ok_rows"] - snap0["ok_rows"],
        "fill": ((snap1["batch_fill_ratio"] * snap1["batches"]
                  - snap0["batch_fill_ratio"] * snap0["batches"]) / batches
                 if batches else 0.0),
        "shed": snap1["shed"] - snap0["shed"],
    }
    batcher.shutdown(timeout=ANSWER_WAIT_S)

    # counts for the readers: the slice's forwards and their rows
    seq_len = int(traffic["features"][key]["shape"][0])
    rec.counts["flops_per_row"] = cost_model.serve_flops_per_row(
        cfg, {key: torch.zeros((1, seq_len), dtype=torch.int32)})
    if rec.profile is not None:
        inside = [c for c in spy.calls if c[0] >= rec.profile.host_start
                  and c[1] <= rec.profile.host_end]
        rec.counts["slice_rows"] = float(sum(c[2] for c in inside))
        for c in inside:
            for kernel, kw in cost_model.serve_kernel_calls(
                    cfg, c[3], seq_len).items():
                rec.kernel_calls.setdefault(kernel, []).extend(kw)

    # the sample: the longest answered request and, for each bucket the
    # traffic reached, requests served in it
    bucket_of = {}
    for _s, _e, rows, bucket, ids in spy.calls:
        for row in ids:
            bucket_of[row.tobytes()] = bucket
    by_bucket = {}
    for i in answered:
        fp = feats[key][starts[i], :FINGERPRINT].tobytes()
        by_bucket.setdefault(bucket_of.get(fp), []).append(i)
    rng = np.random.default_rng(inputs.derive(seed, "sample"))
    per_bucket = int(traffic["sample_per_bucket"])
    sample = set()
    if answered:
        sample.add(max(answered, key=lambda i: (sizes[i], -i)))
    for bucket, ids in sorted(by_bucket.items(),
                              key=lambda kv: (kv[0] is None, kv[0] or 0)):
        pick = rng.choice(len(ids), size=min(per_bucket, len(ids)),
                          replace=False)
        sample.update(ids[j] for j in pick)
    sample = sorted(sample)
    rec.notes["buckets_reached"] = sorted(b for b in by_bucket
                                          if b is not None)
    rec.notes["sample_requests"] = len(sample)

    del engine, batcher, spy
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not sample:
        rec.numbers = {}
        rec.correct, rec.checks = compare.judge(rec.numbers, cell.limits)
        return rec
    no_tf32()
    rows_idx = np.concatenate([np.arange(starts[i], starts[i + 1])
                               for i in sample])
    served = torch.from_numpy(np.concatenate([answered[i] for i in sample]))
    weights = make_weights(ref_model.param_spec(cfg), seed, device)
    reference = ref_steps.logits(
        ref_model, cfg, weights,
        {k: torch.from_numpy(np.ascontiguousarray(v[rows_idx])).to(device)
         for k, v in feats.items()}, REFERENCE).cpu()
    rec.notes["sample_rows"] = int(len(rows_idx))
    rec.numbers = compare.serving(served, reference)
    # an answer that never came is for `correct`; a refusal is counted
    # in `failed` and in the latencies
    ok, rec.checks = compare.judge(rec.numbers, cell.limits)
    rec.correct = ok and never == 0
    return rec

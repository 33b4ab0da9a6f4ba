#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`elasticdl_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; builds every kernel in `elasticdl_tpu_torch/csrc/` with
   nvcc, one process per source, and prints the build time.
2. Holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes and a short ragged one, and times the kernel,
   the plain version and the library call that computes the same
   function (`library_ms`, a yardstick the port never calls).
3. Serves BERT-base (hidden 768, 12 layers, 12 heads, MLP 3072, vocab
   8192, L=512, bf16, random weights from a seed) through ServingEngine
   + DynamicBatcher with buckets (1, 4, 16, 64): seeded requests of 1-64
   rows from several client threads.  Every result must be OK, finite
   and of shape (rows, 2), and the kernel launch counts must show that
   every layer of every executed batch went through the kernels.  One
   4-row batch is checked in f32 against the same weights on the CPU
   (the plain path).

Exits non-zero on any failure; nothing is caught.  Without CUDA it exits
1 before printing any result.  The line before the last is the `kernels`
JSON; the last is {"ok": true, "device": {...}}.  The measured numbers
also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from elasticdl_tpu_torch.common.export import feature_meta  # noqa: E402
from elasticdl_tpu_torch.common.model_handler import (  # noqa: E402
    ZOO_DIR,
    get_model_spec,
)
from elasticdl_tpu_torch.model_zoo.bert.bert_finetune import (  # noqa: E402
    init_parameters,
)
from elasticdl_tpu_torch.ops import _build  # noqa: E402
from elasticdl_tpu_torch.ops import flash_attention as fa  # noqa: E402
from elasticdl_tpu_torch.serving.batcher import (  # noqa: E402
    OK,
    DynamicBatcher,
)
from elasticdl_tpu_torch.serving.engine import ServingEngine  # noqa: E402

SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# per-type operation rates.  Bounds are stated against these, beside the
# card's power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

BERT_PARAMS = "hidden=768;num_layers=12;heads=12;mlp_dim=3072;max_len=512"
NUM_LAYERS = 12
SEQ_LEN = 512
VOCAB = 8192
BUCKETS = (1, 4, 16, 64)
CLIENT_THREADS = 4
REQUESTS_PER_CLIENT = 10
# serve defaults of the JAX CLI (--max_batch_latency_ms 10,
# --max_queue_rows 0 -> 4 x max_batch)
MAX_LATENCY_S = 0.010

# Tolerances, kernel vs plain version on the same inputs.  Both
# accumulate in f32 in another order; bf16 outputs are then rounded to
# bf16, where one rounding step is 2^-8 relative, so 2e-2 allows two
# steps at |out| < 2.  lse is f32 in both.
TOL = {
    torch.float32: {"out": 1e-4, "lse": 1e-4},
    torch.bfloat16: {"out": 2e-2, "lse": 1e-3},
}
# f32 logits of BERT-base, card (kernel) vs CPU (plain path), same
# weights: 12 layers of f32 sums in another order.
F32_LOGITS_TOL = 1e-3
# the served bf16 logits vs those f32 logits: bf16 rounding through 12
# layers (measured 0.014 at a logit scale of 1.65 on an H100).
BF16_LOGITS_TOL = 0.1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(q, k, v, causal: bool):
    """Least time for the kernel's work on this card: each input read
    once, O and lse written once, over HBM; QK^T and PV over the peak
    rate of the input type (causal: only the unmasked pairs)."""
    batch, q_len, heads, dim = q.shape
    k_len = k.shape[1]
    elem = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * elem \
        + batch * q_len * heads * 4
    if causal:
        pairs = sum(min(i + 1, k_len) for i in range(q_len))
    else:
        pairs = q_len * k_len
    flops = 4.0 * batch * heads * pairs * dim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def make_qkv(shape, dtype, gen, fused: bool):
    if fused:
        # the model's layout: q/k/v are column views of one QKV product
        batch, length, heads, dim = shape
        qkv = torch.randn((batch, length, 3 * heads * dim), generator=gen,
                          device="cuda").to(dtype)
        return tuple(t.unflatten(-1, (heads, dim))
                     for t in qkv.split(heads * dim, dim=-1))
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for _ in range(3))


def check_flash_kernel(gen):
    """Kernel vs plain on the card; returns (kernels entry sans launches,
    detail rows)."""
    cases = [
        # (label, shape, dtype, causal, fused qkv views)
        ("serve-bf16", (64, SEQ_LEN, 12, 64), torch.bfloat16, False, True),
        ("bf16", (64, SEQ_LEN, 12, 64), torch.bfloat16, False, False),
        ("bf16-causal", (64, SEQ_LEN, 12, 64), torch.bfloat16, True, False),
        ("f32", (64, SEQ_LEN, 12, 64), torch.float32, False, False),
        ("f32-causal", (64, SEQ_LEN, 12, 64), torch.float32, True, False),
        ("ragged-bf16", (4, 72, 12, 64), torch.bfloat16, False, False),
        ("ragged-bf16-causal", (4, 72, 12, 64), torch.bfloat16, True,
         False),
        ("ragged-f32", (4, 72, 12, 64), torch.float32, False, False),
        ("ragged-f32-causal", (4, 72, 12, 64), torch.float32, True, False),
    ]
    rows = []
    for label, shape, dtype, causal, fused in cases:
        q, k, v = make_qkv(shape, dtype, gen, fused)
        out_k, lse_k = fa.flash_attention_forward(q, k, v, causal=causal)
        out_r, lse_r = fa.flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err_out = (out_k.float() - out_r.float()).abs().max().item()
        err_lse = (lse_k - lse_r).abs().max().item()
        tol = TOL[dtype]
        ok = (bool(torch.isfinite(out_k).all())
              and err_out <= tol["out"] and err_lse <= tol["lse"])
        row = {"case": label, "shape": list(shape),
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "max_abs_err_out": err_out, "max_abs_err_lse": err_lse,
               "tol_out": tol["out"], "tol_lse": tol["lse"]}
        if shape[0] == 64:
            iters = 10
            row["ms"] = time_ms(
                lambda: fa.flash_attention_forward(q, k, v, causal=causal),
                iters)
            row["plain_ms"] = time_ms(
                lambda: fa.flash_attention_reference(q, k, v, causal=causal),
                iters)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal),
                iters)
            row["bound_ms"], row["bound_by"] = attention_bound_ms(
                q, k, v, causal)
        print(json.dumps(row), flush=True)
        if not ok:
            raise AssertionError(
                f"flash kernel disagrees with its plain version: {row}")
        rows.append(row)
        del q, k, v, out_k, out_r, lse_k, lse_r
    main = rows[0]
    entry = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "elasticdl_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "elasticdl_tpu/ops/flash_attention.py:48",
        "max_abs_err": main["max_abs_err_out"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }
    return entry, rows


def serve_bert(gen_seed: int):
    device = torch.device("cuda", 0)
    spec = get_model_spec(ZOO_DIR, "bert.bert_finetune.custom_model",
                          BERT_PARAMS + ";bf16=True")
    model = spec.model.to(device)
    init_parameters(model, torch.Generator(device=device).manual_seed(
        gen_seed))
    variables = {n: p.detach() for n, p in model.named_parameters()}
    feature_spec = feature_meta(
        {"input_ids": np.zeros((1, SEQ_LEN), np.int32)})

    rng = np.random.RandomState(gen_seed)
    requests = [
        [{"input_ids": rng.randint(0, VOCAB, (rows, SEQ_LEN))
          .astype(np.int32)}
         for rows in rng.randint(1, BUCKETS[-1] + 1, REQUESTS_PER_CLIENT)]
        for _ in range(CLIENT_THREADS)
    ]
    results = []
    results_lock = threading.Lock()

    def client(reqs):
        for req in reqs:
            t0 = time.perf_counter()
            res = batcher.submit(req).result(timeout=600)
            lat = time.perf_counter() - t0
            with results_lock:
                results.append((req["input_ids"].shape[0], res, lat))

    # ---- the main path: counts start at 0 here ----
    fa.flash_attention.launches = 0
    engine = ServingEngine(model, variables, step=0,
                           feature_spec=feature_spec, buckets=BUCKETS,
                           device=device)
    batcher = DynamicBatcher(engine, max_latency_s=MAX_LATENCY_S)
    threads = [threading.Thread(target=client, args=(reqs,))
               for reqs in requests]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t_start
    batcher.shutdown()
    launches = {"flash_attention_fwd": fa.flash_attention.launches}
    # ---- end of the main path ----

    snap = batcher.metrics.snapshot()
    batches = int(snap["batches"])
    n_req = CLIENT_THREADS * REQUESTS_PER_CLIENT
    bad = [(rows, r.code, r.error) for rows, r, _ in results if r.code != OK]
    if len(results) != n_req or bad:
        raise AssertionError(f"{len(bad)} requests not OK: {bad[:3]}")
    for rows, r, _ in results:
        if r.predictions.shape != (rows, 2) or not np.isfinite(
                r.predictions).all():
            raise AssertionError(
                f"bad predictions for {rows} rows: {r.predictions.shape}")
    expected = NUM_LAYERS * (len(BUCKETS) + batches)
    if launches["flash_attention_fwd"] != expected:
        raise AssertionError(
            f"flash kernel launched {launches['flash_attention_fwd']} "
            f"times; {NUM_LAYERS} layers x ({len(BUCKETS)} warm-up + "
            f"{batches} served batches) = {expected}")
    if engine.compile_count != len(BUCKETS):
        raise AssertionError(
            f"{engine.compile_count} batch shapes for {len(BUCKETS)} "
            "buckets")
    p50 = {}
    for b in BUCKETS:
        lats = [lat for rows, _, lat in results if engine.bucket_for(rows)
                == b]
        p50[str(b)] = float(np.median(lats)) * 1e3 if lats else None
    total_rows = sum(rows for rows, _, _ in results)
    serve = {
        "requests": n_req, "rows": total_rows, "batches": batches,
        "wall_s": wall_s, "requests_per_s": n_req / wall_s,
        "rows_per_s": total_rows / wall_s,
        "p50_latency_ms_by_bucket": p50,
        "batch_fill_ratio": snap["batch_fill_ratio"],
        "launches": launches,
    }
    print(json.dumps({"serve": serve}), flush=True)

    # f32 check: the same weights, 4 rows, card (kernel) vs CPU (plain)
    f32_model = get_model_spec(ZOO_DIR, "bert.bert_finetune.custom_model",
                               BERT_PARAMS + ";bf16=False").model
    x = {"input_ids": rng.randint(0, VOCAB, (4, SEQ_LEN)).astype(np.int32)}
    gpu = ServingEngine(f32_model, variables, 0, feature_spec, buckets=(4,),
                        precompile=False, device=device)
    cpu = ServingEngine(f32_model, {n: t.cpu() for n, t in
                                    variables.items()},
                        0, feature_spec, buckets=(4,), precompile=False,
                        device="cpu")
    bf16 = ServingEngine(model, variables, 0, feature_spec, buckets=(4,),
                         precompile=False, device=device)
    got, _ = gpu.predict(x, 4)
    want, _ = cpu.predict(x, 4)
    got_bf16, _ = bf16.predict(x, 4)
    err = float(np.abs(got - want).max())
    err_bf16 = float(np.abs(got_bf16 - want).max())
    check = {"f32_card_vs_cpu_max_abs_err": err, "tol": F32_LOGITS_TOL,
             "bf16_card_vs_f32_cpu_max_abs_err": err_bf16,
             "bf16_tol": BF16_LOGITS_TOL,
             "logit_scale": float(np.abs(want).max())}
    print(json.dumps({"bert_f32_check": check}), flush=True)
    if not (err <= F32_LOGITS_TOL and err_bf16 <= BF16_LOGITS_TOL):
        raise AssertionError(f"BERT on the card vs CPU: {check}")
    serve["forward"] = forward_breakdown(engine)
    print(json.dumps({"forward": serve["forward"]}), flush=True)
    return serve, check, launches


def forward_breakdown(engine):
    """Where a forward's time goes: the host time of one synced predict
    per bucket (median of 5), and for the largest bucket the device time
    by kernel from torch.profiler, grouped into the flash kernel, matrix
    products and the rest, with the device's busy share of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(SEED + 1)
    host_ms = {}
    for b in engine.buckets:
        x = {"input_ids": rng.randint(0, VOCAB, (b, SEQ_LEN))
             .astype(np.int32)}
        engine.predict(x, b)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.predict(x, b)
            times.append(time.perf_counter() - t0)
        host_ms[str(b)] = float(np.median(times)) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict(x, b)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us / 1e3
    groups = {"flash_attention_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in by_kernel.items():
        low = name.lower()
        if "flash_fwd_kernel" in low:
            groups["flash_attention_fwd"] += ms
        elif any(s in low for s in ("gemm", "xmma", "cutlass", "nvjet")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "host_ms_by_bucket": host_ms,
        "profiled_rows": b,
        "profiled_wall_ms": wall_ms,
        "device_ms": device_ms if by_kernel else None,
        "device_busy_share": device_ms / wall_ms if by_kernel else None,
        "device_ms_by_group": groups if by_kernel else None,
        "top_kernels_ms": top,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s for {_build.sources()}",
          flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entry, rows = check_flash_kernel(gen)
    torch.cuda.empty_cache()
    serve, check, launches = serve_bert(SEED)
    entry["launches"] = launches["flash_attention_fwd"]
    kernels = {"kernels": [entry]}

    name = torch.cuda.get_device_name(0)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "build_s": build_s,
                   "kernel_checks": rows, "serve": serve,
                   "bert_f32_check": check, **kernels}, f, indent=1)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

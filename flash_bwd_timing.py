#!/usr/bin/env python3
"""Time the flash-attention backward kernel of one or more checkouts of
the port on one GPU, in turns, so two versions are compared on one card.

    python3 flash_bwd_timing.py --tree OLD --tree . --tree . --tree OLD

Each `--tree` is the root of a checkout holding `elasticdl_tpu_torch/`;
each runs in a process of its own (the trees' modules share names), in
the order given, and builds its kernels into its own `build/`.  Per tree
and case it prints one JSON line: the variant that ran, the kernel's ms
per call (CUDA events over 20 calls after 3 warm-ups), its device ms per
launch by kernel name (torch.profiler over 5 calls), and the inputs'
shape.  The cases are `chip_smoke.py`'s three timed bf16 backward
cases: (64, 512, 12 x 64) from fused-QKV views, causal and not, and
(16, 512, 6 x 128).  Inputs come from one seed, residuals from the plain
forward.  All lines also go to chiprun_out/flash_bwd_timing.json.  Exits
non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
ITERS = 20
# (label, (batch, length, heads, dim), causal, fused qkv views)
CASES = [
    ("train-bf16", (64, 512, 12, 64), False, True),
    ("train-bf16-causal", (64, 512, 12, 64), True, True),
    ("bf16-d128", (16, 512, 6, 128), False, False),
]


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _time_ms(torch, fn, iters: int) -> float:
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


def _ms_by_kernel(torch, fn, iters: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        out[evt.key] = out.get(evt.key, 0.0) + us / 1e3 / iters
    return out


def time_tree(tree: str) -> list:
    """This process's rows for the checkout at `tree`."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    from elasticdl_tpu_torch.ops import flash_attention as fa

    if not os.path.abspath(fa.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {fa.__file__}, not from {tree}")
    card = _card()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for label, shape, causal, fused in CASES:
        batch, length, heads, dim = shape
        if fused:
            qkv = torch.randn((batch, length, 3 * heads * dim),
                              generator=gen, device="cuda").bfloat16()
            q, k, v = (t.unflatten(-1, (heads, dim))
                       for t in qkv.split(heads * dim, dim=-1))
        else:
            q, k, v = (torch.randn(shape, generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(3))
        out, lse = fa.flash_attention_reference(q, k, v, causal=causal)
        g = torch.randn(shape, generator=gen, device="cuda").bfloat16()

        def call():
            return fa.flash_attention_backward(q, k, v, out, lse, g, causal)

        fa.reset_launch_counts()
        call()
        torch.cuda.synchronize()
        variant = [name for name, n in
                   fa.flash_attention.backward_launches_by_kernel.items()
                   if n]
        row = {"tree": tree, "case": label, "shape": list(shape),
               "causal": causal, "fused_qkv": fused, "variant": variant,
               "card": card, "ms": _time_ms(torch, call, ITERS),
               "ms_by_kernel": _ms_by_kernel(torch, call, 5)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, out, lse, g
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", default=[])
    parser.add_argument("--one", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        time_tree(args.one)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_timing: no CUDA device", file=sys.stderr)
        return 1
    rows = []
    for tree in args.tree or [ROOT]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree],
            check=True, capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        for line in proc.stdout.splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                rows.append(json.loads(line))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "flash_bwd_timing.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

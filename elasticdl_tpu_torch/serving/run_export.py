"""Run torch exports (`<output>/saved_model/model.pt2`, common/export.py)
in a process that imports nothing of the model zoo:

    python -m elasticdl_tpu_torch.serving.run_export [--device cuda|cpu] \\
        MODEL.pt2 FEATURES.npz OUT.npz [MODEL.pt2 FEATURES.npz OUT.npz ...]

Each FEATURES.npz holds one feature dict keyed by the export's serving
signature; the export's output on it goes to OUT.npz under "out".  With
no triples on the command line it reads them from standard input, one
"MODEL.pt2 FEATURES.npz OUT.npz" line each, and runs each as it arrives
(a caller can start the process, whose imports take seconds, before its
exports exist).  The process loads each export once through
`load_saved_model`, which registers the hand kernels' custom ops and
imports nothing of the zoo, and prints one JSON line: the flash
kernel's launches during the runs, the port modules it imported, the
seconds it spent loading and running each triple, and its timeline as
`time.perf_counter` readings (on Linux one clock for every process of
the machine, so a caller can set them beside its own): `started_at`
(this module begins, after the package's own import of torch),
`ready_at` (the device reached and the loader warm), each triple's
`arrived_at` and `done_at`.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time

STARTED_AT = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from elasticdl_tpu_torch.common.export import load_saved_model  # noqa: E402


class _Probe(torch.nn.Module):
    def forward(self, x):
        return x + 1


def _warm_loader() -> None:
    """Save and load a one-op export, so the loader's lazy imports are
    paid before the first real export arrives."""
    buf = io.BytesIO()
    torch.export.save(torch.export.export(_Probe(), (torch.ones(2),)), buf)
    buf.seek(0)
    torch.export.load(buf)


def _triples(args):
    if args.triples:
        items = args.triples
        for i in range(0, len(items), 3):
            yield items[i:i + 3]
        return
    for line in sys.stdin:
        if line.strip():
            yield line.split()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="run_export")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("triples", nargs="*",
                        help="MODEL.pt2 FEATURES.npz OUT.npz, repeated "
                        "(default: one triple a line on standard input)")
    args = parser.parse_args(argv)
    if len(args.triples) % 3:
        parser.error("give MODEL.pt2 FEATURES.npz OUT.npz triples")
    from elasticdl_tpu_torch.ops.flash_attention import flash_attention

    flash_attention.launches = 0
    torch.empty(1, device=args.device)       # the device, up front
    _warm_loader()
    ready_at = time.perf_counter()
    loaded, seconds = {}, []
    for triple in _triples(args):
        if len(triple) != 3:
            parser.error(f"not a MODEL FEATURES OUT triple: {triple}")
        model_path, features_path, out_path = triple
        t0 = arrived_at = time.perf_counter()
        if model_path not in loaded:
            loaded[model_path] = load_saved_model(model_path).module()
        t1 = time.perf_counter()
        with np.load(features_path) as data:
            features = {name: torch.from_numpy(data[name]).to(args.device)
                        for name in data.files}
        with torch.no_grad():
            out = loaded[model_path](features).float().cpu().numpy()
        np.savez(out_path, out=out)
        done_at = time.perf_counter()
        seconds.append({"load_s": t1 - t0, "run_s": done_at - t1,
                        "arrived_at": arrived_at, "done_at": done_at})
    print(json.dumps({
        "flash_launches": flash_attention.launches,
        "port_modules": sorted(m for m in sys.modules
                               if m.startswith("elasticdl_tpu_torch")),
        "seconds": seconds,
        "started_at": STARTED_AT,
        "ready_at": ready_at,
    }, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

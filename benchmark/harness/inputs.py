"""One general generator for every traffic mix: training batches and
open-loop request schedules, made from `--seed` by the parameters of a
traffic file.

Every random draw comes from a generator seeded by `derive(seed, tag)`,
so the same seed gives the same inputs, and each purpose (weights,
batches, schedule, sample) has a stream of its own.  Tensors are drawn on
the device in a few large calls and then copied to host memory, where
the program's feed would hand them over.

Feature distributions (`"dist"` in a traffic file; a string parameter
names a key of the configuration):

- `uniform_int`: integers in [low, high);
- `exponential`: float32 draws of mean `scale`;
- `zipf`: heavy-tailed ids, floor(u^(-1/(a-1))) - 1 taken mod `mod`: the
  discrete Pareto law whose tail is zipf(a)'s; `mod` may be a list, one
  modulus for each column (a field's cardinality);
- labels `uniform_int`, or `planted_fm`: labels drawn from a fixed
  planted model over the dense counters, each field's ids and one
  pairwise interaction (the port's zoo `synthetic_criteo`, widened to the
  traffic's id space; its weights come from `planted_seed`, not the run's
  seed).

A serving mix holds `rate_per_s`, the request sizes (`rows`:
`log_uniform_int` over [low, high]) and the feature distributions.  The
sizes and the gaps between arrivals are one fixed set each, drawn from
`shape_seed`; the run's seed shuffles each set, sizes and gaps apart, so
that every seed offers the same rows over the same span of time, with
its bursts where its order puts them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

_M64 = (1 << 64) - 1


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream `tag` of run seed `seed` (splitmix64
    over the seed and the tag's bytes)."""
    x = (int(seed) & _M64) ^ 0x9E3779B97F4A7C15
    for byte in tag.encode():
        x = (x ^ byte) & _M64
        x = (x + 0x9E3779B97F4A7C15) & _M64
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        x = z ^ (z >> 31)
    return x >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, tag))
    return g


def _param(value, cfg: dict):
    return cfg[value] if isinstance(value, str) else value


def draw_feature(spec: dict, rows: int, cfg: dict, g: torch.Generator,
                 device) -> torch.Tensor:
    shape = (rows, *spec.get("shape", []))
    dist = spec["dist"]
    if dist == "uniform_int":
        return torch.randint(int(_param(spec["low"], cfg)),
                             int(_param(spec["high"], cfg)), shape,
                             generator=g, device=device, dtype=torch.int64
                             ).to(getattr(torch, spec.get("dtype", "int32")))
    if dist == "exponential":
        u = torch.rand(shape, generator=g, device=device,
                       dtype=torch.float64)
        return (-torch.log1p(-u) * float(spec.get("scale", 1.0))).float()
    if dist == "zipf":
        u = torch.rand(shape, generator=g, device=device,
                       dtype=torch.float64)
        k = torch.floor(torch.exp(-torch.log1p(-u) / (spec["a"] - 1.0)))
        k = torch.clamp(k, max=2.0 ** 53).long() - 1
        mod = _param(spec["mod"], cfg)
        mod = (torch.tensor(mod, device=device, dtype=torch.int64)
               if isinstance(mod, list) else int(mod))
        return (k % mod).to(
            getattr(torch, spec.get("dtype", "int32")))
    raise ValueError(f"unknown feature distribution {dist!r}")


def draw_labels(spec: dict, features: Dict[str, torch.Tensor], cfg: dict,
                g: torch.Generator, device) -> torch.Tensor:
    rows = next(iter(features.values())).shape[0]
    dtype = getattr(torch, spec.get("dtype", "int32"))
    if spec["dist"] == "uniform_int":
        return torch.randint(int(_param(spec["low"], cfg)),
                             int(_param(spec["high"], cfg)), (rows,),
                             generator=g, device=device).to(dtype)
    if spec["dist"] == "planted_fm":
        return _planted_fm(spec, features, g, device).to(dtype)
    raise ValueError(f"unknown label distribution {spec['dist']!r}")


def _planted_fm(spec: dict, features, g, device) -> torch.Tensor:
    dense = features[spec["dense"]].double()
    sparse = features[spec["sparse"]].long()
    fields = sparse.shape[1]
    planted = torch.Generator(device=device)
    planted.manual_seed(int(spec["planted_seed"]))
    ids = int(spec["ids_per_field"])
    id_w = torch.randn((fields, ids), generator=planted, device=device) \
        * float(spec["id_scale"])
    dense_w = torch.randn((dense.shape[1],), generator=planted,
                          device=device, dtype=torch.float64) \
        * float(spec["dense_scale"])
    field = torch.arange(fields, device=device)[None, :]
    a, b, modulus = spec["pair"]
    logits = float(spec["gain"]) * (
        torch.log1p(dense) @ dense_w
        + id_w[field, sparse % ids].double().sum(dim=1)
        * float(spec["id_coef"])
        + float(spec["pair_coef"])
        * ((sparse[:, a] % modulus) == (sparse[:, b] % modulus)).double()
        + float(spec["bias"]))
    prob = torch.sigmoid(logits)
    u = torch.rand(prob.shape, generator=g, device=device,
                   dtype=torch.float64)
    return (u < prob).int()


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def training_pool(cfg: dict, traffic: dict, seed: int, device) -> List[dict]:
    """`pool_batches` distinct batches of `batch` rows, as host arrays in
    the shape the program's feed hands over: {"features": {...},
    "labels": ...}."""
    batches, rows = int(traffic["pool_batches"]), int(traffic["batch"])
    g = generator(seed, "batches", device)
    feats = {name: draw_feature(spec, batches * rows, cfg, g, device)
             for name, spec in sorted(traffic["features"].items())}
    labels = draw_labels(traffic["labels"], feats, cfg, g, device)
    host = {k: _host(v) for k, v in feats.items()}
    host_labels = _host(labels)
    return [{"features": {k: v[i * rows:(i + 1) * rows]
                          for k, v in host.items()},
             "labels": host_labels[i * rows:(i + 1) * rows]}
            for i in range(batches)]


def request_count(traffic: dict, seconds: float) -> int:
    return max(1, int(round(float(traffic["rate_per_s"]) * seconds)))


def schedule(traffic: dict, seed: int, seconds: float
             ) -> Tuple[np.ndarray, np.ndarray]:
    """(due seconds from the window's start, rows) of each request.  The
    gaps are exponential (Poisson arrivals), scaled so that `n` requests
    fall in the window; gaps and sizes are drawn once from `shape_seed`,
    and the run's seed shuffles each."""
    n = request_count(traffic, seconds)
    shape = np.random.default_rng(int(traffic["shape_seed"]))
    gaps = shape.exponential(1.0, size=n + 1)
    spec = traffic["rows"]
    if spec["dist"] != "log_uniform_int":
        raise ValueError(f"unknown size distribution {spec['dist']!r}")
    low, high = int(spec["low"]), int(spec["high"])
    sizes = np.floor(np.exp(shape.uniform(math.log(low),
                                          math.log(high + 1), size=n)))
    sizes = np.clip(sizes, low, high).astype(np.int64)
    order = np.random.default_rng(derive(seed, "schedule"))
    gaps = order.permutation(gaps)
    sizes = order.permutation(sizes)
    cum = np.cumsum(gaps)
    return seconds * cum[:n] / cum[n], sizes


def request_features(cfg: dict, traffic: dict, seed: int, rows: int,
                     device) -> Dict[str, np.ndarray]:
    """Every row the schedule sends, as host arrays."""
    g = generator(seed, "requests", device)
    return {name: _host(draw_feature(spec, rows, cfg, g, device))
            for name, spec in sorted(traffic["features"].items())}

"""The serving signature of a model's features (the part of the JAX
package's common/export.py that serving needs without an export on disk;
writing and loading exports waits for a later slice)."""

from __future__ import annotations

from typing import Any

import numpy as np

# Feature-dict key used when a model's feed yields a single array instead
# of a dict (MNIST); the serving protocol and export meta both use it so
# single-input and dict-input models share one wire shape.
SINGLE_FEATURE_KEY = "features"


def feature_meta(sample_features: Any) -> dict:
    """Per-feature serving signature: {name: {shape: per-row dims, dtype}}.
    The batch dimension is dropped — it is the serving system's to choose."""

    def leaf(v):
        v = np.asarray(v)
        return {
            "shape": [int(d) for d in v.shape[1:]],
            "dtype": str(v.dtype),
        }

    if isinstance(sample_features, dict):
        return {str(k): leaf(v) for k, v in sample_features.items()}
    return {SINGLE_FEATURE_KEY: leaf(sample_features)}

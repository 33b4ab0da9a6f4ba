"""The committed orbax fixtures (tests/torch_fixtures/orbax/, which
chip_smoke.py's `orbax_restore` phase reads on the card) are what
tests/torch_fixtures/make_orbax_fixtures.py writes: a fresh run on the
CPU gives the same trees, leaf for leaf, and the same recorded
predictions and losses.

Trees are compared, not file bytes (orbax names its data files at
random).  Integer leaves compare exactly, except the int8 arena codes,
which may move by one code, and each float leaf (and the recorded
predictions and losses) within 1e-4 of its largest magnitude: two runs
of the JAX package on this CPU were measured 2.7e-6 apart in one element
of 109,824 of a kernel of largest magnitude ~0.2 (XLA's CPU programs
need not round alike from run to run, and Adam's step divides by the
square root of tiny second moments), so a bound at the scale of the
leaf, not of each element."""

import json
import os

import numpy as np

from _torch_orbax import flat_leaves
from elasticdl_tpu_torch.common import orbax_read

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures")
# of a float leaf's largest magnitude
FLOAT_TOL = 1e-4


def _assert_close(got, want, what):
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL * scale,
                               err_msg=what)


def _leaves(step_path):
    return dict(flat_leaves(orbax_read.read_tree(step_path)))


def test_a_fresh_run_writes_the_committed_fixtures(tmp_path):
    import sys

    sys.path.insert(0, FIXTURES)
    import make_orbax_fixtures

    fresh = make_orbax_fixtures.main(str(tmp_path / "orbax"))
    committed = os.path.join(FIXTURES, "orbax")
    for step in ("census/8", "deepfm_int8/2"):
        want = _leaves(os.path.join(committed, step))
        got = _leaves(os.path.join(fresh, step))
        assert sorted(got) == sorted(want), step
        for path, value in want.items():
            if value is None:
                assert got[path] is None, path
                continue
            a = orbax_read.as_numpy(value)
            b = orbax_read.as_numpy(got[path])
            assert (a.dtype, a.shape) == (b.dtype, b.shape), path
            if a.dtype == np.int8:
                assert np.abs(a.astype(np.int32) - b).max(initial=0) <= 1
            elif np.issubdtype(a.dtype, np.floating):
                _assert_close(b, a, path)
            else:
                np.testing.assert_array_equal(b, a, err_msg=path)
    for name in ("census_predictions.npy", "census_losses.npy",
                 "deepfm_int8_predictions.npy"):
        _assert_close(np.load(os.path.join(fresh, name)),
                      np.load(os.path.join(committed, name)), name)
    with open(os.path.join(committed, "versions.json")) as a, \
            open(os.path.join(fresh, "versions.json")) as b:
        assert json.load(a) == json.load(b)
    # the fixtures stay under 4 MiB: every checkout of the repo holds them
    size = sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(committed) for f in files)
    assert size < 4 << 20, size

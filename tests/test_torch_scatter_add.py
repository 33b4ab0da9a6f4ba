"""The port's scatter-add (elasticdl_tpu_torch/ops/scatter_add.py)
against the TPU kernel it replaces, `pallas_scatter_add` of
scripts/probe_pallas_scatter.py, run in Pallas interpret mode on the CPU.

The Pallas kernel adds the grads rows into the table serially in id
order; so does the port's plain version (`index_add_` on the CPU), and
so must the Hopper kernel.  Every comparison here is bitwise.  The probe
computes `n // block_ids` grid steps and drops the last `n % block_ids`
ids, so it is compared only at N divisible by `block_ids`; the port takes
any N, which is compared with `xla_scatter_add` and a serial numpy loop.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.ops import scatter_add as sa

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_scatter",
        os.path.join(REPO, "scripts", "probe_pallas_scatter.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(n, rows, dim, seed, zero_table=False):
    rng = np.random.RandomState(seed)
    # zipf(1.5): about 38% of the ids land on one row, many repeat
    ids = (rng.zipf(1.5, size=n) % rows).astype(np.int32)
    grads = rng.randn(n, dim).astype(np.float32)
    table = (np.zeros((rows, dim), np.float32) if zero_table
             else rng.randn(rows, dim).astype(np.float32))
    return table, ids, grads


def _serial(table, ids, grads):
    out = table.copy()
    for i, row in enumerate(ids):
        out[row] += grads[i]
    return out


def _port(table, ids, grads):
    return sa.scatter_add(torch.from_numpy(table), torch.from_numpy(ids),
                          torch.from_numpy(grads)).numpy()


@pytest.mark.parametrize("n,rows,dim,block_ids", [
    (256, 64, 16, 64),
    (1024, 512, 16, 256),
    (512, 128, 1, 128),       # the fm_linear arena's 4-byte rows
    (1024, 512, 1, 256),
])
def test_plain_version_bitwise_equals_pallas_kernel(probe, n, rows, dim,
                                                    block_ids):
    table, ids, grads = _inputs(n, rows, dim, seed=n + dim)
    want = np.asarray(probe.pallas_scatter_add(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads),
        block_ids=block_ids))
    got = _port(table, ids, grads)
    assert np.bincount(ids).max() > n // 4  # a hot row, many duplicates
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _serial(table, ids, grads))


@pytest.mark.parametrize("n,dim", [(1000, 16), (777, 1), (3, 16)])
def test_ragged_n_bitwise_equals_xla_scatter(probe, n, dim):
    table, ids, grads = _inputs(n, 97, dim, seed=n)
    want = np.asarray(probe.xla_scatter_add(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads)))
    got = _port(table, ids, grads)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _serial(table, ids, grads))


def test_probe_drops_the_ragged_tail_the_port_keeps(probe):
    """Why the probe is compared only at N % block_ids == 0."""
    table, ids, grads = _inputs(100, 16, 16, seed=5, zero_table=True)
    probe_out = np.asarray(probe.pallas_scatter_add(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads),
        block_ids=64))
    np.testing.assert_array_equal(
        probe_out, _serial(table, ids[:64], grads[:64]))
    np.testing.assert_array_equal(_port(table, ids, grads),
                                  _serial(table, ids, grads))


def test_every_id_on_one_row():
    table, _, grads = _inputs(4096, 8, 16, seed=3)
    ids = np.full(4096, 5, np.int32)
    got = _port(table, ids, grads)
    np.testing.assert_array_equal(got, _serial(table, ids, grads))
    np.testing.assert_array_equal(np.delete(got, 5, axis=0),
                                  np.delete(table, 5, axis=0))


def test_forward_leaves_its_input_and_inplace_writes_it():
    table, ids, grads = _inputs(300, 32, 16, seed=4)
    t = torch.from_numpy(table.copy())
    out = sa.scatter_add_forward(t, torch.from_numpy(ids),
                                 torch.from_numpy(grads))
    np.testing.assert_array_equal(t.numpy(), table)
    same = sa.scatter_add_forward(t, torch.from_numpy(ids),
                                  torch.from_numpy(grads), inplace=True)
    assert same is t
    assert torch.equal(out, t)


def test_reference_is_the_cpu_route_and_counts_no_launch():
    table, ids, grads = _inputs(300, 32, 16, seed=6)
    before = sa.scatter_add.launches
    args = (torch.from_numpy(table), torch.from_numpy(ids),
            torch.from_numpy(grads))
    assert torch.equal(sa.scatter_add(*args), sa.scatter_add_reference(*args))
    assert sa.scatter_add.launches == before  # CPU: no kernel launched


def test_plain_version_raises_on_an_id_out_of_range():
    table, ids, grads = _inputs(16, 8, 4, seed=7)
    ids[3] = 8
    with pytest.raises((IndexError, RuntimeError)):
        sa.scatter_add(torch.from_numpy(table), torch.from_numpy(ids),
                       torch.from_numpy(grads))


@pytest.mark.parametrize("change,match", [
    (lambda t, i, g: (t, i.long(), g), "int32 ids"),
    (lambda t, i, g: (t.double(), i, g), "float32 table"),
    (lambda t, i, g: (t, i, g.bfloat16()), "float32 table"),
    (lambda t, i, g: (t, i, g[:, :3]), r"\(N, D\)"),
    (lambda t, i, g: (t, i[:-1], g), r"\(N, D\)"),
    (lambda t, i, g: (t[:, None], i, g), "table"),
    (lambda t, i, g: (t.t().contiguous().t(), i, g), "contiguous"),
    (lambda t, i, g: (t.to("meta"), i.to("meta"), g.to("meta")),
     "cuda or cpu"),
])
def test_wrapper_checks_inputs(change, match):
    table, ids, grads = _inputs(16, 8, 4, seed=8)
    args = change(torch.from_numpy(table), torch.from_numpy(ids),
                  torch.from_numpy(grads))
    with pytest.raises(ValueError, match=match):
        sa.scatter_add_forward(*args)


def test_kernel_source_is_compiled_by_ops_build():
    from elasticdl_tpu_torch.ops import _build

    assert sa.SOURCE in _build.sources()
    for source in _build.sources():  # no float atomics in any kernel
        assert "atomicAdd" not in (_build.CSRC_DIR / source).read_text()
    text = (_build.CSRC_DIR / sa.SOURCE).read_text()
    assert "scripts/probe_pallas_scatter.py:68" in text
    # the source states the redesign's critical path
    assert "critical path" in text and "shared memory" in text


def _segments_numpy(sorted_ids):
    """(head, end) of every run of equal ids, by a plain loop."""
    runs = []
    head = 0
    for p in range(1, len(sorted_ids) + 1):
        if p == len(sorted_ids) or sorted_ids[p] != sorted_ids[head]:
            runs.append((head, p))
            head = p
    return runs


def _plan_numpy(sorted_ids, threshold):
    runs = _segments_numpy(sorted_ids)
    heads, ends = [], []
    for anchor in range(0, len(sorted_ids), threshold):
        head, end = next(r for r in runs if r[0] <= anchor < r[1])
        heads.append(head)
        ends.append(end)
    return (np.array(heads, np.int32), np.array(ends, np.int32),
            [r for r in runs if r[1] - r[0] > threshold])


T = sa.LONG_SEGMENT
PLAN_CASES = {
    "zipf": lambda rng: (rng.zipf(1.5, 5000) % 300).astype(np.int32),
    "all-distinct": lambda rng: rng.permutation(3000).astype(np.int32),
    "one-row": lambda rng: np.full(1000, 7, np.int32),
    "n1": lambda rng: np.array([3], np.int32),
    # runs of exactly T - 1, T and T + 1 ids, and 2T + 1 crossing anchors
    "threshold-edges": lambda rng: np.repeat(
        np.arange(6, dtype=np.int32), [T - 1, T, T + 1, 1, 2 * T + 1, T]),
    "long-at-the-end": lambda rng: np.repeat(
        np.arange(3, dtype=np.int32), [5, 1, 3 * T]),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_segment_plan_bitwise_equals_numpy(case):
    ids = np.sort(PLAN_CASES[case](np.random.RandomState(11)), kind="stable")
    heads, ends = sa.segment_plan(torch.from_numpy(ids))
    want_heads, want_ends, long_runs = _plan_numpy(ids, T)
    assert heads.dtype == ends.dtype == torch.int32
    np.testing.assert_array_equal(heads.numpy(), want_heads)
    np.testing.assert_array_equal(ends.numpy(), want_ends)
    got_long = sa.long_segments(heads, ends)
    assert [tuple(r) for r in got_long.tolist()] == long_runs


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_long_and_short_paths_cover_each_segment_once(case):
    """The kernel's two paths by their own rules: a long-segment block per
    `long_segments` pair, and a short head wherever position p + T does
    not hold the same id.  Emulated in numpy, they add every segment
    exactly once, in order, bit for bit the serial sum."""
    rng = np.random.RandomState(12)
    ids = PLAN_CASES[case](rng)
    grads = rng.randn(len(ids), 3).astype(np.float32)
    table = rng.randn(int(ids.max()) + 1, 3).astype(np.float32)
    order = np.argsort(ids, kind="stable")
    sorted_ids, sorted_grads = ids[order], grads[order]
    heads, ends = sa.segment_plan(torch.from_numpy(sorted_ids))
    segments = [tuple(r) for r in sa.long_segments(heads, ends).tolist()]
    n = len(ids)
    for p in range(n):
        row = sorted_ids[p]
        head = p == 0 or sorted_ids[p - 1] != row
        long = p + T < n and sorted_ids[p + T] == row
        if head and not long:
            end = p
            while end < n and sorted_ids[end] == row:
                end += 1
            segments.append((p, end))
    assert sorted(segments) == _segments_numpy(sorted_ids)
    out = table.copy()
    for head, end in segments:
        acc = out[sorted_ids[head]].copy()
        for q in range(head, end):
            acc += sorted_grads[q]
        out[sorted_ids[head]] = acc
    np.testing.assert_array_equal(out, _serial(table, ids, grads))


def test_wrapper_rejects_rows_wider_than_a_staged_chunk():
    table = torch.zeros(4, sa.MAX_DIM + 1)
    with pytest.raises(ValueError, match="at most"):
        sa.scatter_add_forward(table, torch.zeros(2, dtype=torch.int32),
                               torch.zeros(2, sa.MAX_DIM + 1))

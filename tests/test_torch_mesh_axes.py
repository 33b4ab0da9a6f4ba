"""The port's five-axis mesh (elasticdl_tpu_torch/parallel/mesh.py) and
its axis collectives (parallel/collectives.py), held against the JAX
package's mesh on the 8-device CPU mesh.

- A rank's coordinates are the JAX device position at the same index:
  `create_mesh` lays ranks out in the JAX order (pipe, data, model, seq,
  expert).
- One world of 4 gloo ranks runs every collective's forward and its
  backward, which must be the exact transpose of the forward as a
  linear map of all ranks' values (checked against numpy).
"""

import itertools
import threading

import jax
import numpy as np
import pytest
import torch

from _torch_world import run_world
from elasticdl_tpu.parallel import mesh as jax_mesh
from elasticdl_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(2)

LAYOUTS = {
    "data2_model2": dict(data=2, model=2),
    "model2_seq2": dict(model=2, seq=2),
    "data2_expert2": dict(data=2, expert=2),
    "data2_pipe2": dict(data=2, pipe=2),
    "seq4": dict(data=1, seq=4),
}


@pytest.mark.parametrize("axes", [
    dict(data=2, model=2, seq=2), dict(pipe=2, data=2, expert=2),
    dict(data=1, model=2, seq=4), dict(pipe=4, data=2),
    dict(data=8)], ids=str)
def test_a_ranks_coordinates_are_the_jax_device_position(axes):
    devices = jax.devices()
    jmesh = jax_mesh.create_mesh(devices, **axes)
    names = jmesh.axis_names
    position = {d.id: idx for idx, d in np.ndenumerate(jmesh.devices)}
    for rank, device in enumerate(devices):
        mesh = mesh_lib.ProcessMesh(8, rank, axis_sizes={
            n: jmesh.shape[n] for n in names})
        assert tuple(mesh.shape) == names
        assert tuple(mesh.coords[n] for n in names) == position[device.id]
        assert mesh.rank_at(mesh.coords) == rank


def test_sizes_that_do_not_divide_still_raise():
    # the JAX messages (tests/test_parallel_dp.py's cases)
    with pytest.raises(ValueError, match="1x1x1x1 != 8 devices"):
        mesh_lib.create_mesh(8, 0, "cpu", data=1)
    with pytest.raises(ValueError, match="not divisible by "
                                         "model\\*seq\\*expert\\*pipe=3"):
        mesh_lib.create_mesh(8, 0, "cpu", model=3)
    for axes in (dict(data=3), dict(data=-1, model=3)):
        with pytest.raises(ValueError):
            jax_mesh.create_mesh(jax.devices(), **axes)
    # a world of one takes every axis of size 1
    one = mesh_lib.create_mesh(1, 0, "cpu", data=-1, model=1, seq=1,
                               expert=1, pipe=1)
    assert set(one.shape.values()) == {1} and not one.distributed


def test_ranks_that_differ_only_off_data_hold_the_same_rows():
    spans = {}
    for rank in range(8):
        mesh = mesh_lib.ProcessMesh(8, rank, axis_sizes=dict(
            data=2, model=2, seq=2))
        spans.setdefault(mesh.coords["data"], set()).add(
            mesh_lib.local_batch_range(mesh, 64))
    assert spans == {0: {(0, 32)}, 1: {(32, 64)}}
    # the data-only mesh keeps its uneven split
    assert [mesh_lib.local_batch_range(mesh_lib.DataMesh(3, r), 32)
            for r in range(3)] == [(0, 11), (11, 22), (22, 32)]


def test_current_mesh_and_export_mode():
    mesh = mesh_lib.ProcessMesh(4, 1, axis_sizes=dict(model=2, seq=2))
    try:
        mesh_lib.set_current_mesh(mesh)
        assert mesh_lib.get_current_mesh() is mesh
        with mesh_lib.export_mode():
            assert mesh_lib.in_export_mode()
            assert mesh_lib.get_current_mesh().world_size == 1
        assert not mesh_lib.in_export_mode()
        with mesh_lib.using_mesh(mesh_lib.ProcessMesh()):
            assert mesh_lib.get_current_mesh().world_size == 1
        assert mesh_lib.get_current_mesh() is mesh
    finally:
        mesh_lib.set_current_mesh(None)


def test_destroying_a_mesh_clears_the_current_mesh():
    # the trainer sets the mesh it steps on, for this thread and as the
    # default of threads that never set one (autograd's); once the mesh
    # is gone, neither may still run the layers on it
    mesh = mesh_lib.ProcessMesh(4, 3, axis_sizes=dict(data=2, model=2))
    seen = []

    def other_thread():
        seen.append(mesh_lib.get_current_mesh())

    mesh_lib.set_current_mesh(mesh)
    mesh_lib.destroy_mesh(mesh)
    thread = threading.Thread(target=other_thread)
    thread.start()
    thread.join()
    assert mesh_lib.get_current_mesh().world_size == 1
    assert seen[0].world_size == 1


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    x = np.random.RandomState(0).randn(4, 2, 4).astype(np.float32)
    x[0, 1, 2] = x[1, 0, 2] = 9.0     # a tie for the max across seq
    x[2, 0, 3] = x[2, 1, 3] = 9.0     # and one within a rank
    got = run_world(4, "_torch_parallel_ranks:mesh_and_collectives", (x,),
                    tmp_path_factory.mktemp("mesh_world"))
    return x, got


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layouts_and_their_lines(world, layout):
    _, got = world
    for rank, result in enumerate(got):
        mine = result["layouts"][layout]
        mesh = mesh_lib.ProcessMesh(4, rank, axis_sizes=LAYOUTS[layout])
        assert mine["coords"] == mesh.coords
        for axis, ranks in mine["lines"].items():
            # the line: the ranks that differ from this one only on axis
            want = [r for r in range(4) if all(
                mesh_lib.ProcessMesh(4, r, axis_sizes=LAYOUTS[layout]
                                     ).coords[a] == mesh.coords[a]
                for a in mesh.shape if a != axis)]
            assert ranks == want and rank in ranks


def _expected(name, x):
    """Each rank's output and input gradient for the (model=2, seq=2)
    mesh (rank = 2 * model + seq), from the collective's definition: the
    gradient of sum_r <y_r, w_r> with w_r = arange + r."""
    coords = [divmod(r, 2) for r in range(4)]         # (model, seq)
    rank_of = {c: r for r, c in enumerate(coords)}
    weights = lambda shape, r: (np.arange(np.prod(shape), dtype=np.float32)
                                .reshape(shape) + r)
    xs = [x[r].astype(np.float64) for r in range(4)]
    ys = []
    for r, (m, s) in enumerate(coords):
        seq_line = [rank_of[(m, j)] for j in range(2)]
        if name == "ring_shift":
            ys.append(xs[rank_of[(m, (s - 1) % 2)]])
        elif name == "ring_shift_back":
            ys.append(xs[rank_of[(m, (s + 1) % 2)]])
        elif name == "sum":
            ys.append(xs[rank_of[(0, s)]] + xs[rank_of[(1, s)]])
        elif name == "all_gather":
            ys.append(np.concatenate([xs[j] for j in seq_line], axis=1))
        elif name == "all_to_all":
            ys.append(np.concatenate([xs[j][s:s + 1] for j in seq_line],
                                     axis=1))
        elif name == "max":
            ys.append(np.max([xs[j] for j in seq_line], axis=(0, 1)))
    # the transpose by finite differences of a linear map is exact: build
    # the gradient as sum_r w_r . dy_r/dx_q numerically (the maps are
    # linear, or piecewise linear for max)
    grads = [np.zeros_like(a) for a in xs]
    for q in range(4):
        for idx in itertools.product(*(range(n) for n in xs[q].shape)):
            bumped = [a.copy() for a in xs]
            bumped[q][idx] += 1e-3 if name != "max" else 0.0
            if name == "max":
                # the max's gradient: split evenly among the tied maxima
                for r, (m, s) in enumerate(coords):
                    line = [rank_of[(m, j)] for j in range(2)]
                    if q not in line:
                        continue
                    stacked = np.stack([xs[j] for j in line])
                    col = idx[1]
                    top = stacked[:, :, col].max()
                    hits = stacked[:, :, col] == top
                    if xs[q][idx] == top:
                        w = weights(ys[r].shape, r)[col]
                        grads[q][idx] += w / hits.sum()
                continue
            y2 = _recompute(name, bumped, coords, rank_of)
            grads[q][idx] = sum(
                float((weights(ys[r].shape, r) * (y2[r] - ys[r])).sum())
                for r in range(4)) / 1e-3
    return ys, grads


def _recompute(name, xs, coords, rank_of):
    out = []
    for r, (m, s) in enumerate(coords):
        line = [rank_of[(m, j)] for j in range(2)]
        if name == "ring_shift":
            out.append(xs[rank_of[(m, (s - 1) % 2)]])
        elif name == "ring_shift_back":
            out.append(xs[rank_of[(m, (s + 1) % 2)]])
        elif name == "sum":
            out.append(xs[rank_of[(0, s)]] + xs[rank_of[(1, s)]])
        elif name == "all_gather":
            out.append(np.concatenate([xs[j] for j in line], axis=1))
        elif name == "all_to_all":
            out.append(np.concatenate([xs[j][s:s + 1] for j in line],
                                      axis=1))
    return out


@pytest.mark.parametrize("name", ["ring_shift", "ring_shift_back", "sum",
                                  "all_gather", "all_to_all", "max"])
def test_axis_collectives_and_their_transposes(world, name):
    x, got = world
    ys, grads = _expected(name, x)
    for r in range(4):
        y, g = got[r]["collectives"][name]
        # f32 sums of at most two terms, gradients summed in f32
        np.testing.assert_allclose(y.numpy(), ys[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), grads[r], rtol=1e-3,
                                   atol=1e-3)


def test_a_bf16_shift_moves_its_bits(world):
    x, got = world
    for r in range(4):
        m, s = divmod(r, 2)
        src = 2 * m + (s - 1) % 2
        want = torch.tensor(x[src], dtype=torch.bfloat16).float()
        assert torch.equal(got[r]["bf16_shift"], want)

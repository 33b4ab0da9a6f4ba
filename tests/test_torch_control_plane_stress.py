"""The seeded concurrency fuzz of tests/test_control_plane_stress.py,
run against the port's TaskManager and RendezvousServer.

The three cases run the JAX test's own bodies (the same seeds, thread
counts, `sys.setswitchinterval(1e-5)` and invariant checkers:
conservation, lease exclusivity, monotone epochs and rendezvous ids, one
`all_done`, contiguous unique ranks) with the module's TaskManager,
RendezvousServer, `create_shards_from_ranges` and messages swapped for
the port's.
Each case keeps the JAX test's 120 s deadline as its own limit.
"""

import pytest

import test_control_plane_stress as jax_stress
from _torch_limits import within
from elasticdl_tpu_torch.master import rendezvous_server, task_manager
from elasticdl_tpu_torch.proto import messages as pb

# the JAX test's join deadline, in seconds
CASE_LIMIT_S = 120


@pytest.fixture
def port_stress(monkeypatch):
    """The JAX stress module, its control plane swapped for the port's."""
    monkeypatch.setattr(jax_stress, "TaskManager", task_manager.TaskManager)
    monkeypatch.setattr(jax_stress, "create_shards_from_ranges",
                        task_manager.create_shards_from_ranges)
    monkeypatch.setattr(jax_stress, "RendezvousServer",
                        rendezvous_server.RendezvousServer)
    monkeypatch.setattr(jax_stress, "pb", pb)
    return jax_stress


@within(CASE_LIMIT_S)
def test_task_manager_stress(port_stress):
    tm = port_stress._make_tm()
    assert isinstance(tm, task_manager.TaskManager)
    port_stress.test_task_manager_stress()


@within(CASE_LIMIT_S)
def test_lease_exclusivity_stress(port_stress):
    port_stress.test_lease_exclusivity_stress()


@within(CASE_LIMIT_S)
def test_rendezvous_stress(port_stress):
    assert port_stress.RendezvousServer is rendezvous_server.RendezvousServer
    port_stress.test_rendezvous_stress()

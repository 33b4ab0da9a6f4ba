"""The port's sharded tiered store (store/sharding.py) and its sidecar
(store/checkpoint.py) against the JAX package's, the cases of
tests/test_store_sharding.py: the shard map's assignment and
rebalancing, per-shard admission planning, the statistics fold, the
handoff with its `store.shard_handoff` defer and retry, joins, and the
host rebuild from the sharded sidecar.  Each case runs the same
operations on a store of each package; plans (slots, rows, admissions,
evictions, hits, misses, lookups per shard), completed moves, stats,
events and the host state must be equal bit for bit.  A sidecar written
by either package loads in the port; the port's prune sweeps both
sidecar roots."""

import os

import numpy as np
import pytest
import torch

from elasticdl_tpu.common import events as jax_events
from elasticdl_tpu.common import faults as jax_faults
from elasticdl_tpu.store import checkpoint as jax_ckpt
from elasticdl_tpu.store import sharding as jax_sharding
from elasticdl_tpu_torch.common import events as port_events
from elasticdl_tpu_torch.common import faults as port_faults
from elasticdl_tpu_torch.store import checkpoint as port_ckpt
from elasticdl_tpu_torch.store import sharding as port_sharding

torch.set_num_threads(2)

PACKAGES = {
    "jax": (jax_sharding, jax_faults, jax_events, jax_ckpt),
    "port": (port_sharding, port_faults, port_events, port_ckpt),
}
PLAN_FIELDS = ("slots", "rows", "admit_rows", "evict_rows")


@pytest.fixture(autouse=True)
def _clean_globals():
    yield
    jax_faults.uninstall()
    port_faults.uninstall()


def make_store(sharding, num_shards=4, workers=(0, 1, 2), cache_rows=16):
    return sharding.ShardedTieredStore(
        planes={"ctr": 2}, num_fields=2, cache_rows=cache_rows,
        num_shards=num_shards, workers=workers)


def batch(pairs):
    return np.asarray(pairs, np.int64)


def zipf_batches(seed, n=12, rows=8):
    rng = np.random.RandomState(seed)
    return [np.stack([rng.zipf(1.3, rows) % 200, rng.zipf(1.3, rows) % 90],
                     axis=1).astype(np.int64) for _ in range(n)]


def plan_view(plan) -> dict:
    view = {k: np.asarray(getattr(plan, k)) for k in PLAN_FIELDS}
    view.update(hits=plan.hits, misses=plan.misses, growth=plan.growth,
                by_shard=dict(plan.by_shard))
    return view


def assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _handoff_faulted(store, pkg):
    faults = pkg[1]
    faults.install(faults.FaultRegistry(schedule=[
        faults.FaultSpec(faults.POINT_STORE_SHARD_HANDOFF, 0, "raise")],
        seed=13))
    try:
        first = store.handoff(dead_worker=0)
        pending = store.pending_handoffs()
        owner_kept = store.map.owner(0)
        retried = store.handoff()
    finally:
        faults.uninstall()
    return [first, pending, owner_kept, retried]


def _stream(store, seed):
    """Plans and folds over a zipf stream, a death, a join and a
    deferred move between them."""
    out = []
    for i, sparse in enumerate(zipf_batches(seed)):
        plan = store.prepare(sparse)
        out.append(plan_view(plan))
        clicked = (np.arange(sparse.shape[0]) % 3 == 0).astype(np.float32)
        store.fold_stats(plan.rows, np.repeat(clicked, plan.rows.shape[1]))
        if i == 4:
            out.append(store.handoff(dead_worker=1))
        if i == 8:
            out.append(store.join(9))
    return out


SCENARIOS = {
    "round_robin_map": lambda s, pkg: [
        s.map.as_dict(), s.map.worker_shards(0), s.map.workers(),
        s.map.shard_of_rows(np.arange(8))],
    "remove_and_last_worker": lambda s, pkg: [
        s.map.remove_worker(1), s.map.workers(), s.map.owner(1),
        s.map.remove_worker(1), s.map.remove_worker(2),
        s.map.least_loaded()],
    "add_worker_fair_share": lambda s, pkg: [
        s.map.add_worker(5), s.map.workers(), s.map.add_worker(5),
        s.map.as_dict()],
    "slots_in_owning_slice": lambda s, pkg: [
        plan_view(s.prepare(batch([[0, 1], [2, 3], [4, 5], [0, 1]]))),
        s.host.size],
    "second_pass_all_hits": lambda s, pkg: [
        plan_view(s.prepare(batch([[0, 1], [2, 3]]))),
        plan_view(s.prepare(batch([[0, 1], [2, 3]]))), s.stats()],
    "fold_stats": lambda s, pkg: [
        s.fold_stats(s.prepare(batch([[0, 1], [0, 1]])).rows,
                     np.array([1, 1, 0, 0], np.float32)),
        s.host.state_dict()],
    "handoff_emits": lambda s, pkg: [
        s.handoff(dead_worker=0), s.map.as_dict(), s.stats()],
    "handoff_fault_defers_then_retries": _handoff_faulted,
    "join_rebalances": lambda s, pkg: [
        s.join(7), s.map.workers(), s.map.as_dict()],
    "zipf_stream": lambda s, pkg: _stream(s, 3),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_the_jax_store(name):
    results = {}
    for key, pkg in PACKAGES.items():
        workers = (0, 1) if name == "join_rebalances" else (0, 1, 2)
        # the stream's 16 lookups a batch fit a 16-row shard slice, and
        # its growth evicts
        store = make_store(pkg[0], workers=workers,
                           cache_rows=64 if name == "zipf_stream" else 16)
        seen = []

        def observe(record, _seen=seen):
            if record.get("event", "").startswith("store_"):
                _seen.append({k: v for k, v in record.items()
                              if k not in ("ts", "pid", "role")})

        pkg[2].add_observer(observe)
        try:
            out = SCENARIOS[name](store, pkg)
        finally:
            pkg[2].remove_observer(observe)
        stats = store.stats()
        # (the JAX tier has no planes before its first growth)
        host = store.host.state_dict() if store.host.size else {}
        results[key] = (out, stats, store.cache_state(), host, seen)
    assert_same(results["port"], results["jax"])


def test_shard_map_guards_the_last_worker():
    m = port_sharding.ShardMap(4, [0, 1])
    m.remove_worker(1)
    with pytest.raises(ValueError, match="last worker"):
        m.remove_worker(0)
    with pytest.raises(ValueError):
        port_sharding.ShardMap(0, [0])
    with pytest.raises(ValueError):
        port_sharding.ShardMap(2, [])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sidecar_from_either_package_rebuilds_the_port_store(
        tmp_path, writer):
    """The rebuild of tests/test_store_sharding.py: sidecar values for
    the rows it covers, the deterministic init for rows grown since."""
    w_sharding, _, _, w_ckpt = PACKAGES[writer]
    src = make_store(w_sharding, num_shards=2, workers=(0, 1),
                     cache_rows=8)
    store = make_store(port_sharding, num_shards=2, workers=(0, 1),
                       cache_rows=8)
    for s in (src, store):
        plan = s.prepare(batch([[0, 1], [2, 3]]))
        s.fold_stats(plan.rows, np.ones(plan.rows.size, np.float32))
    w_ckpt.save_sharded_sidecar(str(tmp_path), 5, src)
    assert port_ckpt.has_sharded_sidecar(str(tmp_path), 5)
    sidecar = port_ckpt.load_sharded_sidecar(str(tmp_path), 5)
    assert sidecar.meta["vocab_rows"] == store.host.size
    assert sidecar.meta["shard_owners"] == {"0": 0, "1": 1}
    assert_same(sidecar.cache_arrays, store.cache_state())
    store.prepare(batch([[9, 9], [10, 10]]))
    for shard in range(store.num_shards):
        rows = store.shard_rows(shard)
        expect = store.host.gather(rows, planes=("ctr",))["ctr"].copy()
        store.host.set_rows(rows, {"ctr": np.zeros_like(expect)})
        assert store.rebuild_shard(shard, sidecar) == rows.size
        np.testing.assert_array_equal(
            store.host.gather(rows, planes=("ctr",))["ctr"], expect)
    # the residency maps load back into a fresh store
    fresh = make_store(port_sharding, num_shards=2, workers=(0, 1),
                       cache_rows=8)
    fresh.load_cache_state(sidecar.cache_arrays)
    assert fresh.stats()["cache_occupancy_rows"] == \
        src.stats()["cache_occupancy_rows"]


def test_port_sidecar_matches_the_jax_layout(tmp_path):
    stores = {k: make_store(pkg[0], cache_rows=64)
              for k, pkg in PACKAGES.items()}
    for key, store in stores.items():
        for sparse in zipf_batches(1, n=3):
            store.prepare(sparse)
        PACKAGES[key][3].save_sharded_sidecar(str(tmp_path / key), 3, store)
    loaded = {k: port_ckpt.load_sharded_sidecar(str(tmp_path / k), 3)
              for k in stores}
    assert loaded["port"].meta == loaded["jax"].meta
    assert_same(loaded["port"].host_state, loaded["jax"].host_state)
    assert_same(loaded["port"].cache_arrays, loaded["jax"].cache_arrays)
    assert sorted(os.listdir(port_ckpt.sharded_sidecar_dir(
        str(tmp_path / "port"), 3))) == ["meta.json", "store.npz"]


def test_prune_sweeps_the_tiered_and_the_sharded_roots(tmp_path):
    store = make_store(port_sharding)
    store.prepare(batch([[0, 1]]))
    for step in (1, 2, 3):
        port_ckpt.save_sharded_sidecar(str(tmp_path), step, store)
        os.makedirs(port_ckpt.sidecar_dir(str(tmp_path), step))
    port_ckpt.prune_sidecars(str(tmp_path), [3])
    for root in (port_ckpt.SIDECAR_ROOT, port_ckpt.SHARDED_ROOT):
        assert os.listdir(os.path.join(tmp_path, root)) == ["3"]
    assert port_ckpt.has_sharded_sidecar(str(tmp_path), 3)
    assert not port_ckpt.has_sharded_sidecar(str(tmp_path), 2)

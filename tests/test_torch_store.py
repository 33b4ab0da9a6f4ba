"""The port's tiered embedding store (elasticdl_tpu_torch/store) against
the JAX package's (elasticdl_tpu/store), on the CPU: the integer paths
bit for bit (the row init and its hash, the lazy vocabulary, the cache's
admission plans, the host planes, the mesh accounting, the dedup
packer's ranking) and the device seam's admissions and reads on one
store state, fp32 and int8.

Small configuration: 26 fields, dims 4 and 1, caches of at most 256
rows, a zipfian id stream of 32-row batches.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from elasticdl_tpu.data import wire as jax_wire
from elasticdl_tpu.layers import arena as jax_arena
from elasticdl_tpu.store import cache as jax_cache
from elasticdl_tpu.store import device as jax_device
from elasticdl_tpu.store import host_tier as jax_host
from elasticdl_tpu.store.tiered import TieredStore as JaxStore
from elasticdl_tpu.worker.trainer import TrainState as JaxState
from elasticdl_tpu_torch.data import wire as port_wire
from elasticdl_tpu_torch.layers.arena import TieredArena
from elasticdl_tpu_torch.store import cache as port_cache
from elasticdl_tpu_torch.store import device as port_device
from elasticdl_tpu_torch.store import host_tier as port_host
from elasticdl_tpu_torch.store.tiered import TieredStore as PortStore
from elasticdl_tpu_torch.worker.trainer import TrainState as PortState

torch.set_num_threads(2)

NUM_FIELDS = 26
DIM = 4
PLANES = {"fm_embedding": DIM, "fm_linear": 1}


def zipf_stream(steps=12, batch=32, ids_per_field=400, a=1.3, seed=5):
    """A seeded (steps, batch, fields) zipfian id stream, permuted per
    field so hot ids differ across fields."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(a, size=(steps, batch, NUM_FIELDS)),
                       ids_per_field) - 1
    perms = np.stack([rng.permutation(ids_per_field)
                      for _ in range(NUM_FIELDS)])
    return perms[np.arange(NUM_FIELDS)[None, None, :], ranks].astype(
        np.int64)


# ---- the row init and its hash -----------------------------------------


def test_splitmix64_bitwise():
    x = np.random.default_rng(0).integers(
        0, np.iinfo(np.uint64).max, 4096, dtype=np.uint64,
        endpoint=True)
    x[:3] = [0, 1, np.iinfo(np.uint64).max]
    np.testing.assert_array_equal(port_host._splitmix64(x),
                                  jax_host._splitmix64(x))


@pytest.mark.parametrize("seed,plane,dim", [
    (0x5EED, 0, 16), (0x5EED, 1, 1), (7, 0, 4), (-1, 3, 8)])
def test_row_init_values_bitwise(seed, plane, dim):
    rows = np.concatenate([np.arange(300), [2 ** 40, 2 ** 62]])
    got = port_host.row_init_values(seed, plane, rows, dim)
    want = jax_host.row_init_values(seed, plane, rows, dim)
    assert got.dtype == np.float32 and got.shape == (rows.size, dim)
    np.testing.assert_array_equal(got, want)
    # a row's init depends on the row alone, not on its neighbours
    np.testing.assert_array_equal(
        port_host.row_init_values(seed, plane, rows[5:9], dim), got[5:9])


# ---- the lazy vocabulary -----------------------------------------------


def test_lazy_vocabulary_assign_and_lookup_bitwise():
    port = port_host.LazyVocabulary(NUM_FIELDS)
    ref = jax_host.LazyVocabulary(NUM_FIELDS)
    for sparse in zipf_stream():
        for got, want in zip(port.assign(sparse), ref.assign(sparse)):
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)
    assert port.size == ref.size > 0
    probe = zipf_stream()[3].copy()
    probe[0, :3] = [10 ** 9, -5, 2 ** 40]          # never seen
    got = port.lookup(probe)
    np.testing.assert_array_equal(got, ref.lookup(probe))
    assert (got[0, :3] == -1).all() and (got[1:] >= 0).all()
    for mine, theirs in zip(port.state_arrays(), ref.state_arrays()):
        np.testing.assert_array_equal(mine, theirs)
    again = port_host.LazyVocabulary.from_arrays(NUM_FIELDS,
                                                 *port.state_arrays())
    np.testing.assert_array_equal(again.lookup(probe), got)
    assert again.size == port.size


def test_lazy_vocabulary_rejects_a_wrong_field_count():
    with pytest.raises(ValueError, match="expected"):
        port_host.LazyVocabulary(NUM_FIELDS).assign(np.zeros((2, 3)))


# ---- the host tier -----------------------------------------------------


@pytest.mark.parametrize("host_dtype", ["fp32", "int8"])
def test_host_tier_planes_bitwise(host_dtype):
    port = port_host.HostTier(PLANES, NUM_FIELDS, host_dtype, seed=11,
                              initial_rows=64)
    ref = jax_host.HostTier(PLANES, NUM_FIELDS, host_dtype, seed=11,
                            initial_rows=64)
    rng = np.random.default_rng(2)
    for sparse in zipf_stream(steps=6):
        got_rows, got_new = port.assign(sparse)
        want_rows, want_new = ref.assign(sparse)
        np.testing.assert_array_equal(got_rows, want_rows)
        assert got_new == want_new
        rows = np.unique(got_rows)[::3]
        values = {name: rng.standard_normal((rows.size, dim)).astype(
            np.float32) * 3 for name, dim in PLANES.items()}
        port.set_rows(rows, values)
        ref.set_rows(rows, values)
    assert port.size == ref.size and port.nbytes == ref.nbytes
    everything = np.arange(port.size)
    got, want = port.gather(everything), ref.gather(everything)
    for name in PLANES:
        np.testing.assert_array_equal(got[name], want[name])
    got, want = port.state_dict(), ref.state_dict()
    assert sorted(got) == sorted(want)
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(IndexError):
        port.gather([port.size])
    # a state dict round-trips into a fresh tier
    fresh = port_host.HostTier(PLANES, NUM_FIELDS, host_dtype, seed=11)
    fresh.load_state_dict(got)
    again = fresh.gather(everything)
    for name in PLANES:
        np.testing.assert_array_equal(again[name], port.gather(
            everything)[name])


def test_host_tier_backfill_then_init():
    port = port_host.HostTier(PLANES, NUM_FIELDS)
    ref = jax_host.HostTier(PLANES, NUM_FIELDS)
    for tier in (port, ref):
        tier.set_backfill(
            lambda plane, fields, ids: None if plane == "fm_linear" else
            np.repeat((ids * 10 + fields).astype(np.float32)[:, None],
                      DIM, 1))
    sparse = zipf_stream(steps=1)[0]
    rows, _ = port.assign(sparse)
    ref.assign(sparse)
    got, want = port.gather(rows.reshape(-1)), ref.gather(rows.reshape(-1))
    for name in PLANES:
        np.testing.assert_array_equal(got[name], want[name])
    expect = (sparse * 10 + np.arange(NUM_FIELDS)).reshape(-1)
    np.testing.assert_array_equal(got["fm_embedding"][:, 0], expect)
    # fm_linear fell through to the deterministic init
    np.testing.assert_array_equal(
        got["fm_linear"][:, 0],
        port_host.row_init_values(port.seed, 1, rows.reshape(-1), 1)[:, 0])


# ---- the hot-row cache -------------------------------------------------


def _assert_plans_equal(got, want):
    for key in ("slots", "admit_slots", "admit_rows", "evict_slots",
                "evict_rows"):
        g, w = getattr(got, key), getattr(want, key)
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert (got.hits, got.misses) == (want.hits, want.misses)


@pytest.mark.parametrize("ranked", [False, True], ids=["unranked",
                                                        "ranked"])
def test_cache_plans_bitwise(ranked):
    """Over a stream that fills, then evicts: every plan field and the
    scores, with the ranking computed by each package's wire module or
    derived by the cache itself."""
    vocab = port_host.LazyVocabulary(NUM_FIELDS)
    port = port_cache.HotRowCache(512)
    ref = jax_cache.HotRowCache(512)
    evicted = 0
    for sparse in zipf_stream(steps=14):
        rows, *_ = vocab.assign(sparse)
        kw_port = kw_ref = {}
        if ranked:
            kw_port = {"ranked": port_wire.frequency_rank(rows.reshape(-1))}
            kw_ref = {"ranked": jax_wire.frequency_rank(rows.reshape(-1))}
        got, want = port.plan(rows, **kw_port), ref.plan(rows, **kw_ref)
        _assert_plans_equal(got, want)
        evicted += got.evict_rows.size
        for g, w in zip(port.state_arrays(), ref.state_arrays()):
            np.testing.assert_array_equal(g, w)
    assert evicted > 0 and port.occupancy == ref.occupancy == 512


def test_cache_raises_like_the_reference():
    """Over capacity, and a ranking that covers another lookup count:
    both packages refuse."""
    rows = np.arange(40).reshape(2, 20)
    for cache in (port_cache.HotRowCache(32), jax_cache.HotRowCache(32)):
        with pytest.raises(ValueError, match="unique rows"):
            cache.plan(rows)
    for mod in (port_cache, jax_cache):
        cache = mod.HotRowCache(64)
        uniq, counts = port_wire.frequency_rank(rows.reshape(-1))
        with pytest.raises(ValueError, match="covers"):
            cache.plan(rows, ranked=(uniq, counts + 1))
    with pytest.raises(ValueError, match="dtype"):
        port_cache.HotRowCache(8, dtype="bfloat16")


def test_cache_state_round_trip_and_dtype_gate():
    cache = port_cache.HotRowCache(64, dtype="int8")
    cache.plan(np.arange(50).reshape(5, 10))
    row_of, score, dtype = cache.state_arrays()
    assert dtype == "int8"
    twin = port_cache.HotRowCache(64)
    with pytest.raises(ValueError, match="dtype mismatch"):
        twin.load_state_arrays(row_of, score, dtype=dtype)
    twin.load_state_arrays(row_of, score, dtype=dtype, convert=True)
    np.testing.assert_array_equal(twin.row_of, row_of)
    assert twin.slot_of(7) == cache.slot_of(7) >= 0
    assert twin.slot_of(999) == -1


def test_partition_plan_bitwise():
    port, ref = port_cache.HotRowCache(64), jax_cache.HotRowCache(64)
    for rows in (np.arange(60), np.arange(40, 100)):
        got_plan, want_plan = port.plan(rows), ref.plan(rows)
        got = port_cache.partition_plan(got_plan, 4, 64)
        want = jax_cache.partition_plan(want_plan, 4, 64)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in g:
                np.testing.assert_array_equal(g[key], w[key], key)
    with pytest.raises(ValueError, match="divide evenly"):
        port_cache.partition_plan(got_plan, 7, 64)


def test_device_cache_byte_model_matches():
    for dtype in ("float32", "int8"):
        assert port_cache.device_cache_bytes(PLANES, 1 << 20, dtype) == \
            jax_cache.device_cache_bytes(PLANES, 1 << 20, dtype)
        assert port_cache.device_cache_bytes_per_step(
            PLANES, 4096 * 26, dtype) == \
            jax_cache.device_cache_bytes_per_step(PLANES, 4096 * 26, dtype)


# ---- the dedup packer's ranking ----------------------------------------


def test_dedup_packer_ranking_matches_jax_last_ranking():
    port, ref = port_wire.DedupPacker(), jax_wire.DedupPacker()
    for sparse in zipf_stream(steps=4):
        ids = port_wire.field_disjoint_ids(sparse)
        packed, (uniq, counts) = port.pack(ids, return_ranking=True)
        want = ref.pack(jax_wire.field_disjoint_ids(sparse))
        for key in want:
            np.testing.assert_array_equal(packed[key], want[key])
        np.testing.assert_array_equal(uniq, ref.last_ranking[0])
        np.testing.assert_array_equal(counts, ref.last_ranking[1])
        # the ranking of the packed ids is frequency_rank's
        want_u, want_c = port_wire.frequency_rank(ids.reshape(-1))
        np.testing.assert_array_equal(uniq, want_u)
        np.testing.assert_array_equal(counts, want_c)
    # without the flag, pack returns the struct alone
    assert isinstance(port.pack(ids), dict)


def test_dedup_packer_ranking_is_each_callers_own():
    """Two threads share one packer; each call's ranking covers its own
    batch (a shared attribute could hand one thread the other's)."""
    packer = port_wire.DedupPacker()
    stream = zipf_stream(steps=2, batch=64)
    ids = [port_wire.field_disjoint_ids(s) for s in stream]
    want = [port_wire.frequency_rank(i.reshape(-1)) for i in ids]
    errors = []
    barrier = threading.Barrier(2)

    def worker(k):
        try:
            barrier.wait(timeout=10)
            for _ in range(20):
                _, (uniq, counts) = packer.pack(ids[k], return_ranking=True)
                np.testing.assert_array_equal(uniq, want[k][0])
                np.testing.assert_array_equal(counts, want[k][1])
        except Exception as exc:   # re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[0]


# ---- the device seam ---------------------------------------------------

CACHE_ROWS = 32


class _Cache(nn.Module):
    """The two cache planes of TieredDeepFM, alone."""

    def __init__(self, cache_dtype="float32"):
        super().__init__()
        self.fm_embedding = TieredArena(CACHE_ROWS, DIM, cache_dtype)
        self.fm_linear = TieredArena(CACHE_ROWS, 1, cache_dtype)


def _states(cache_dtype, seed=0):
    """A JAX fake TrainState (as tests/test_tiered_store.py builds it) and
    a port TrainState holding the same cache values, with Adam moments
    made non-zero by one step on the same gradient."""
    rng = np.random.default_rng(seed)
    tables = {name: rng.standard_normal((CACHE_ROWS, dim)).astype(
        np.float32) for name, dim in PLANES.items()}
    grads = {name: rng.standard_normal((CACHE_ROWS, dim)).astype(
        np.float32) for name, dim in PLANES.items()}
    model = _Cache(cache_dtype)
    quantized = {}
    with torch.no_grad():
        for name in PLANES:
            arena = getattr(model, name)
            if cache_dtype == "int8":
                q8, scale = jax_arena.quantize_rows_host(tables[name])
                arena.q8.copy_(torch.from_numpy(q8))
                arena.scale.copy_(torch.from_numpy(scale))
                quantized[name] = {"embedding": {
                    "q8": jnp.asarray(q8), "scale": jnp.asarray(scale)}}
            else:
                arena.embedding.copy_(torch.from_numpy(tables[name]))
    carrier = {name: (np.zeros_like(t) if cache_dtype == "int8" else t)
               for name, t in tables.items()}
    params = {"params": {name: {"embedding": jnp.asarray(carrier[name])}
                         for name in PLANES}}
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)
    jgrads = {"params": {name: {"embedding": jnp.asarray(grads[name])}
                         for name in PLANES}}
    _, opt_state = tx.update(jgrads, opt_state, params)
    jstate = JaxState(step=jnp.asarray(1, jnp.int32), params=params,
                      opt_state=opt_state,
                      model_state={"quantized": quantized}
                      if quantized else {})
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for name in PLANES:
        getattr(model, name).embedding.grad = torch.from_numpy(grads[name])
    # one step moves the parameters: put the carried values back
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt.step()
    model.load_state_dict(before)
    return jstate, PortState(step=1, model=model, optimizer=opt)


JAX_PATHS = {name: ("params", name, "embedding") for name in PLANES}
PORT_PATHS = {name: name for name in PLANES}


# int8 scales: XLA on the CPU rewrites quantize_rows' division by 127
# into a product by its reciprocal inside the JAX seam's jitted
# admission, one ulp apart in about 4.5% of rows; the port divides, bit
# for bit the JAX package's quantize_rows run eagerly and its host mirror
# (checked exactly below).  So scales and the reads built on them are
# held to that ulp, and the codes bit for bit.
SCALE_ULP = 1
INT8_READ_RTOL = 2.4e-7


def _assert_tables_match(pstate, jstate, cache_dtype):
    for name in PLANES:
        arena = getattr(pstate.model, name)
        want_carrier = np.asarray(jstate.params["params"][name]["embedding"])
        np.testing.assert_array_equal(arena.embedding.detach().numpy(),
                                      want_carrier, err_msg=name)
        if cache_dtype == "int8":
            planes = jstate.model_state["quantized"][name]["embedding"]
            np.testing.assert_array_equal(arena.q8.numpy(),
                                          np.asarray(planes["q8"]))
            np.testing.assert_array_max_ulp(
                arena.scale.numpy(), np.asarray(planes["scale"]),
                maxulp=SCALE_ULP)


def _assert_reads_match(got, want, cache_dtype):
    for name in PLANES:
        if cache_dtype == "int8":
            np.testing.assert_allclose(got[name], want[name],
                                       rtol=INT8_READ_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_apply_admissions_and_read_rows_match_the_jax_seam(cache_dtype):
    jstate, pstate = _states(cache_dtype)
    slots = np.array([3, 7, 11, 19], np.int32)
    rng = np.random.default_rng(1)
    values = {name: (rng.standard_normal((slots.size, dim)) * 3).astype(
        np.float32) for name, dim in PLANES.items()}
    jstate = jax_device.apply_admissions(jstate, JAX_PATHS, slots, values,
                                         cache_dtype=cache_dtype)
    out = port_device.apply_admissions(pstate, PORT_PATHS, slots, values,
                                       cache_dtype=cache_dtype)
    assert out is pstate
    _assert_tables_match(pstate, jstate, cache_dtype)
    for name in PLANES:
        arena = getattr(pstate.model, name)
        if cache_dtype == "int8":
            # round-to-nearest admissions: the JAX package's quantize
            # numerics (its host mirror), bit for bit
            q8, scale = jax_arena.quantize_rows_host(values[name])
            np.testing.assert_array_equal(arena.q8.numpy()[slots], q8)
            np.testing.assert_array_equal(arena.scale.numpy()[slots], scale)
            assert not arena.embedding.detach().numpy()[slots].any()
        else:
            np.testing.assert_array_equal(
                arena.embedding.detach().numpy()[slots], values[name])
        # the admitted rows' moments are zero, the others untouched
        moments = pstate.optimizer.state[arena.embedding]
        for key in ("exp_avg", "exp_avg_sq"):
            m = moments[key].numpy()
            assert not m[slots].any()
            others = np.setdiff1d(np.arange(CACHE_ROWS), slots)
            assert m[others].all()
        assert float(moments["step"]) == 1.0    # the count stays
    got = port_device.read_rows(pstate, PORT_PATHS, slots[::-1],
                                cache_dtype=cache_dtype)
    want = jax_device.read_rows(jstate, JAX_PATHS, slots[::-1],
                                cache_dtype=cache_dtype)
    _assert_reads_match(got, want, cache_dtype)
    _assert_reads_match(
        port_device.read_full_tables(pstate, PORT_PATHS,
                                     cache_dtype=cache_dtype),
        jax_device.read_full_tables(jstate, JAX_PATHS,
                                    cache_dtype=cache_dtype), cache_dtype)
    if cache_dtype == "int8":
        planes = port_device.read_full_planes(pstate, PORT_PATHS)
        for name in PLANES:
            arena = getattr(pstate.model, name)
            np.testing.assert_array_equal(planes[name]["q8"],
                                          arena.q8.numpy())
            np.testing.assert_array_equal(planes[name]["scale"],
                                          arena.scale.numpy())


def test_int8_admission_zeroes_a_stale_carrier_delta():
    _, pstate = _states("int8")
    arena = pstate.model.fm_embedding
    with torch.no_grad():
        arena.embedding.fill_(0.25)         # a delta left in the slots
    slots = np.array([2, 5], np.int32)
    values = {name: np.ones((2, dim), np.float32)
              for name, dim in PLANES.items()}
    port_device.apply_admissions(pstate, PORT_PATHS, slots, values,
                                 cache_dtype="int8")
    carrier = arena.embedding.detach().numpy()
    assert not carrier[slots].any() and (carrier[[0, 1, 3]] == 0.25).all()
    got = port_device.read_rows(pstate, PORT_PATHS, slots,
                                cache_dtype="int8")
    np.testing.assert_array_equal(got["fm_embedding"], 1.0)


def test_seam_without_optimizer_state_and_padding():
    """An optimizer that has not stepped holds no state to zero; padded
    duplicate indices write identical values; zero_cache_slots zeroes."""
    model = _Cache()
    state = PortState(step=0, model=model,
                      optimizer=torch.optim.Adam(model.parameters()))
    assert port_device._pad_bucket(1) == 64
    assert port_device._pad_bucket(65) == 256
    assert port_device._pad_bucket(257) == 1024
    slots = np.arange(0, 30, 3, dtype=np.int32)
    values = {name: np.full((slots.size, dim), 2.0, np.float32)
              for name, dim in PLANES.items()}
    port_device.apply_admissions(state, PORT_PATHS, slots, values)
    assert not state.optimizer.state
    table = model.fm_embedding.embedding.detach().numpy()
    np.testing.assert_array_equal(table[slots], 2.0)
    port_device.zero_cache_slots(state, PORT_PATHS, slots[:2])
    np.testing.assert_array_equal(table[slots[:2]], 0.0)
    np.testing.assert_array_equal(table[slots[2:]], 2.0)
    with pytest.raises(ValueError, match="quantized planes"):
        port_device.read_rows(state, PORT_PATHS, slots, cache_dtype="int8")


# ---- the store, driven on both packages --------------------------------


@pytest.mark.parametrize("host_dtype,cache_dtype", [
    ("fp32", "float32"), ("int8", "float32"), ("fp32", "int8")])
def test_driven_store_matches_the_jax_store(host_dtype, cache_dtype):
    """prepare + apply_plan over a stream that evicts and re-admits
    rows, with a "training" perturbation of the cache after each apply:
    slots, plans, the host tier, the cache map and the cache values stay
    equal bit for bit between the packages."""
    port = PortStore(PLANES, NUM_FIELDS, 256, host_dtype=host_dtype,
                     cache_dtype=cache_dtype)
    ref = JaxStore(PLANES, NUM_FIELDS, 256, host_dtype=host_dtype,
                   cache_dtype=cache_dtype)
    jstate, pstate = _fresh_states(256, cache_dtype)
    for k, sparse in enumerate(zipf_stream(steps=10, batch=8)):
        got_slots, got = port.prepare(sparse)
        want_slots, want = ref.prepare(sparse)
        np.testing.assert_array_equal(got_slots, want_slots)
        _assert_plans_equal(got, want)
        np.testing.assert_array_equal(got.deferred, want.deferred)
        jstate = ref.apply_plan(jstate, want)
        port.apply_plan(pstate, got)
        # a stand-in for training: move every resident value alike
        jstate, pstate = _perturb(jstate, pstate, 0.5 + k, cache_dtype)
    _assert_tables_match(pstate, jstate, cache_dtype)
    got, want = port.host.state_dict(), ref.host.state_dict()
    for key in want:
        if cache_dtype == "int8" and key.endswith("_fp32"):
            # write-backs of int8 cache rows: the scales' ulp, above
            np.testing.assert_allclose(got[key], want[key],
                                       rtol=INT8_READ_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(port.cache.row_of, ref.cache.row_of)
    gs, ws = port.stats(), ref.stats()
    for key in ("hits", "misses", "growth_rows", "vocab_rows",
                "cache_occupancy_rows", "device_cache_bytes", "fold_ticks",
                "host_bytes"):
        assert gs[key] == ws[key], key
    assert gs["fold_ticks"] > 0


def _fresh_states(rows, cache_dtype):
    """Both states at `rows` cache rows, zero-initialised."""
    model = nn.Module()
    model.fm_embedding = TieredArena(rows, DIM, cache_dtype)
    model.fm_linear = TieredArena(rows, 1, cache_dtype)
    params = {"params": {}}
    quantized = {}
    with torch.no_grad():
        for name, dim in PLANES.items():
            arena = getattr(model, name)
            arena.embedding.zero_()
            params["params"][name] = {
                "embedding": jnp.zeros((rows, dim), jnp.float32)}
            if cache_dtype == "int8":
                arena.q8.zero_()
                arena.scale.fill_(1.0)
                quantized[name] = {"embedding": {
                    "q8": jnp.zeros((rows, dim), jnp.int8),
                    "scale": jnp.ones((rows, 1), jnp.float32)}}
    jstate = JaxState(step=jnp.asarray(0, jnp.int32), params=params,
                      opt_state=optax.adam(1e-3).init(params),
                      model_state={"quantized": quantized}
                      if quantized else {})
    return jstate, PortState(step=0, model=model,
                             optimizer=torch.optim.Adam(model.parameters()))


def _perturb(jstate, pstate, amount, cache_dtype):
    """Add `amount` to every cache value (int8: through the carrier, a
    delta the next read adds, as a step's would before its fold)."""
    params = jax.tree.map(lambda t: t + amount, jstate.params)
    with torch.no_grad():
        for p in pstate.model.parameters():
            p.add_(amount)
    del cache_dtype
    return jstate.replace(params=params), pstate


# ---- the port stands alone ---------------------------------------------

STORE_MODULES = (
    "elasticdl_tpu_torch.store",
    "elasticdl_tpu_torch.store.host_tier",
    "elasticdl_tpu_torch.store.cache",
    "elasticdl_tpu_torch.store.device",
    "elasticdl_tpu_torch.store.tiered",
    "elasticdl_tpu_torch.store.checkpoint",
    "elasticdl_tpu_torch.store.serving",
    "elasticdl_tpu_torch.model_zoo.deepfm.deepfm_tiered",
)


def test_store_modules_import_with_jax_and_the_reference_blocked():
    """The slice's modules import with jax, the JAX package and the JAX
    zoo blocked (tests/test_torch_isolation.py scans their sources for
    lazy imports with every other port module)."""
    import os
    import subprocess
    import sys

    from tests.test_torch_isolation import BLOCKED, REPO

    script = (
        "import importlib, importlib.abc, sys\n"
        f"BLOCKED = {BLOCKED!r}\n"
        "def blocked(n):\n"
        "    return any(n == b or n.startswith(b + '.') for b in BLOCKED)\n"
        "class Blocker(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if blocked(name):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Blocker())\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for name in {STORE_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not [n for n in sys.modules if blocked(n)]\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_both_packages_start_from_one_store_state():
    """A store state crosses as numpy (`HostTier.state_dict`,
    `HotRowCache.state_arrays`): the port's store adopts the JAX store's
    and plans the next batches as the JAX store does, bit for bit."""
    stream = zipf_stream(steps=8, batch=8)
    ref = JaxStore(PLANES, NUM_FIELDS, 256)
    for sparse in stream[:5]:
        ref.prepare(sparse)
    row_of, score, dtype = ref.cache.state_arrays()
    port = PortStore(PLANES, NUM_FIELDS, 256)
    port.load_sidecar_state(ref.host.state_dict(), row_of, score,
                            cache_dtype=dtype)
    np.testing.assert_array_equal(port.cache.row_of, ref.cache.row_of)
    assert port.host.size == ref.host.size
    for sparse in stream[5:]:
        got_slots, got = port.prepare(sparse)
        want_slots, want = ref.prepare(sparse)
        np.testing.assert_array_equal(got_slots, want_slots)
        _assert_plans_equal(got, want)
    for mine, theirs in zip(port.cache.state_arrays()[:2],
                            ref.cache.state_arrays()[:2]):
        np.testing.assert_array_equal(mine, theirs)

"""The tiered store's cache row-sharded over `model`.

- Twins of tests/test_tiered_store.py's mesh-seam tests: the port's
  `partition_plan` splits a plan exactly as the JAX one does (their
  union is the plan), and a store with `set_mesh_shards` attaches
  sub-plans, with the JAX store's error for a count that does not
  divide the cache.
- A world of 4 gloo ranks trains the port's tiered DeepFM from the JAX
  init, fp32 and int8 cache, on data=2 x model=2 and on data=1 x
  model=4, every rank planning each global batch with its own store:
  the plans (digests) are equal on every rank, each rank's admissions
  are its sub-plan, the losses match the JAX tiered Trainer on a
  data=2 x model=2 mesh of the 8-device CPU mesh, and on model=4 (no
  layout splits the batch) the gathered cache tables, the host tier and
  every tensor are the one-rank run's bit for bit; the checkpoint saved
  on data=2 x model=2 (the gathered tree and the store's sidecar)
  restores on the mesh and on one rank.

Tolerance: against JAX, tests/test_torch_tiered.py's LOSS_TOL (1e-5,
f32) for the fp32 cache; the int8 cache's codes differ by up to one
rounding step after each fold (the two packages draw from different
generators), so its losses are held within 1e-4, as
tests/test_torch_sharded_int8.py holds the flat int8 arena's.  Against
one rank on data=2 x model=2: gradients summed over `data` in another
order, 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_world import run_world
from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.parallel import mesh as jax_mesh
from elasticdl_tpu.store.cache import HotRowCache as JaxCache
from elasticdl_tpu.store.cache import partition_plan as jax_partition
from elasticdl_tpu.store.tiered import TieredStore as JaxStore
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common.weights import flatten_params
from elasticdl_tpu_torch.store.cache import HotRowCache, partition_plan
from elasticdl_tpu_torch.store.tiered import TieredStore

torch.set_num_threads(2)

TIERED = "deepfm.deepfm_tiered.custom_model"
NUM_FIELDS = 26
DIM = 4
PLANES = {"fm_embedding": DIM, "fm_linear": 1}
CACHE_ROWS = 512
STEPS = 4
LOSS_TOL = {"float32": 1e-5, "int8": 1e-4}
ONE_RANK_LOSS_TOL = 1e-5


# ---- the sub-plans, as in the JAX store ----------------------------------


def test_partition_plan_union_equals_unsharded_plan():
    """The twin of tests/test_tiered_store.py:1044: the sub-plans are an
    order-preserving partition of the plan, every slot in its block,
    and equal to the JAX partition of the JAX cache's plan."""
    cache_rows, shards = 64, 4
    cache, jcache = HotRowCache(cache_rows), JaxCache(cache_rows)
    for rows in (np.arange(60), np.arange(40, 100)):   # the 2nd evicts
        plan, jplan = cache.plan(rows), jcache.plan(rows)
        subs = partition_plan(plan, shards, cache_rows)
        jsubs = jax_partition(jplan, shards, cache_rows)
        assert len(subs) == shards
        block = cache_rows // shards
        for d, (sp, jsp) in enumerate(zip(subs, jsubs)):
            assert sp["device"] == d == jsp["device"]
            assert (sp["slot_lo"], sp["slot_hi"]) == (d * block,
                                                      (d + 1) * block)
            for key in ("admit_slots", "evict_slots", "admit_rows",
                        "evict_rows"):
                np.testing.assert_array_equal(sp[key], jsp[key])
            for key in ("admit_slots", "evict_slots"):
                s = sp[key]
                assert ((s >= sp["slot_lo"]) & (s < sp["slot_hi"])).all()
        for kind in ("admit", "evict"):
            got_slots = np.concatenate([sp[f"{kind}_slots"] for sp in subs])
            got_rows = np.concatenate([sp[f"{kind}_rows"] for sp in subs])
            want_slots = getattr(plan, f"{kind}_slots")
            want_rows = getattr(plan, f"{kind}_rows")
            order = np.argsort(want_slots, kind="stable")
            np.testing.assert_array_equal(np.sort(got_slots),
                                          want_slots[order])
            np.testing.assert_array_equal(
                got_rows[np.argsort(got_slots, kind="stable")],
                want_rows[order])
    with pytest.raises(ValueError):
        partition_plan(plan, 7, cache_rows)       # 64 % 7 != 0


def test_store_emits_sub_plans_when_mesh_sharded():
    """The twin of tests/test_tiered_store.py:1084, beside the JAX
    store: the same sub-plans, and the same error at 5 shards."""
    stores = (TieredStore(PLANES, NUM_FIELDS, 32),
              JaxStore(PLANES, NUM_FIELDS, 32))
    sparse = np.arange(NUM_FIELDS, dtype=np.int64)[None, :] + 900
    plans = []
    for store in stores:
        assert store.stats()["mesh_shards"] == 1
        _, plan = store.prepare(sparse)
        assert plan.sub_plans is None
        store.set_mesh_shards(4)
        assert store.stats()["mesh_shards"] == 4
        _, plan = store.prepare(sparse + 100)
        assert plan.sub_plans is not None and len(plan.sub_plans) == 4
        assert sum(sp["admit_slots"].size for sp in plan.sub_plans) \
            == plan.admit_slots.size
        plans.append(plan)
    for sp, jsp in zip(*(p.sub_plans for p in plans)):
        for key in ("admit_slots", "admit_rows", "evict_slots"):
            np.testing.assert_array_equal(sp[key], jsp[key])
    errors = []
    for store in stores:
        with pytest.raises(ValueError) as err:
            store.set_mesh_shards(5)              # 32 % 5 != 0
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ---- a tiered DeepFM on the mesh -----------------------------------------


def _batches(n=16, seed=3):
    """Ids from 64 per field: a batch touches at most 26 * 16 rows, and
    the vocabulary grows past the cache, so later plans evict."""
    rng = np.random.RandomState(seed)
    return [{"features": {
        "dense": rng.rand(n, 13).astype(np.float32),
        "sparse": rng.randint(0, 64, size=(n, NUM_FIELDS)).astype(
            np.int64)},
        "labels": rng.randint(0, 2, size=(n,)).astype(np.int32)}
        for _ in range(STEPS)]


def _params(cache_dtype):
    return (f"cache_rows={CACHE_ROWS};embed_dim={DIM};lr=0.005;"
            f"cache_dtype='{cache_dtype}'")


@pytest.fixture(scope="module", params=["float32", "int8"])
def tiered_world(request, tmp_path_factory):
    cache_dtype = request.param
    params = _params(cache_dtype)
    batches = _batches()
    js = jax_spec("model_zoo", TIERED, model_params=params)
    jt = JaxTrainer(js.model, js.optimizer, js.loss,
                    mesh=jax_mesh.create_mesh(jax.devices()[:4], data=2,
                                              model=2),
                    param_sharding_fn=js.param_sharding)
    jstore = JaxStore(PLANES, NUM_FIELDS, CACHE_ROWS,
                      cache_dtype=cache_dtype)
    jstore.set_mesh_shards(2)
    jt.tiered_store = jstore
    sample = {"dense": batches[0]["features"]["dense"],
              "slots": np.zeros((16, NUM_FIELDS), np.int32)}
    state = jt.init_state(jax.random.PRNGKey(0), sample)
    flat = flatten_params(jax.tree.map(np.asarray, state.params["params"]))
    quantized = None
    if cache_dtype == "int8":
        quantized = flatten_params(jax.tree.map(
            np.asarray, state.model_state["quantized"]))

    def jax_steps():
        nonlocal state
        losses, digests = [], []
        for batch in batches:
            batch = jstore.attach({"features": dict(batch["features"]),
                                   "labels": batch["labels"]})
            state, loss = jt.train_on_batch(state, batch)
            losses.append(float(loss))
        return losses

    tmp = tmp_path_factory.mktemp(f"tiered_{cache_dtype}")
    ckpt = str(tmp / "ckpt")
    got, losses = run_world(
        4, "_torch_parallel_ranks:tiered_on_meshes",
        (params, flat, quantized, batches, PLANES, CACHE_ROWS, cache_dtype,
         ckpt), tmp, meanwhile=jax_steps)
    return cache_dtype, losses, jstore.stats(), got, ckpt


def test_every_rank_plans_alike_and_admits_its_sub_plan(tiered_world):
    _, _, jax_stats, got, _ = tiered_world
    for layout, shards in (("dm", 2), ("m4", 4)):
        digests = got[0][layout]["digests"]
        assert len(set(digests)) == STEPS
        evicted = False
        for result in got:
            mine = result[layout]
            assert mine["digests"] == digests
            assert mine["mesh_shards"] == shards
            block = CACHE_ROWS // shards
            first = mine["coords"]["model"] * block
            for slots, sub in mine["applied"]:
                np.testing.assert_array_equal(slots, sub)
                assert ((slots >= first) & (slots < first + block)).all()
            stats = mine["stats"]
            assert stats["misses"] == jax_stats["misses"]
            evicted |= stats["vocab_rows"] > CACHE_ROWS
        assert evicted


def test_losses_match_jax_and_one_rank(tiered_world):
    cache_dtype, losses, _, got, _ = tiered_world
    one = got[0]["one"]["losses"]
    for result in got:
        for layout in ("dm", "m4"):
            np.testing.assert_allclose(result[layout]["losses"], losses,
                                       atol=LOSS_TOL[cache_dtype], rtol=0)
        np.testing.assert_allclose(result["dm"]["losses"], one,
                                   atol=ONE_RANK_LOSS_TOL, rtol=0)


def test_model4_is_the_one_rank_run_bit_for_bit(tiered_world):
    _, _, _, got, _ = tiered_world
    one = got[0]["one"]
    for result in got:
        mine = result["m4"]
        assert mine["losses"] == one["losses"]
        for name, want in one["state"].items():
            assert torch.equal(mine["state"][name], want), name
        for name, want in one["cache_tables"].items():
            assert np.array_equal(mine["cache_tables"][name], want), name
        for name, want in one["host"].items():
            assert np.array_equal(mine["host"][name], want), name


def test_the_cache_tables_shard_with_the_trainer(tiered_world):
    cache_dtype, _, _, got, _ = tiered_world
    leaves = ("embedding",) + (("q8", "scale") if cache_dtype == "int8"
                               else ())
    for layout, shards in (("dm", 2), ("m4", 4)):
        for result in got:
            mine = result[layout]
            for name in PLANES:
                for leaf in leaves:
                    assert mine["shardings"][f"{name}.{leaf}"] == (
                        "model", None)
                    assert mine["shapes"][f"{name}.{leaf}"][0] == \
                        CACHE_ROWS // shards
            # one scatter-add per plane and step, at the block's rows
            for step in mine["scatters"]:
                assert sorted(step) == [(CACHE_ROWS // shards, 1),
                                        (CACHE_ROWS // shards, DIM)]


def test_the_tiered_checkpoint_restores_on_the_mesh_and_one_rank(
        tiered_world):
    """Saved on data=2 x model=2: each rank's restored block is its block
    of the saved tree and its store the saved store; on one rank the
    whole tree and the store come back."""
    from elasticdl_tpu_torch.common import model_handler
    from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
    from elasticdl_tpu_torch.worker.trainer import Trainer

    cache_dtype, _, _, got, ckpt = tiered_world
    saved = got[0]["dm"]
    for result in got:
        mine = result["dm"]
        assert mine["restored_step"] == STEPS
        model = mine["coords"]["model"]
        for name, value in mine["restored"].items():
            want = saved["state"][name]
            if mine["shardings"].get(name) is not None:
                rows = value.shape[0]
                want = want[model * rows:(model + 1) * rows]
            assert torch.equal(value, want), name
        for name, want in saved["host"].items():
            assert np.array_equal(mine["restored_host"][name], want), name
    spec = model_handler.get_model_spec(model_handler.ZOO_DIR, TIERED,
                                        model_params=_params(cache_dtype))
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, device="cpu")
    store = TieredStore(PLANES, NUM_FIELDS, CACHE_ROWS,
                        cache_dtype=cache_dtype)
    saver = CheckpointSaver(ckpt)
    saver.attach_tiered_store(store)
    state = trainer.init_state(7, {"dense": np.zeros((2, 13), np.float32),
                                   "slots": np.zeros((2, NUM_FIELDS),
                                                     np.int32)})
    assert saver.maybe_restore(state) is state and state.step == STEPS
    for name, want in saved["state"].items():
        assert torch.equal(state.model.state_dict()[name], want), name
    for name, want in saved["host"].items():
        assert np.array_equal(store.host.state_dict()[name], want), name
    np.testing.assert_array_equal(store.cache.row_of,
                                  got[0]["dm"]["restored_row_of"])

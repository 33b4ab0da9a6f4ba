"""The port's tiered DeepFM, trainer hooks, sidecars and serving against
the JAX package's, on the CPU:

- the tiered model's forward from the carried flax init (fp32, bf16,
  int8 cache) and three train steps through both Trainers, each with its
  own store, within the flat DeepFM tests' tolerances;
- inside the port, bit for bit: tiered against flat on an all-hot,
  collision-free working set with the host tier backfilled from the flat
  init, and a K = 8 union block against the flat 8-step stack (the twins
  of tests/test_tiered_store.py's parity tests);
- sidecars: each package reads the other's, array for array; keep-K
  pruning in lockstep with the steps; tiered -> flat -> tiered migration
  equal to the JAX helpers'; two reference races, shown on the JAX store
  and absent from the port's (a fold in flight, plans made ahead);
- TieredServingEngine: known, cold and unknown ids translated as the
  JAX engine translates them, a hot swap that drops no request, through
  the reloader too, and a swap without a sidecar rejected.

Small configuration: embed dim 4, MLP (256, 128) as the zoo's default
for the parity runs and (8, 4) for the serving model, caches of at most
1024 rows.
"""

import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.store import checkpoint as jax_ckpt
from elasticdl_tpu.store.serving import TieredServingEngine as JaxServing
from elasticdl_tpu.store.tiered import TieredStore as JaxStore
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu.worker.trainer import TrainState as JaxState
from elasticdl_tpu_torch.common import model_handler as port_handler
from elasticdl_tpu_torch.common import save_utils
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.layers.arena import TieredArena
from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_tiered as port_zoo
from elasticdl_tpu_torch.serving.engine import ServingEngine
from elasticdl_tpu_torch.serving.reloader import CheckpointReloader
from elasticdl_tpu_torch.store import checkpoint as port_ckpt
from elasticdl_tpu_torch.store.serving import TieredServingEngine
from elasticdl_tpu_torch.store.tiered import TieredStore as PortStore
from elasticdl_tpu_torch.worker.trainer import Trainer as PortTrainer
from elasticdl_tpu_torch.worker.trainer import TrainState as PortState

torch.set_num_threads(2)

NUM_FIELDS = 26
DIM = 4
PLANES = {"fm_embedding": DIM, "fm_linear": 1}
FLAT = "deepfm.deepfm_functional_api.custom_model"
TIERED = "deepfm.deepfm_tiered.custom_model"
# between the packages: tests/test_torch_deepfm.py's tolerances (f32: the
# same sums in another order; bf16: one or two bf16 rounding steps of the
# MLP)
F32_TOL = 1e-5
BF16_TOL = 1e-2
# f32 losses over 3 Adam steps from one init: tests/test_torch_trainer.py
# measured 1.4e-6 over 8 flat steps
LOSS_TOL = 1e-5
# inside the port, a separately run predict of the same weights: the
# reference allows 4 ulp (tests/test_tiered_store.py); the port's eager
# forward gives the same bits here, the bound stays the reference's
PRED_ULP_TOL = 4 * np.finfo(np.float32).eps


def hash_rows(fields, ids, cap):
    return port_zoo.flat_rows_host(fields, ids, cap)


def _port_spec(model_def, params):
    return port_handler.get_model_spec(port_handler.ZOO_DIR, model_def,
                                       model_params=params)


def _features(batch, seed, sparse):
    rng = np.random.RandomState(seed)
    return {"dense": rng.rand(batch, 13).astype(np.float32),
            "sparse": sparse}


def _collision_free_ids(cap, ids_per_field, seed):
    """(26, ids_per_field) raw ids whose flat rows never collide."""
    rng = np.random.RandomState(seed)
    cand = rng.randint(0, 1 << 22, size=(NUM_FIELDS, ids_per_field * 8))
    cand_rows = hash_rows(
        np.repeat(np.arange(NUM_FIELDS)[:, None], cand.shape[1], 1),
        cand, cap)
    seen, sel = set(), np.zeros((NUM_FIELDS, ids_per_field), np.int32)
    for f in range(NUM_FIELDS):
        picked = 0
        for j in range(cand.shape[1]):
            row = int(cand_rows[f, j])
            if row not in seen:
                seen.add(row)
                sel[f, picked] = cand[f, j]
                picked += 1
                if picked == ids_per_field:
                    break
        assert picked == ids_per_field
    return sel


def _batch_at(sel, step, batch, seed0):
    brng = np.random.RandomState(seed0 + step)
    pick = brng.randint(0, sel.shape[1], (batch, NUM_FIELDS))
    return {
        "features": {
            "dense": brng.rand(batch, 13).astype(np.float32),
            "sparse": sel[np.arange(NUM_FIELDS)[None, :], pick],
        },
        "labels": brng.randint(0, 2, batch).astype(np.int32),
    }


# ---- the model against flax --------------------------------------------


def _jax_tiered(cache_rows, bf16=False, cache_dtype="float32"):
    from model_zoo.deepfm import deepfm_tiered as jax_zoo

    return jax_zoo.custom_model(cache_rows=cache_rows, embed_dim=DIM,
                                bf16=bf16, cache_dtype=cache_dtype)


def _carry(jax_variables, port_model):
    flat = flatten_params(jax.tree.map(np.asarray,
                                       jax_variables["params"]))
    quantized = None
    if "quantized" in jax_variables:
        quantized = flatten_params(jax.tree.map(
            np.asarray, jax_variables["quantized"]))
    port_model.load_state_dict(
        params_from_jax(port_model, flat, quantized=quantized), strict=True)


def _serving_features(batch, cache_rows, seed):
    rng = np.random.RandomState(seed)
    slots = rng.randint(0, cache_rows, (batch, NUM_FIELDS)).astype(np.int32)
    slots[rng.rand(batch, NUM_FIELDS) < 0.2] = -1
    return {
        "dense": (rng.rand(batch, 13) * 20).astype(np.float32),
        "slots": slots,
        "cold_fm": rng.randn(batch, NUM_FIELDS, DIM).astype(np.float32),
        "cold_linear": rng.randn(batch, NUM_FIELDS, 1).astype(np.float32),
    }


@pytest.mark.parametrize("bf16,cache_dtype", [
    (False, "float32"), (True, "float32"), (False, "int8")],
    ids=["f32", "bf16", "int8"])
def test_tiered_forward_matches_flax(bf16, cache_dtype):
    cache_rows = 256
    jax_model = _jax_tiered(cache_rows, bf16, cache_dtype)
    feats = _serving_features(16, cache_rows, seed=1)
    variables = jax_model.init(jax.random.PRNGKey(0), feats)
    port_model = port_zoo.custom_model(cache_rows=cache_rows, embed_dim=DIM,
                                       bf16=bf16, cache_dtype=cache_dtype)
    _carry(variables, port_model)
    want = np.asarray(jax_model.apply(variables, feats), np.float32)
    with torch.no_grad():
        got = port_model({k: torch.from_numpy(v) for k, v in feats.items()})
        # without overlays every slot must be resident
        hot = {k: v for k, v in feats.items() if not k.startswith("cold")}
        hot["slots"] = np.maximum(hot["slots"], 0)
        got_hot = port_model({k: torch.from_numpy(v) for k, v in
                              hot.items()})
    tol = BF16_TOL if bf16 else F32_TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        got_hot.numpy(),
        np.asarray(jax_model.apply(variables, hot), np.float32),
        rtol=tol, atol=tol)
    if cache_dtype == "int8":
        assert port_model.fm_embedding.q8.dtype == torch.int8
        assert not port_model.fm_embedding.embedding.detach().any()


def test_overlay_is_detached_and_slots_gather_through_the_scatter_path():
    model = port_zoo.custom_model(cache_rows=64, embed_dim=DIM)
    feats = _serving_features(4, 64, seed=2)
    feats = {k: torch.from_numpy(v) for k, v in feats.items()}
    feats["cold_fm"].requires_grad_(True)
    model(feats).sum().backward()
    assert feats["cold_fm"].grad is None
    grad = model.fm_embedding.embedding.grad
    touched = torch.unique(feats["slots"][feats["slots"] >= 0])
    rows_with_grad = torch.nonzero(grad.abs().sum(1)).reshape(-1)
    assert set(rows_with_grad.tolist()) <= set(touched.tolist())


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_three_train_steps_match_the_jax_trainer(bf16):
    """Both Trainers from the carried flax init, each with its own store
    (no backfill: both tiers grow rows with the same deterministic
    init): the plans are equal bit for bit, the losses within
    tolerance."""
    params = f"cache_rows=512;embed_dim={DIM};lr=0.005"
    if bf16:
        params += ";bf16=True"
    js = jax_spec("model_zoo", TIERED, model_params=params)
    jt = JaxTrainer(js.model, js.optimizer, js.loss, use_bf16=bf16,
                    param_sharding_fn=js.param_sharding)
    ps = _port_spec(TIERED, params)
    pt = PortTrainer(ps.model, ps.optimizer, ps.loss, use_bf16=bf16,
                     device="cpu")
    jstore = JaxStore(PLANES, NUM_FIELDS, 512)
    pstore = PortStore(PLANES, NUM_FIELDS, 512)
    jt.tiered_store, pt.tiered_store = jstore, pstore
    sel = _collision_free_ids(1 << 13, 6, seed=11)
    batches = [_batch_at(sel, s, 32, 500) for s in range(3)]
    sample = {"dense": batches[0]["features"]["dense"],
              "slots": np.zeros((32, NUM_FIELDS), np.int32)}
    jstate = jt.init_state(jax.random.PRNGKey(0), sample)
    pstate = pt.init_state(0, sample)
    _carry({"params": jstate.params["params"]}, pstate.model)
    jlosses, plosses = [], []
    for b in batches:
        jb = jstore.attach({"features": dict(b["features"]),
                            "labels": b["labels"]})
        pb = pstore.attach({"features": dict(b["features"]),
                            "labels": b["labels"]})
        np.testing.assert_array_equal(pb["features"]["slots"],
                                      jb["features"]["slots"])
        jstate, jl = jt.train_on_batch(jstate, jb)
        pstate, pl = pt.train_on_batch(pstate, pb)
        jlosses.append(float(jl))
        plosses.append(float(pl))
    tol = BF16_TOL if bf16 else LOSS_TOL
    np.testing.assert_allclose(plosses, jlosses, rtol=0, atol=tol)
    assert pstore.stats()["misses"] == jstore.stats()["misses"] > 0


# ---- inside the port: tiered against flat, bit for bit -----------------


def _flat_and_tiered(cap, cache_rows, batch, sel, seed0, deferred=False,
                     cache_dtype="float32"):
    """The port's flat and tiered trainers from one init: the tiered
    dense layers filled from the flat state (fill_matching), its host
    tier backfilled from the flat tables (flat_backfill)."""
    flat_spec = _port_spec(FLAT, f"vocab_capacity={cap};embed_dim={DIM};"
                                 f"arena_dtype='{cache_dtype}'")
    tier_spec = _port_spec(TIERED, f"cache_rows={cache_rows};embed_dim={DIM};"
                                   f"cache_dtype='{cache_dtype}'")
    flat_tr = PortTrainer(flat_spec.model, flat_spec.optimizer,
                          flat_spec.loss, device="cpu")
    tier_tr = PortTrainer(tier_spec.model, tier_spec.optimizer,
                          tier_spec.loss, device="cpu")
    b0 = _batch_at(sel, 0, batch, seed0)
    flat_state = flat_tr.init_state(0, b0["features"])
    tier_state = tier_tr.init_state(
        1, {"dense": b0["features"]["dense"],
            "slots": np.zeros((batch, NUM_FIELDS), np.int32)})
    flat_sd = flat_state.model.state_dict()
    tier_state.model.load_state_dict(port_ckpt.fill_matching(
        tier_state.model.state_dict(), flat_sd))
    if cache_dtype == "int8":
        from elasticdl_tpu_torch.layers.arena import dequantize_rows

        flat_init = {name: dequantize_rows(flat_sd[f"{name}.q8"],
                                           flat_sd[f"{name}.scale"]).numpy()
                     for name in PLANES}
    else:
        flat_init = {name: flat_sd[f"{name}.embedding"].numpy().copy()
                     for name in PLANES}
    store = PortStore(PLANES, NUM_FIELDS, cache_rows,
                      cache_dtype=cache_dtype)
    store.host.set_backfill(port_ckpt.flat_backfill(
        flat_init, lambda f, i: hash_rows(f, i, cap)))
    if deferred:
        store.enable_deferred_prepare()
    tier_tr.tiered_store = store
    return flat_tr, flat_state, tier_tr, tier_state, store


@pytest.fixture(scope="module")
def parity():
    cap, cache_rows, batch, steps = 1 << 13, 1024, 32, 3
    sel = _collision_free_ids(cap, 8, seed=7)
    flat_tr, flat_state, tier_tr, tier_state, store = _flat_and_tiered(
        cap, cache_rows, batch, sel, 1000)
    losses = []
    for step in range(steps):
        b = _batch_at(sel, step, batch, 1000)
        flat_state, fl = flat_tr.train_on_batch(flat_state, b)
        tier_state, tl = tier_tr.train_on_batch(
            tier_state, store.attach({"features": dict(b["features"]),
                                      "labels": b["labels"]}))
        losses.append((fl.item(), tl.item()))
    return {"flat_tr": flat_tr, "tier_tr": tier_tr,
            "flat_state": flat_state, "tier_state": tier_state,
            "store": store, "losses": losses, "sel": sel, "cap": cap}


def test_parity_losses_bitwise_equal(parity):
    for fl, tl in parity["losses"]:
        assert fl == tl


def test_parity_trained_rows_bitwise_equal(parity):
    probe = _batch_at(parity["sel"], 10_000, 32, 1000)
    slots, _ = parity["store"].prepare(probe["features"]["sparse"])
    rows = hash_rows(np.arange(NUM_FIELDS)[None, :],
                     probe["features"]["sparse"], parity["cap"])
    for name in PLANES:
        flat = parity["flat_state"].params[f"{name}.embedding"].detach()
        tier = parity["tier_state"].params[f"{name}.embedding"].detach()
        np.testing.assert_array_equal(flat.numpy()[rows],
                                      tier.numpy()[slots])
    # the dense layers trained alike too
    for name, p in parity["flat_state"].params.items():
        if "embedding" not in name:
            np.testing.assert_array_equal(
                p.detach().numpy(),
                parity["tier_state"].params[name].detach().numpy())


def test_parity_predict_within_few_ulp(parity):
    probe = _batch_at(parity["sel"], 10_001, 32, 1000)
    slots, _ = parity["store"].prepare(probe["features"]["sparse"])
    flat_pred = parity["flat_tr"].predict_on_batch(parity["flat_state"],
                                                   probe["features"])
    tier_pred = parity["tier_tr"].predict_on_batch(
        parity["tier_state"],
        {"dense": probe["features"]["dense"], "slots": slots})
    assert np.abs(flat_pred - tier_pred).max() <= PRED_ULP_TOL


def test_fused_block_k8_matches_flat_stack_bitwise():
    cap, cache_rows, batch, k = 1 << 13, 512, 16, 8
    sel = _collision_free_ids(cap, 6, seed=3)
    flat_tr, flat_state, tier_tr, tier_state, store = _flat_and_tiered(
        cap, cache_rows, batch, sel, 4000, deferred=True)
    batches = [_batch_at(sel, s, batch, 4000) for s in range(k)]
    flat_state, flat_losses = flat_tr.train_on_batch_stack(flat_state,
                                                           batches)
    tier_state, tier_losses = tier_tr.train_on_batch_stack(
        tier_state, [store.attach({"features": dict(b["features"]),
                                   "labels": b["labels"]})
                     for b in batches])
    np.testing.assert_array_equal(flat_losses.numpy(), tier_losses.numpy())
    assert store.stats()["block_plans"] == 1


def test_int8_tiered_tracks_int8_flat():
    """int8 caches: the fold's stochastic rounding draws over the table's
    own shape, so tiered and flat round apart (reported, not gated, as
    in the reference); both train and stay finite."""
    cap, cache_rows, batch = 1 << 13, 1024, 32
    sel = _collision_free_ids(cap, 8, seed=7)
    flat_tr, flat_state, tier_tr, tier_state, store = _flat_and_tiered(
        cap, cache_rows, batch, sel, 1000, cache_dtype="int8")
    gaps = []
    for step in range(3):
        b = _batch_at(sel, step, batch, 1000)
        flat_state, fl = flat_tr.train_on_batch(flat_state, b)
        tier_state, tl = tier_tr.train_on_batch(
            tier_state, store.attach({"features": dict(b["features"]),
                                      "labels": b["labels"]}))
        gaps.append(abs(fl.item() - tl.item()))
        assert np.isfinite(tl.item())
    assert gaps[0] == 0.0     # before any fold the two steps agree
    assert not tier_state.model.fm_embedding.embedding.detach().any()


def test_stack_rejects_eagerly_planned_batches():
    spec = _port_spec(TIERED, f"cache_rows=512;embed_dim={DIM}")
    tr = PortTrainer(spec.model, spec.optimizer, spec.loss, device="cpu")
    store = PortStore(PLANES, NUM_FIELDS, 512)
    tr.tiered_store = store
    b = store.attach({
        "features": {"dense": np.zeros((1, 13), np.float32),
                     "sparse": np.arange(NUM_FIELDS)[None, :]},
        "labels": np.zeros(1, np.int32)})
    assert "__store_plan__" in b
    with pytest.raises(ValueError, match="fused multi-step"):
        tr.train_on_batch_stack(None, [b, b])
    staged = tr.stage_batch(b)
    assert staged["__store_plan__"] is b["__store_plan__"]


# ---- sidecars ----------------------------------------------------------

CACHE_ROWS = 32


class _Cache(nn.Module):
    def __init__(self, rows=CACHE_ROWS, cache_dtype="float32"):
        super().__init__()
        self.fm_embedding = TieredArena(rows, DIM, cache_dtype)
        self.fm_linear = TieredArena(rows, 1, cache_dtype)
        with torch.no_grad():
            for p in self.parameters():
                p.zero_()


def _jax_state(cache_dtype="float32"):
    params = {"params": {
        name: {"embedding": jnp.zeros((CACHE_ROWS, dim), jnp.float32)}
        for name, dim in PLANES.items()}}
    model_state = {}
    if cache_dtype == "int8":
        model_state = {"quantized": {name: {"embedding": {
            "q8": jnp.zeros((CACHE_ROWS, dim), jnp.int8),
            "scale": jnp.ones((CACHE_ROWS, 1), jnp.float32)}}
            for name, dim in PLANES.items()}}
    return JaxState(step=jnp.asarray(0, jnp.int32), params=params,
                    opt_state=optax.adam(1e-3).init(params),
                    model_state=model_state)


def _port_state(cache_dtype="float32", rows=CACHE_ROWS):
    model = _Cache(rows, cache_dtype)
    return PortState(step=0, model=model,
                     optimizer=torch.optim.Adam(model.parameters()))


def _raw_id_backfill(store):
    store.host.set_backfill(
        lambda plane, fields, ids: np.repeat(
            ids.astype(np.float32)[:, None], store.planes[plane], axis=1))


BATCHES = [np.arange(NUM_FIELDS, dtype=np.int64)[None, :] + 100,
           np.arange(NUM_FIELDS, dtype=np.int64)[None, :] + 500]


def _driven_pair(cache_dtype="float32", perturb=1.0):
    """The reference tests' `_driven_store`, on both packages: two
    batches on a 32-slot cache, so the second evicts part of the first,
    then `perturb` added to the cache values (a stand-in for training)."""
    jstore = JaxStore(PLANES, NUM_FIELDS, CACHE_ROWS,
                      cache_dtype=cache_dtype)
    pstore = PortStore(PLANES, NUM_FIELDS, CACHE_ROWS,
                       cache_dtype=cache_dtype)
    _raw_id_backfill(jstore)
    _raw_id_backfill(pstore)
    jstate, pstate = _jax_state(cache_dtype), _port_state(cache_dtype)
    for sparse in BATCHES:
        _, plan = jstore.prepare(sparse)
        jstate = jstore.apply_plan(jstate, plan)
        _, plan = pstore.prepare(sparse)
        pstore.apply_plan(pstate, plan)
    if perturb:
        jstate = jstate.replace(params=jax.tree.map(lambda t: t + perturb,
                                                    jstate.params))
        with torch.no_grad():
            for p in pstate.model.parameters():
                p.add_(perturb)
    return jstore, jstate, pstore, pstate


def _npz(path):
    with np.load(os.path.join(path, "store.npz")) as npz:
        return {k: npz[k] for k in npz.files}


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_each_package_reads_the_others_sidecar(tmp_path, cache_dtype):
    jstore, jstate, pstore, pstate = _driven_pair(cache_dtype)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_sidecar(jdir, 7, jstore, jstate)
    if cache_dtype == "int8":
        # serve the port the JAX planes, so the values agree bit for bit
        # (the JAX seam's scales sit an ulp off quantize_rows' division
        # on the CPU; tests/test_torch_store.py)
        sidecar = port_ckpt.load_sidecar(jdir, 7)
        with torch.no_grad():
            for name in PLANES:
                arena = getattr(pstate.model, name)
                arena.q8.copy_(torch.from_numpy(
                    sidecar.cache_planes[name]["q8"]))
                arena.scale.copy_(torch.from_numpy(
                    sidecar.cache_planes[name]["scale"]))
        pstore.host.load_state_dict(sidecar.host_state)
    port_ckpt.save_sidecar(pdir, 7, pstore, pstate)
    jarr, parr = _npz(jax_ckpt.sidecar_dir(jdir, 7)), _npz(
        port_ckpt.sidecar_dir(pdir, 7))
    assert sorted(jarr) == sorted(parr)
    for key in jarr:
        assert jarr[key].dtype == parr[key].dtype, key
        np.testing.assert_array_equal(parr[key], jarr[key], err_msg=key)
    for reader, (a, b) in ((port_ckpt, (jdir, pdir)),
                           (jax_ckpt, (pdir, jdir))):
        mine, theirs = reader.load_sidecar(a, 7), reader.load_sidecar(b, 7)
        assert mine.meta == theirs.meta
        assert mine.cache_dtype == cache_dtype
        for name in PLANES:
            np.testing.assert_array_equal(mine.latest_row_values(name),
                                          theirs.latest_row_values(name))


def test_sidecar_latest_row_values_carry_trained_and_evicted_rows(tmp_path):
    _, _, store, state = _driven_pair()
    port_ckpt.save_sidecar(str(tmp_path), 7, store, state)
    sidecar = port_ckpt.load_sidecar(str(tmp_path), 7)
    fields, ids, rows = sidecar.vocab_arrays()
    latest = sidecar.latest_row_values("fm_embedding")
    resident = set(int(r) for r in sidecar.row_of[sidecar.row_of >= 0])
    assert 0 < len(resident) < store.host.size
    id_of_row = {int(r): int(i) for i, r in zip(ids, rows)}
    for r in range(store.host.size):
        want = float(id_of_row[r]) + (1.0 if r in resident else 0.0)
        np.testing.assert_array_equal(latest[r], np.full(DIM, want))


def test_migration_tiered_to_flat_and_back_matches_jax(tmp_path):
    cap = 1 << 12
    jstore, jstate, pstore, pstate = _driven_pair()
    jax_ckpt.save_sidecar(str(tmp_path), 3, jstore, jstate)
    jside = jax_ckpt.load_sidecar(str(tmp_path), 3)
    pside = port_ckpt.load_sidecar(str(tmp_path), 3)

    def hash_fn(fields, ids):
        return hash_rows(fields, ids, cap)

    templates = {name: np.full((cap, dim), -1.0, np.float32)
                 for name, dim in PLANES.items()}
    want = jax_ckpt.flat_tables_from_sidecar(jside, templates, hash_fn)
    got = port_ckpt.flat_tables_from_sidecar(pside, templates, hash_fn)
    for name in PLANES:
        np.testing.assert_array_equal(got[name], want[name])
    # flat -> tiered: fresh stores backfill grown rows from the tables
    stores = [JaxStore(PLANES, NUM_FIELDS, CACHE_ROWS),
              PortStore(PLANES, NUM_FIELDS, CACHE_ROWS)]
    stores[0].host.set_backfill(jax_ckpt.flat_backfill(want, hash_fn))
    stores[1].host.set_backfill(port_ckpt.flat_backfill(got, hash_fn))
    sparse = np.concatenate(BATCHES)
    out = []
    for store in stores:
        rows, _ = store.host.assign(sparse)
        out.append(store.host.gather(rows.reshape(-1)))
    for name in PLANES:
        np.testing.assert_array_equal(out[1][name], out[0][name])
    fields = np.repeat(np.arange(NUM_FIELDS)[None, :], 2, 0).reshape(-1)
    np.testing.assert_array_equal(
        out[1]["fm_embedding"],
        got["fm_embedding"][hash_fn(fields, sparse.reshape(-1))])


def test_fill_matching_on_state_dicts_and_jax_trees():
    template = {"dense.weight": torch.zeros(3, 2),
                "fm_embedding.embedding": torch.zeros(4, 2)}
    raw = {"dense.weight": np.ones((3, 2), np.float64),
           "fm_embedding.embedding": torch.ones(16, 2)}
    out = port_ckpt.fill_matching(template, raw)
    assert out["dense.weight"].dtype == torch.float32
    assert bool((out["dense.weight"] == 1).all())
    assert not out["fm_embedding.embedding"].any()
    tree = {"params": {"dense0": {"kernel": np.zeros((3, 2), np.float32)}}}
    raw_tree = {"params": {"dense0": {"kernel": np.ones((3, 2))}}}
    np.testing.assert_array_equal(
        port_ckpt.fill_matching(tree, raw_tree)["params"]["dense0"][
            "kernel"],
        jax_ckpt.fill_matching(tree, raw_tree)["params"]["dense0"][
            "kernel"])


def _saver_with_store(tmp_path, keep=3):
    store = PortStore(PLANES, NUM_FIELDS, CACHE_ROWS)
    _raw_id_backfill(store)
    state = _port_state()
    _, plan = store.prepare(BATCHES[0])
    store.apply_plan(state, plan)
    saver = save_utils.CheckpointSaver(str(tmp_path / "ckpt"),
                                       keep_max=keep)
    saver.attach_tiered_store(store)
    return saver, store, state


def test_keep3_prunes_sidecars_in_lockstep_with_pins(tmp_path):
    saver, _, state = _saver_with_store(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    save_utils.pin_step(ckpt, 2)
    for step in range(1, 7):
        state.step = step
        assert saver.save(state)
        saver.wait_until_finished()
    # 4..6 kept, 2 pinned, 1 and 3 gone with their sidecars
    assert saver.all_steps() == [2, 4, 5, 6]
    sidecars = sorted(int(n) for n in os.listdir(
        os.path.join(ckpt, port_ckpt.SIDECAR_ROOT)))
    assert sidecars == [2, 4, 5, 6]
    save_utils.unpin_step(ckpt, 2)
    state.step = 7
    saver.save(state)
    saver.close()
    assert saver.all_steps() == [5, 6, 7]
    assert sorted(os.listdir(os.path.join(ckpt, port_ckpt.SIDECAR_ROOT))) \
        == ["5", "6", "7"]
    import json

    with open(os.path.join(ckpt, ".manifests", "7.json")) as f:
        tiered = json.load(f)["tiered"]
    assert tiered == {"cache_rows": CACHE_ROWS, "num_fields": NUM_FIELDS,
                      "host_dtype": "fp32", "planes": PLANES,
                      "vocab_rows": NUM_FIELDS, "cache_dtype": "float32"}


def test_a_failed_sidecar_write_fails_the_save(tmp_path, monkeypatch):
    saver, _, state = _saver_with_store(tmp_path)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(port_ckpt, "write_sidecar", broken)
    state.step = 4
    assert saver.save(state)
    with pytest.raises(OSError, match="disk full"):
        saver.wait_until_finished()
    assert saver.all_steps() == []      # state.pt never landed
    saver.close()


def test_maybe_restore_adopts_the_sidecar_and_needs_it(tmp_path):
    saver, store, state = _saver_with_store(tmp_path, keep=5)
    for step in (2, 4):
        state.step = step
        saver.save(state)
    saver.close()
    ckpt = str(tmp_path / "ckpt")
    fresh = PortStore(PLANES, NUM_FIELDS, CACHE_ROWS)
    again = save_utils.CheckpointSaver(ckpt)
    again.attach_tiered_store(fresh)
    target = _port_state()
    assert again.maybe_restore(target).step == 4
    assert fresh.host.size == store.host.size == NUM_FIELDS
    np.testing.assert_array_equal(fresh.cache.row_of, store.cache.row_of)
    # a store with plans not yet applied refuses a restore, at once
    # (step 2's sidecar is intact: no fallback to it)
    fresh.prepare(BATCHES[1])
    with pytest.raises(RuntimeError, match="not applied"):
        again.maybe_restore(_port_state())
    # the newest step without its sidecar raises rather than fall back
    # to the one before
    shutil.rmtree(port_ckpt.sidecar_dir(ckpt, 4))
    later = save_utils.CheckpointSaver(ckpt)
    later.attach_tiered_store(PortStore(PLANES, NUM_FIELDS, CACHE_ROWS))
    with pytest.raises(FileNotFoundError, match="no tiered sidecar"):
        later.maybe_restore(_port_state())
    again.close()
    later.close()


def _blocked_fold(store):
    """Hold the store's fold thread inside host.set_rows until the
    returned event is set."""
    release = threading.Event()
    entered = threading.Event()
    original = store.host.set_rows

    def set_rows(rows, values):
        entered.set()
        release.wait(timeout=30)
        original(rows, values)

    store.host.set_rows = set_rows
    return release, entered


def test_sidecar_fold_race_loses_a_row_in_jax_not_in_the_port(tmp_path):
    """A row evicted just before a save has its trained value only on
    the fold queue.  The JAX save copies the host tier without joining
    the queue and keeps the row's stale host value; the port's joins it
    first (ROADMAP.md queue 3)."""
    results = {}
    for name, make, mod in (("jax", JaxStore, jax_ckpt),
                            ("port", PortStore, port_ckpt)):
        store = make(PLANES, NUM_FIELDS, CACHE_ROWS)
        _raw_id_backfill(store)
        state = _jax_state() if name == "jax" else _port_state()
        store.start()
        _, plan = store.prepare(BATCHES[0])
        state = store.apply_plan(state, plan) or state
        # train: every resident value +1
        if name == "jax":
            state = state.replace(params=jax.tree.map(lambda t: t + 1.0,
                                                      state.params))
        else:
            with torch.no_grad():
                for p in state.model.parameters():
                    p.add_(1.0)
        release, entered = _blocked_fold(store)
        _, plan = store.prepare(BATCHES[1])
        state = store.apply_plan(state, plan) or state
        evicted = plan.evict_rows.copy()
        assert evicted.size and entered.wait(timeout=30)
        timer = threading.Timer(0.5, release.set)
        timer.start()
        d = str(tmp_path / name)
        mod.save_sidecar(d, 1, store, state)
        timer.join()
        store.stop()
        latest = mod.load_sidecar(d, 1).latest_row_values("fm_embedding")
        ids = {int(r): int(i) for _, i, r in zip(
            *mod.load_sidecar(d, 1).vocab_arrays())}
        results[name] = [latest[r][0] - ids[int(r)] for r in evicted]
    # JAX: the +1 of training is gone from every evicted row; the port
    # keeps it
    assert results["jax"] == [0.0] * len(results["jax"])
    assert results["port"] == [1.0] * len(results["port"])


def test_sidecar_of_plans_made_ahead(tmp_path):
    """Eager planning runs ahead of the steps: the producer commits the
    cache map of a batch whose admissions the device has not seen.  The
    JAX save pairs that map with the current values, so the rows of the
    plan made ahead read other rows' values; the port saves the applied
    map (ROADMAP.md queue 3)."""
    results = {}
    third = np.arange(NUM_FIELDS, dtype=np.int64)[None, :] + 900
    for name, make, mod in (("jax", JaxStore, jax_ckpt),
                            ("port", PortStore, port_ckpt)):
        store = make(PLANES, NUM_FIELDS, CACHE_ROWS)
        _raw_id_backfill(store)
        state = _jax_state() if name == "jax" else _port_state()
        for sparse in BATCHES:
            _, plan = store.prepare(sparse)
            state = store.apply_plan(state, plan) or state
        store.prepare(third)                  # planned, not yet applied
        d = str(tmp_path / name)
        mod.save_sidecar(d, 1, store, state)
        sidecar = mod.load_sidecar(d, 1)
        latest = sidecar.latest_row_values("fm_embedding")[:, 0]
        _, ids, rows = sidecar.vocab_arrays()
        # every row's latest value is its raw id (no training here)
        results[name] = int((latest[rows] != ids).sum())
    assert results["jax"] > 0
    assert results["port"] == 0


# ---- serving -----------------------------------------------------------

SERVE_PARAMS = f"cache_rows={CACHE_ROWS};embed_dim={DIM}"


def _serving_model(cache_dtype="float32"):
    model = port_zoo.TieredDeepFM(cache_rows=CACHE_ROWS, embed_dim=DIM,
                                  mlp_dims=(8, 4), cache_dtype=cache_dtype)
    torch.manual_seed(0)
    from elasticdl_tpu_torch.layers.linen import init_parameters

    init_parameters(model, torch.Generator().manual_seed(0))
    return model


FEATURE_SPEC = {
    "dense": {"shape": [13], "dtype": "float32"},
    "slots": {"shape": [NUM_FIELDS], "dtype": "int32"},
    "cold_fm": {"shape": [NUM_FIELDS, DIM], "dtype": "float32"},
    "cold_linear": {"shape": [NUM_FIELDS, 1], "dtype": "float32"},
}


@pytest.fixture()
def tiered_serving(tmp_path):
    _, _, store, state = _driven_pair()
    ckpt = str(tmp_path / "serve")
    port_ckpt.save_sidecar(ckpt, 1, store, state)
    model = _serving_model()
    engine = ServingEngine(model, model.state_dict(), step=1,
                           feature_spec=FEATURE_SPEC, buckets=(4,),
                           device="cpu")
    tiered = TieredServingEngine(engine, ckpt, 1,
                                 port_zoo.OVERLAY_FEATURES)
    return {"engine": tiered, "ckpt": ckpt, "store": store,
            "state": state, "model": model}


class _NoEngine:
    state_template = None


def test_translate_known_cold_and_unknown_matches_jax(tiered_serving):
    eng = tiered_serving["engine"]
    jax_eng = JaxServing(_NoEngine(), tiered_serving["ckpt"], 1,
                         overlay_features=port_zoo.OVERLAY_FEATURES)
    unknown = np.full((1, NUM_FIELDS), 10 ** 9, np.int64)
    mixed = np.concatenate([BATCHES[0], BATCHES[1], unknown])
    mixed[2, :5] = BATCHES[0][0, :5]
    for sparse in (BATCHES[1], BATCHES[0], unknown, mixed):
        slots, overlays = eng.translate(sparse)
        want_slots, want_overlays = jax_eng.translate(sparse)
        np.testing.assert_array_equal(slots, want_slots)
        for feat in port_zoo.OVERLAY_FEATURES.values():
            np.testing.assert_array_equal(overlays[feat],
                                          want_overlays[feat])
    slots_hot, ov_hot = eng.translate(BATCHES[1])
    assert (slots_hot >= 0).all() and not ov_hot["cold_fm"].any()
    slots_any, ov_any = eng.translate(BATCHES[0])
    cold = slots_any < 0
    assert cold.any()
    np.testing.assert_array_equal(
        ov_any["cold_fm"][cold],
        np.repeat(BATCHES[0][cold].astype(np.float32)[:, None], DIM, 1))
    slots_u, ov_u = eng.translate(unknown)
    assert (slots_u == -1).all() and not ov_u["cold_fm"].any()
    assert eng.vocab_rows == 2 * NUM_FIELDS   # serving never grows it


def test_predict_never_trained_id_is_finite(tiered_serving):
    feats = {"dense": np.random.RandomState(0).rand(1, 13).astype(
        np.float32), "sparse": np.full((1, NUM_FIELDS), 987654321)}
    preds, step = tiered_serving["engine"].predict(feats, 1)
    assert step == 1 and np.isfinite(preds).all() and preds.shape == (1,)


def test_hot_swap_drops_no_request(tiered_serving):
    eng = tiered_serving["engine"]
    port_ckpt.save_sidecar(tiered_serving["ckpt"], 2,
                           tiered_serving["store"], tiered_serving["state"])
    feats = {"dense": np.zeros((1, 13), np.float32),
             "sparse": BATCHES[1][:1]}
    errors, served = [], []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                preds, step = eng.predict(feats, 1)
                assert step in (1, 2) and np.isfinite(preds).all()
                served.append(step)
            except Exception as exc:   # asserted empty below
                errors.append(exc)
                return

    def served_more(n):
        deadline = time.monotonic() + 30
        while len(served) < n and not errors:
            assert time.monotonic() < deadline, "requests stopped"
            time.sleep(0.001)

    t = threading.Thread(target=hammer)
    t.start()
    try:
        served_more(3)
        eng.swap(tiered_serving["model"].state_dict(), 2)
        served_more(len(served) + 3)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not errors and eng.step == 2 and eng.swap_count == 1
    assert 1 in served and 2 in served


def test_swap_without_sidecar_rejected_keeps_serving(tiered_serving):
    eng = tiered_serving["engine"]
    with pytest.raises(RuntimeError, match="no tiered sidecar"):
        eng.swap(tiered_serving["model"].state_dict(), 99)
    assert eng.step == 1
    preds, step = eng.predict({"dense": np.zeros((1, 13), np.float32),
                               "sparse": np.full((1, NUM_FIELDS), 3)}, 1)
    assert step == 1 and np.isfinite(preds).all()


def test_int8_sidecar_needs_an_int8_model(tiered_serving, tmp_path):
    _, _, store8, state8 = _driven_pair("int8")
    ckpt = str(tmp_path / "int8")
    port_ckpt.save_sidecar(ckpt, 1, store8, state8)
    engine = ServingEngine(tiered_serving["model"],
                           tiered_serving["model"].state_dict(), step=1,
                           feature_spec=FEATURE_SPEC, buckets=(4,),
                           device="cpu")
    with pytest.raises(RuntimeError, match="cache values"):
        TieredServingEngine(engine, ckpt, 1, port_zoo.OVERLAY_FEATURES)
    model8 = _serving_model("int8")
    engine8 = ServingEngine(model8, model8.state_dict(), step=1,
                            feature_spec=FEATURE_SPEC, buckets=(4,),
                            device="cpu")
    eng8 = TieredServingEngine(engine8, ckpt, 1, port_zoo.OVERLAY_FEATURES)
    preds, _ = eng8.predict({"dense": np.zeros((2, 13), np.float32),
                             "sparse": np.concatenate(BATCHES)}, 2)
    assert np.isfinite(preds).all()


def test_the_reloader_swaps_tiered_steps_and_rejects_one_without(tmp_path):
    """A Local-style checkpoint directory with sidecars: the port's
    CheckpointReloader drives the tiered engine unchanged."""
    spec = _port_spec(TIERED, SERVE_PARAMS)
    store = PortStore(PLANES, NUM_FIELDS, CACHE_ROWS)
    _raw_id_backfill(store)
    tr = PortTrainer(spec.model, spec.optimizer, spec.loss, device="cpu")
    tr.tiered_store = store
    batch = {"features": {"dense": np.zeros((1, 13), np.float32),
                          "sparse": BATCHES[0]},
             "labels": np.ones(1, np.int32)}
    state = tr.init_state(0, store.attach(dict(batch))["features"])
    ckpt = str(tmp_path / "ckpt")
    saver = save_utils.CheckpointSaver(ckpt, keep_max=5)
    saver.attach_tiered_store(store)
    state, _ = tr.train_on_batch(state, store.attach(dict(batch)))
    saver.save(state)
    saver.wait_until_finished()
    sample = {k: np.zeros((1, *v["shape"]), v["dtype"])
              for k, v in FEATURE_SPEC.items()}
    engine = ServingEngine.from_checkpoint(ckpt, spec, sample, buckets=(4,),
                                           device="cpu")
    tiered = TieredServingEngine(engine, ckpt, engine.step,
                                 port_zoo.OVERLAY_FEATURES)
    reloader = CheckpointReloader(tiered, ckpt)
    second = dict(batch)
    second["features"] = {"dense": batch["features"]["dense"],
                          "sparse": BATCHES[1]}
    state, _ = tr.train_on_batch(state, store.attach(second))
    saver.save(state)
    saver.wait_until_finished()
    assert reloader.check_once() and tiered.step == 2
    assert tiered.vocab_rows == 2 * NUM_FIELDS
    state, _ = tr.train_on_batch(state, store.attach(second))
    saver.save(state)
    saver.close()
    shutil.rmtree(port_ckpt.sidecar_dir(ckpt, 3))
    assert not reloader.check_once()
    assert reloader.rejected_count == 1 and tiered.step == 2
    assert "no tiered sidecar" in reloader.last_error
    preds, step = tiered.predict({"dense": np.zeros((1, 13), np.float32),
                                  "sparse": BATCHES[1]}, 1)
    assert step == 2 and np.isfinite(preds).all()
    reloader.stop()

"""Rank bodies of the port's parallel tests (tests/_torch_world.py runs
them, one process per rank over gloo on the CPU).  Each takes (rank,
world, ...), lays its meshes over the default group with
`create_mesh(world, rank, "cpu", ...)`, and returns plain tensors and
numbers for the test process to hold against the JAX package.  Nothing
here imports JAX."""

import numpy as np
import torch


def _mesh(rank, world, **axes):
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.create_mesh(world, rank, "cpu", **axes)


def _chunk(x, mesh, axis, dim):
    """This rank's chunk of a numpy array along `dim` over `axis`."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    width = x.shape[dim] // n
    return np.take(x, range(i * width, (i + 1) * width), axis=dim)


def _t(x, grad=False):
    return torch.tensor(np.ascontiguousarray(x), requires_grad=grad)


# ---- the mesh and its collectives --------------------------------------


def mesh_and_collectives(rank, world, x):
    """The layouts' coordinates and lines, then each axis collective's
    forward and backward on the (model=2, seq=2) mesh."""
    from elasticdl_tpu_torch.parallel import collectives as C

    out = {"layouts": {}}
    for name, axes in (("data2_model2", dict(data=2, model=2)),
                       ("model2_seq2", dict(model=2, seq=2)),
                       ("data2_expert2", dict(data=2, expert=2)),
                       ("data2_pipe2", dict(data=2, pipe=2)),
                       ("seq4", dict(data=1, seq=4))):
        mesh = _mesh(rank, world, **axes)
        out["layouts"][name] = {
            "coords": dict(mesh.coords),
            "lines": {a: mesh.axis_group(a)[1] for a in mesh.shape
                      if mesh.shape[a] > 1}}
    mesh = _mesh(rank, world, model=2, seq=2)
    mine = _t(x[rank], grad=True)
    results = {}
    for name, fn in (
            ("ring_shift", lambda v: C.axis_ring_shift(v, mesh, "seq")),
            ("ring_shift_back", lambda v: C.axis_ring_shift(v, mesh, "seq",
                                                            -1)),
            ("sum", lambda v: C.axis_sum(v, mesh, "model")),
            ("all_gather", lambda v: C.axis_all_gather(v, mesh, "seq", 1)),
            ("all_to_all", lambda v: C.axis_all_to_all(v, mesh, "seq", 0,
                                                       1)),
            ("max", lambda v: C.axis_max(v, mesh, "seq", 0))):
        mine.grad = None
        y = fn(mine)
        weights = torch.arange(y.numel(), dtype=torch.float32).reshape(
            y.shape) + rank
        (y * weights).sum().backward()
        results[name] = (y.detach(), mine.grad.clone())
    out["collectives"] = results
    # a bf16 exchange moves its bytes unchanged
    half = torch.tensor(x[rank], dtype=torch.bfloat16)
    out["bf16_shift"] = C.ring_shift(half, mesh, "seq").float()
    return out


# ---- ring attention ------------------------------------------------------


def ring_attention(rank, world, cases):
    """Each case's (out, dq, dk, dv) chunk on a seq=4 ring, the loss
    sum(out * w) with this rank's chunk of w."""
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops.ring_attention import ring_self_attention

    mesh = _mesh(rank, world, data=1, seq=world)
    out = {}
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_attention_forward, fa.flash_attention_backward

    def count(kind, fn):
        def wrapped(*args, **kwargs):
            calls[kind] += 1
            return fn(*args, **kwargs)
        return wrapped

    import elasticdl_tpu_torch.ops.ring_attention as ra
    ra.flash_attention_forward = count("fwd", fwd)
    ra.flash_attention_backward = count("bwd", bwd)
    for name, (q, k, v, w, causal) in cases.items():
        q_, k_, v_ = (_t(_chunk(a, mesh, "seq", 1), grad=True)
                      for a in (q, k, v))
        before = dict(calls)
        y = ring_self_attention(q_, k_, v_, mesh=mesh, causal=causal)
        (y * _t(_chunk(w, mesh, "seq", 1))).sum().backward()
        out[name] = {"out": y.detach(), "dq": q_.grad, "dk": k_.grad,
                     "dv": v_.grad,
                     "blocks": {kk: calls[kk] - before[kk] for kk in calls}}
    return out


# ---- MoE -------------------------------------------------------------------


def moe_expert_parallel(rank, world, flat, x, w, layer_kwargs):
    """MoEMLP on data=2, expert=2: this rank's output rows and, after
    the trainer's gradient sums, its (sharded) parameter gradients."""
    from elasticdl_tpu_torch.common.weights import params_from_jax
    from elasticdl_tpu_torch.layers.moe import MoEMLP, moe_param_sharding
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib
    from elasticdl_tpu_torch.worker.trainer import (
        TrainState,
        reduce_gradients,
        shard_state,
    )

    mesh = _mesh(rank, world, data=2, expert=2)
    mesh_lib.set_current_mesh(mesh)
    layer = MoEMLP(**layer_kwargs)
    layer.load_state_dict(params_from_jax(layer, flat), strict=True)
    state = TrainState(step=0, model=layer, optimizer=None)
    shard_state(state, moe_param_sharding, mesh)
    rows = _chunk(x, mesh, "data", 0)
    y = layer(_t(rows))
    replicas = world // mesh.shape["data"]
    objective = (y * _t(_chunk(w, mesh, "data", 0))).sum() / replicas \
        + layer.aux_loss / world
    aux = float(layer.aux_loss)
    objective.backward()
    reduce_gradients(state, mesh)
    return {"coords": dict(mesh.coords), "out": y.detach(), "aux": aux,
            "grads": {n: p.grad for n, p in layer.named_parameters()},
            "shapes": {n: tuple(p.shape) for n, p in
                       layer.named_parameters()}}


# ---- GPipe -------------------------------------------------------------------


def _mlp_apply(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def gpipe(rank, world, stack, x, w, num_microbatches):
    """gpipe_spmd on data=2, pipe=2, plain and remat: this rank's output
    rows, its stage's stack gradients (summed over `data`), and its
    input rows' gradient; and the error for layers that do not divide."""
    from elasticdl_tpu_torch.common.weights import shard_tensor
    from elasticdl_tpu_torch.ops.pipeline import gpipe_spmd
    from elasticdl_tpu_torch.parallel import collectives

    mesh = _mesh(rank, world, data=2, pipe=2)
    out = {"coords": dict(mesh.coords)}
    rows = _chunk(x, mesh, "data", 0)
    for remat in (False, True):
        leaves = {k: _t(shard_tensor(v, ("pipe",), mesh), grad=True)
                  for k, v in stack.items()}
        xs = _t(rows, grad=True)
        y = gpipe_spmd(_mlp_apply, leaves, xs, mesh,
                       num_microbatches=num_microbatches, remat=remat,
                       num_layers=stack["w"].shape[0])
        # every pipe rank holds the output: each carries half the loss
        ((y * _t(_chunk(w, mesh, "data", 0))).sum()
         / mesh.shape["pipe"]).backward()
        grads = {k: collectives.axis_reduce(v.grad, mesh, "data")
                 for k, v in leaves.items()}
        # only stage 0 reads the input
        dx = collectives.axis_reduce(
            xs.grad if xs.grad is not None else torch.zeros_like(xs),
            mesh, "pipe")
        out["remat" if remat else "plain"] = {
            "out": y.detach(), "grads": grads, "dx": dx}
    try:
        gpipe_spmd(_mlp_apply, {k: _t(v[:3]) for k, v in stack.items()},
                   _t(rows), mesh, num_microbatches=num_microbatches,
                   num_layers=3)
    except ValueError as exc:
        out["indivisible"] = str(exc)
    return out


# ---- a zoo model trained on a mesh --------------------------------------


def carry_full(state, template, flat, stats=None, quantized=None):
    """Load a whole flax tree (flattened) into `state`, sliced to its
    shards: the full tensors come from `template` (the zoo's full-size
    model)."""
    from elasticdl_tpu_torch.common.weights import params_from_jax, shard_tree

    full = params_from_jax(template, flat, batch_stats=stats,
                           quantized=quantized)
    state.model.load_state_dict(
        shard_tree(full, state.shardings, state.mesh), strict=True)


def train_on_mesh(rank, world, axes, model_def, model_params, flat, stats,
                  batches):
    """The zoo model on a mesh of `axes` through the Trainer's global
    step, from the carried JAX init: per-step losses, the final state
    (this rank's shards) and the scatter-add calls per step."""
    from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, \
        get_model_spec
    from elasticdl_tpu_torch.layers import embedding
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib
    from elasticdl_tpu_torch.worker.trainer import Trainer

    calls = []
    scatter = embedding.scatter_add_forward

    def counted(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return scatter(*args, **kwargs)

    embedding.scatter_add_forward = counted
    mesh = _mesh(rank, world, **axes)
    spec = get_model_spec(ZOO_DIR, model_def, model_params=model_params)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, device="cpu",
                      param_sharding_fn=spec.param_sharding)
    state = trainer.init_state_global(0, batches[0]["features"], mesh)
    carry_full(state, spec.model, flat, stats)
    losses, per_step = [], []
    for batch in batches:
        shard = mesh_lib.make_global_batch(batch, mesh, trainer.stage_batch)
        before = len(calls)
        state, loss = trainer.train_on_global_batch(state, shard, mesh)
        losses.append(float(loss))
        per_step.append(calls[before:])
    return {"coords": dict(mesh.coords), "losses": losses,
            "shardings": dict(state.shardings), "scatters": per_step,
            "state": {k: v.detach().clone() for k, v in
                      state.model.state_dict().items()}}


# ---- BERT on the model, seq, pipe and expert axes ------------------------


def bert_parallel(rank, world, params, init, batches, eval_features,
                  ckpt_dir, export_root, job):
    """Tiny BERT: (1) model=2 x seq=2 from the carried JAX init, three
    steps, the step-1 gradients, a checkpoint and a ring export; (2) the
    checkpoint restored on data=2 x seq=2; (3) the GPipe variant on
    data=2 x pipe=2 and (4) the MoE variant on data=2 x expert=2, each a
    step, a predict and an export; (5) an SPMDWorker handed a model=2 x
    seq=2 mesh runs `job`'s master's tasks, checkpointing."""
    import os

    from elasticdl_tpu_torch.common.export import export_model
    from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, \
        get_model_spec
    from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib
    from elasticdl_tpu_torch.worker.trainer import Trainer

    model_def = "bert.bert_finetune.custom_model"
    out = {}

    def setup(axes, extra="", flat=None):
        mesh = _mesh(rank, world, **axes)
        spec = get_model_spec(ZOO_DIR, model_def, model_params=params + extra)
        trainer = Trainer(spec.model, spec.optimizer, spec.loss,
                          device="cpu", param_sharding_fn=spec.param_sharding)
        state = trainer.init_state_global(0, batches[0]["features"], mesh)
        if flat is not None:
            carry_full(state, spec.model, flat)
        return mesh, spec, trainer, state

    def step(mesh, trainer, state, batch):
        shard = mesh_lib.make_global_batch(batch, mesh, trainer.stage_batch)
        return float(trainer.train_on_global_batch(state, shard, mesh)[1])

    def predict(mesh, trainer, state):
        shard = mesh_lib.make_global_batch(
            {"features": eval_features}, mesh, trainer.stage_batch)
        return trainer.predict_on_global_batch(state, shard, mesh)

    # (1) model=2 x seq=2
    mesh, spec, trainer, state = setup(dict(model=2, seq=2), flat=init)
    losses = [step(mesh, trainer, state, batches[0])]
    out["grads"] = {n: p.grad.clone() for n, p in
                    state.model.named_parameters()}
    out["shardings"] = dict(state.shardings)
    losses += [step(mesh, trainer, state, b) for b in batches[1:]]
    out["losses"] = losses
    out["coords"] = dict(mesh.coords)
    out["ring_predict"] = predict(mesh, trainer, state)
    saver = CheckpointSaver(ckpt_dir)
    saver.save(state)
    saver.close()
    torch.distributed.barrier()       # rank 0's write is in place
    export_model(state, spec, os.path.join(export_root, "ring"),
                 saved_model=True, sample_features=eval_features)

    # (2) the step restored on another layout
    mesh, spec, trainer, state = setup(dict(data=2, seq=2))
    saver = CheckpointSaver(ckpt_dir)
    assert saver.maybe_restore(state) is state
    out["restored_step"] = int(state.step)
    out["restored_predict"] = predict(mesh, trainer, state)

    # (3) GPipe and (4) MoE
    for name, axes, extra in (
            ("gpipe", dict(data=2, pipe=2), ";pipeline_microbatches=2"),
            ("moe", dict(data=2, expert=2), ";moe_experts=2")):
        mesh, spec, trainer, state = setup(axes, extra)
        loss = step(mesh, trainer, state, batches[0])
        out[name] = {"loss": loss, "predict": predict(mesh, trainer, state),
                     "shapes": {n: tuple(p.shape) for n, p in
                                state.model.named_parameters()}}
        export_model(state, spec, os.path.join(export_root, name),
                     saved_model=True, sample_features=eval_features)

    # (5) the worker's path on a mesh of the other axes
    out["job"] = spmd_job(rank, world, job, params, _mesh(
        rank, world, model=2, seq=2))
    return out


def spmd_job(rank, world, job, params, mesh):
    """An SPMDWorker over the master at job["master"], handed `mesh`;
    its step losses, its shards' shapes and its saver's steps."""
    from elasticdl_tpu_torch.common import resilience
    from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, \
        get_model_spec
    from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
    from elasticdl_tpu_torch.data.reader import TFRecordDataReader
    from elasticdl_tpu_torch.proto.service import MasterStub
    from elasticdl_tpu_torch.worker.spmd import SPMDWorker
    from elasticdl_tpu_torch.worker.trainer import Trainer

    losses = []
    step = Trainer.train_on_global_batch

    def recorded(self, state, shard, mesh_):
        state, loss = step(self, state, shard, mesh_)
        losses.append(float(loss))
        return state, loss

    Trainer.train_on_global_batch = recorded
    client = MasterStub(job["master"], timeout=60,
                        retry_policy=resilience.default_policy(
                            initial_backoff_s=0.01, max_backoff_s=0.1))
    worker = SPMDWorker(
        worker_id=rank, master_client=client,
        data_reader=TFRecordDataReader(job["train_dir"]),
        spec=get_model_spec(ZOO_DIR, "bert.bert_finetune.custom_model",
                            model_params=params),
        minibatch_size=job["batch"], process_id=rank, num_processes=world,
        device="cpu", use_bf16=False, wait_sleep_s=0.05, mesh=mesh,
        checkpoint_saver=CheckpointSaver(job["ckpt_dir"]),
        checkpoint_steps=job["checkpoint_steps"])
    ok = worker.run()
    Trainer.train_on_global_batch = step
    return {"ok": ok, "losses": losses, "step": int(worker.state.step),
            "table": tuple(worker.state.model.get_parameter(
                "token_embedding.embedding").shape)}


# ---- the int8 arena and the tiered cache over `model` ---------------------


def _whole_state(state):
    """The whole model's state dict (a collective on a sharded state)."""
    from elasticdl_tpu_torch.common.save_utils import gathered_state

    return {k: v.detach().clone() for k, v in
            gathered_state(state).model.state_dict().items()}


def _count_scatters(calls):
    """Record the table shape of every scatter-add the arenas launch."""
    from elasticdl_tpu_torch.layers import arena, embedding

    for module in (arena, embedding):
        original = module.scatter_add_forward

        def counted(*args, _original=original, **kwargs):
            calls.append(tuple(args[0].shape))
            return _original(*args, **kwargs)

        module.scatter_add_forward = counted


def _record_folds(folds):
    """Each fold's gathered planes and carrier delta before it (a
    collective: every rank records), and its step."""
    from elasticdl_tpu_torch.layers.arena import (
        PLANE_KEYS,
        plane_key,
        plane_prefixes,
    )
    from elasticdl_tpu_torch.worker import trainer as trainer_lib

    fold = trainer_lib.fold_quantized_updates

    def recorded(model, step):
        state = recorded.state
        whole = _whole_state(state)
        folds.append({"step": int(step), "before": {
            k: whole[plane_key(prefix, leaf)] for prefix in
            plane_prefixes(whole)
            for leaf in PLANE_KEYS + ("embedding",)
            for k in (plane_key(prefix, leaf),)}})
        return fold(model, step)

    trainer_lib.fold_quantized_updates = recorded
    return recorded


def _sample(batch, store):
    """A batch's features for the init forward: a tiered model takes
    slots where the batch has raw ids."""
    features = dict(batch["features"])
    if store is None:
        return features
    return {"dense": features["dense"],
            "slots": np.zeros(features["sparse"].shape, np.int32)}


def _one_rank_run(model_def, params, flat, quantized, batches, store=None):
    """The port on one rank from the same init: losses and the whole
    state (with a store: its host tier and cache tables too)."""
    from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, \
        get_model_spec
    from elasticdl_tpu_torch.common.weights import params_from_jax
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib
    from elasticdl_tpu_torch.worker.trainer import Trainer

    spec = get_model_spec(ZOO_DIR, model_def, model_params=params)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, device="cpu")
    trainer.tiered_store = store
    with mesh_lib.using_mesh(mesh_lib.ProcessMesh()):
        state = trainer.init_state(0, _sample(batches[0], store))
        state.model.load_state_dict(params_from_jax(
            state.model, flat, quantized=quantized), strict=True)
        losses = []
        for batch in batches:
            if store is not None:
                batch = store.attach(dict(batch))
            losses.append(float(trainer.train_on_batch(state, batch)[1]))
    out = {"losses": losses, "state": _whole_state(state)}
    if store is not None:
        from elasticdl_tpu_torch.store import device as store_device

        out["host"] = store.host.state_dict()
        out["cache_tables"] = store_device.read_full_tables(
            state, store.param_paths, cache_dtype=store.cache_dtype)
    return out


def _mesh_run(rank, world, axes, model_def, params, flat, quantized,
              batches, store=None, folds=None, ckpt_dir=None):
    """The zoo model on a mesh of `axes` from the carried init through
    the Trainer's global step (with `store`, each global batch attached
    on every rank first): losses, scatter-add shapes per step, the whole
    state at the end; with `folds`, each fold's inputs; with
    `ckpt_dir`, the step saved and restored on the same mesh."""
    from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, \
        get_model_spec
    from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib
    from elasticdl_tpu_torch.worker.trainer import Trainer

    calls = []
    _count_scatters(calls)
    mesh = _mesh(rank, world, **axes)
    spec = get_model_spec(ZOO_DIR, model_def, model_params=params)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, device="cpu",
                      param_sharding_fn=spec.param_sharding)
    trainer.tiered_store = store
    sample = _sample(batches[0], store)
    state = trainer.init_state_global(0, sample, mesh)
    carry_full(state, spec.model, flat, quantized=quantized)
    if folds is not None:
        _record_folds(folds).state = state
    losses, per_step, digests, applied = [], [], [], []
    if store is not None:
        from elasticdl_tpu_torch.store import device as store_device

        admit = store_device.apply_admissions

        def recorded(state_, paths, slots, *args, **kwargs):
            applied[-1].append(np.asarray(slots).copy())
            return admit(state_, paths, slots, *args, **kwargs)

        store_device.apply_admissions = recorded
    for batch in batches:
        if store is not None:
            batch = store.attach(dict(batch))
            plan = batch["__store_plan__"]
            digests.append(plan.digest())
            applied.append([])
            sub = plan.sub_plans[mesh.coords["model"]] \
                if plan.sub_plans else None
        shard = mesh_lib.make_global_batch(batch, mesh, trainer.stage_batch)
        before = len(calls)
        state, loss = trainer.train_on_global_batch(state, shard, mesh)
        losses.append(float(loss))
        per_step.append(calls[before:])
        if store is not None:
            got = np.concatenate(applied[-1]) if applied[-1] else \
                np.zeros(0, np.int64)
            applied[-1] = (got, None if sub is None else sub["admit_slots"])
    if folds is not None:
        from elasticdl_tpu_torch.layers.arena import fold_quantized_updates
        from elasticdl_tpu_torch.worker import trainer as trainer_lib

        trainer_lib.fold_quantized_updates = fold_quantized_updates
    out = {"coords": dict(mesh.coords), "losses": losses,
           "scatters": per_step, "shardings": dict(state.shardings),
           "shapes": {k: tuple(v.shape) for k, v in
                      state.model.state_dict().items()},
           "state": _whole_state(state), "folds": folds}
    if store is not None:
        from elasticdl_tpu_torch.store import device as store_device

        store_device.apply_admissions = admit
        out["digests"] = digests
        out["applied"] = applied
        out["host"] = store.host.state_dict()
        out["stats"] = store.stats()
        out["mesh_shards"] = store.mesh_shards
        out["cache_tables"] = store_device.read_full_tables(
            state, store.param_paths, cache_dtype=store.cache_dtype)
    if ckpt_dir is not None:
        # every rank saves (rank 0 writes the gathered tree and, with a
        # store, its sidecar); a fresh state and store restore it
        saver = CheckpointSaver(ckpt_dir)
        if store is not None:
            saver.attach_tiered_store(store)
        saver.save(state)
        saver.close()
        torch.distributed.barrier()
        restorer = CheckpointSaver(ckpt_dir)
        if store is not None:
            from elasticdl_tpu_torch.store.tiered import TieredStore

            trainer.tiered_store = TieredStore(
                store.planes, store.num_fields, store.cache_rows,
                cache_dtype=store.cache_dtype)
            restorer.attach_tiered_store(trainer.tiered_store)
        fresh = trainer.init_state_global(1, sample, mesh)
        assert restorer.maybe_restore(fresh) is fresh
        out["restored_step"] = int(fresh.step)
        out["restored"] = {k: v.detach().clone() for k, v in
                           fresh.model.state_dict().items()}
        if store is not None:
            out["restored_host"] = trainer.tiered_store.host.state_dict()
            out["restored_row_of"] = trainer.tiered_store.cache.row_of
    return out


def int8_on_meshes(rank, world, model_def, params, flat, quantized,
                   batches, ckpt_dir):
    """int8 DeepFM from the carried JAX init: (1) data=2 x model=2 with
    each fold's inputs recorded, saved and restored on the mesh; (2)
    data=1 x model=4 (no layout splits the batch); (3) on rank 0 the
    one-rank run."""
    out = {"dm": _mesh_run(rank, world, dict(data=2, model=2), model_def,
                           params, flat, quantized, batches, folds=[],
                           ckpt_dir=ckpt_dir)}
    out["m4"] = _mesh_run(rank, world, dict(data=1, model=4), model_def,
                          params, flat, quantized, batches)
    if rank == 0:
        out["one"] = _one_rank_run(model_def, params, flat, quantized,
                                   batches)
    return out


# ---- MoE on tokens split over `seq` ----------------------------------------


def _moe_on_mesh(rank, world, axes, flat, x, w, layer_kwargs):
    """MoEMLP on a mesh of `axes`, this rank holding its data rows and
    seq chunk of the (B, L, H) tokens: its output chunk, the aux loss,
    and its parameter gradients after the trainer's sums."""
    from elasticdl_tpu_torch.common.weights import params_from_jax
    from elasticdl_tpu_torch.layers.moe import MoEMLP, moe_param_sharding
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib
    from elasticdl_tpu_torch.worker.trainer import (
        TrainState,
        reduce_gradients,
        shard_state,
    )

    mesh = _mesh(rank, world, **axes)
    mesh_lib.set_current_mesh(mesh)
    layer = MoEMLP(**layer_kwargs)
    layer.load_state_dict(params_from_jax(layer, flat), strict=True)
    state = TrainState(step=0, model=layer, optimizer=None)
    shard_state(state, moe_param_sharding, mesh)

    def mine(a):
        return _chunk(_chunk(a, mesh, "data", 0), mesh, "seq", 1)

    y = layer(_t(mine(x)))
    holders = world // (mesh.shape["data"] * mesh.shape["seq"])
    objective = (y * _t(mine(w))).sum() / holders + layer.aux_loss / world
    aux = float(layer.aux_loss)
    objective.backward()
    reduce_gradients(state, mesh)
    return {"coords": dict(mesh.coords), "out": y.detach(), "aux": aux,
            "grads": {n: p.grad for n, p in layer.named_parameters()}}


def moe_seq(rank, world, layer_cases, bert):
    """Each layer case (name -> (axes, flat, x, w, kwargs)) on its mesh;
    then BERT with experts trained on seq=2 x expert=2 from the carried
    init (`bert`: params, flat, batches)."""
    out = {name: _moe_on_mesh(rank, world, *case)
           for name, case in layer_cases.items()}
    params, flat, batches = bert
    out["bert"] = train_on_mesh(rank, world, dict(seq=2, expert=2),
                                "bert.bert_finetune.custom_model", params,
                                flat, None, batches)
    return out


def tiered_on_meshes(rank, world, params, flat, quantized, batches,
                     planes, cache_rows, cache_dtype, ckpt_dir):
    """The tiered DeepFM (`cache_dtype` cache) from the carried JAX
    init, each layout with its own store planning every global batch:
    data=2 x model=2 (saved at the end with the store's sidecar and
    restored on the mesh), data=1 x model=4, and on rank 0 the one-rank
    run."""
    from elasticdl_tpu_torch.store.tiered import TieredStore

    model_def = "deepfm.deepfm_tiered.custom_model"

    def store():
        return TieredStore(planes, 26, cache_rows, cache_dtype=cache_dtype)

    out = {layout: _mesh_run(rank, world, axes, model_def, params, flat,
                             quantized, batches, store=store(),
                             ckpt_dir=ckpt)
           for layout, axes, ckpt in (("dm", dict(data=2, model=2), ckpt_dir),
                                      ("m4", dict(data=1, model=4), None))}
    if rank == 0:
        out["one"] = _one_rank_run(model_def, params, flat, quantized,
                                   batches, store=store())
    return out

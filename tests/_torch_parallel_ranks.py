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


def carry_full(state, template, flat, stats=None):
    """Load a whole flax tree (flattened) into `state`, sliced to its
    shards: the full tensors come from `template` (the zoo's full-size
    model)."""
    from elasticdl_tpu_torch.common.weights import params_from_jax, shard_tree

    full = params_from_jax(template, flat, batch_stats=stats)
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

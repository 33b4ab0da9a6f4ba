"""BERT on the model, seq, pipe and expert axes: one world of 4 gloo
ranks runs tests/test_bert.py's tiny model on model=2 x seq=2 (the
token table row-sharded, ring attention through `_RingFlash`, the pool
an `axis_max` over seq) from the JAX init, against the JAX model on one
device: the step-1 gradient of every parameter and three steps' losses.
The same world saves a checkpoint on that 4-rank mesh and restores it
on data=2 x seq=2 and, here, on one rank, with equal predictions; and
exports the ring, GPipe (data=2 x pipe=2) and MoE (data=2 x expert=2)
variants, each torch export equal to the in-process predict.  Last, the
ranks run a job through `SPMDWorker`s handed a model=2 x seq=2 mesh,
over a master this process serves: every task trained and evaluated,
one loss trajectory, and checkpoints and an export of the whole
tree.

Tolerance: f32; the ring merges blocks and sums gradients in another
order than one device: losses within 1e-5, gradients within 1e-5 plus
1e-3 of their size, predictions within 1e-5 (measured below 2e-6).
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from _torch_world import run_world
from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.parallel import mesh as jax_mesh
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common.export import (
    load_exported,
    load_saved_model,
)
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
from elasticdl_tpu_torch.common.weights import (
    flatten_params,
    params_from_jax,
    shard_tensor,
)
from elasticdl_tpu_torch.parallel.mesh import ProcessMesh
from elasticdl_tpu_torch.worker.trainer import Trainer

torch.set_num_threads(2)

BERT = "bert.bert_finetune.custom_model"
PARAMS = ("hidden=32;num_layers=2;heads=2;mlp_dim=64;max_len=16;"
          "vocab_size=64")
LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3
PREDICT_TOL = 1e-5


def _batch(seed, n=8):
    rng = np.random.RandomState(seed)
    return {"features": {"input_ids": rng.randint(
        0, 64, size=(n, 16)).astype(np.int32)},
        "labels": rng.randint(0, 2, n).astype(np.int32)}


JOB_BATCH = 8
JOB_CHECKPOINT_STEPS = 2


def _job_master(root):
    """A master over 64 training and 16 validation pair records, tasks
    of 16 (2 steps of 8), served on 127.0.0.1."""
    from elasticdl_tpu_torch.common.args import parse_master_args
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.model_zoo.bert.data import write_dataset

    train_dir, val_dir = write_dataset(str(root / "pairs"), n_train=64,
                                       n_val=16, max_len=16, vocab=64)
    master = Master(parse_master_args([
        "--training_data", train_dir, "--validation_data", val_dir,
        "--records_per_task", "16", "--num_epochs", "1",
        "--minibatch_size", str(JOB_BATCH), "--model_def", BERT,
        "--model_params", PARAMS, "--device", "cpu",
        "--output", str(root / "job_out")]))
    # the SAVE_MODEL task a cluster master (one with a pod manager) adds
    master.task_manager.add_pre_finish_provider(master._save_model_tasks)
    return master, {"master": f"127.0.0.1:{master.start_rpc(0)}",
                    "train_dir": train_dir, "batch": JOB_BATCH,
                    "ckpt_dir": str(root / "job_ckpt"),
                    "checkpoint_steps": JOB_CHECKPOINT_STEPS}


@pytest.fixture(scope="module")
def bert_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("bert_world")
    master, job = _job_master(root)
    batches = [_batch(s) for s in range(3)]
    eval_features = _batch(9)["features"]
    js = jax_spec("model_zoo", BERT, model_params=PARAMS)
    jt = JaxTrainer(js.model, js.optimizer, js.loss,
                    mesh=jax_mesh.create_mesh(jax.devices()[:1]),
                    param_sharding_fn=js.param_sharding)
    state = jt.init_state(jax.random.PRNGKey(0), batches[0]["features"])
    init = flatten_params(jax.tree.map(np.asarray, state.params["params"]))

    def loss(params, batch):
        logits = js.model.apply({"params": params}, batch["features"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch["labels"]).mean()

    def jax_side():
        nonlocal state
        grads = jax.jit(jax.grad(loss))(state.params["params"], batches[0])
        losses = []
        for batch in batches:
            state, value = jt.train_on_batch(state, batch)
            losses.append(float(value))
        return flatten_params(jax.tree.map(np.asarray, grads)), losses

    try:
        got, (grads, losses) = run_world(
            4, "_torch_parallel_ranks:bert_parallel",
            (PARAMS, init, batches, eval_features, str(root / "ckpt"),
             str(root / "exports"), job), root, meanwhile=jax_side)
    finally:
        master.stop()
    got[0]["job_master"] = {
        "finished": master.task_manager.finished,
        "records_done": master.task_manager.counters.records_done,
        "metrics": master.evaluation_service.latest_metrics()}
    template = get_model_spec(ZOO_DIR, BERT, model_params=PARAMS).model
    return (params_from_jax(template, grads), losses, eval_features, root,
            got)


def test_step_one_gradients_match_jax_per_parameter(bert_world):
    grads, _, _, _, got = bert_world
    for rank, result in enumerate(got):
        mesh = ProcessMesh(4, rank, axis_sizes=dict(model=2, seq=2))
        assert result["coords"] == mesh.coords
        assert result["shardings"] == {
            "token_embedding.embedding": ("model", None)}
        assert set(result["grads"]) == set(grads)
        for name, want in grads.items():
            want = shard_tensor(want, result["shardings"].get(name), mesh)
            np.testing.assert_allclose(
                result["grads"][name].numpy(), want.numpy(),
                atol=GRAD_ATOL, rtol=GRAD_RTOL,
                err_msg=f"rank {rank} {name}")


def test_three_steps_match_jax(bert_world):
    _, losses, _, _, got = bert_world
    for result in got:
        np.testing.assert_allclose(result["losses"], losses, atol=LOSS_TOL,
                                   rtol=0)
        assert result["losses"] == got[0]["losses"]


def test_a_step_saved_on_four_ranks_restores_on_other_layouts(bert_world):
    _, _, eval_features, root, got = bert_world
    ring = got[0]["ring_predict"]
    assert ring.shape == (8, 2)
    for result in got:
        assert result["restored_step"] == 3
        np.testing.assert_allclose(result["restored_predict"], ring,
                                   atol=PREDICT_TOL, rtol=0)
    # and on one rank, from the whole tree the checkpoint holds
    spec = get_model_spec(ZOO_DIR, BERT, model_params=PARAMS)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, device="cpu")
    state = trainer.init_state(1, eval_features)
    assert CheckpointSaver(str(root / "ckpt")).maybe_restore(state) is state
    assert state.step == 3
    np.testing.assert_allclose(trainer.predict_on_batch(state, eval_features),
                               ring, atol=PREDICT_TOL, rtol=0)


@pytest.mark.parametrize("variant", ["ring", "gpipe", "moe"])
def test_exports_equal_the_in_process_predict(bert_world, variant):
    _, _, eval_features, root, got = bert_world
    predicted = got[0]["ring_predict"] if variant == "ring" \
        else got[0][variant]["predict"]
    for result in got[1:]:
        wanted = result["ring_predict"] if variant == "ring" \
            else result[variant]["predict"]
        assert np.array_equal(wanted, predicted)
    program = load_saved_model(os.path.join(root, "exports", variant,
                                            "saved_model"))
    with torch.no_grad():
        out = program.module()({"input_ids": torch.from_numpy(
            eval_features["input_ids"])})
    np.testing.assert_allclose(out.numpy(), predicted, atol=PREDICT_TOL,
                               rtol=0)


def test_the_variants_shard_their_stacks(bert_world):
    *_, got = bert_world
    for result in got:
        gpipe, moe = result["gpipe"]["shapes"], result["moe"]["shapes"]
        # one of the two layers per stage, one of the two experts per rank
        assert gpipe["encoder_pipeline.gpipe_stack.Dense_0.weight"] == (
            1, 64, 32)
        assert moe["layer_0.moe_mlp.expert_w_in"] == (1, 32, 64)
        assert np.isfinite(result["gpipe"]["loss"])
        assert np.isfinite(result["moe"]["loss"])


def test_an_spmd_worker_handed_a_mesh_runs_the_job(bert_world):
    *_, root, got = bert_world
    done = got[0]["job_master"]
    assert done["finished"] and done["records_done"] == 64 + 16
    assert set(done["metrics"]) == {"accuracy", "auc"}
    # 4 tasks of 2 steps; every rank one trajectory
    for result in got:
        job = result["job"]
        assert job["ok"] and job["step"] == 8
        assert job["losses"] == got[0]["job"]["losses"]
        assert len(job["losses"]) == 8 and np.isfinite(job["losses"]).all()
        assert job["table"] == (32, 32)          # half of the vocab
    # every checkpoint holds the whole table
    saver = CheckpointSaver(str(root / "job_ckpt"))
    assert saver.all_steps()[-1] == 8
    spec = get_model_spec(ZOO_DIR, BERT, model_params=PARAMS)
    state = Trainer(spec.model, spec.optimizer, spec.loss,
                    device="cpu").init_state(0, _batch(0)["features"])
    saver.load_step_into(state, 8)
    assert tuple(state.model.token_embedding.embedding.shape) == (64, 32)
    # the job's SAVE_MODEL export, gathered by every rank, rank 0's write
    exported = load_exported(str(root / "job_out"),
                             template=state.model)
    for name, value in state.model.state_dict().items():
        assert torch.equal(exported[name], value), name

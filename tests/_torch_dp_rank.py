"""One rank of the port's data-parallel tests: an SPMDWorker in a
process of its own (started with torch.multiprocessing's spawn), over a
master the test process serves on 127.0.0.1.  It starts from the
initial parameters the test wrote (`init_path`, flattened flax names)
and writes its final state, its step losses and its state digest to
`out_path`."""

import numpy as np
import torch


def load_init(model, init_path):
    from elasticdl_tpu_torch.common.weights import params_from_jax

    flat = dict(np.load(init_path))
    model.load_state_dict(params_from_jax(model, flat), strict=True)


def instrument(init_path, losses):
    """Patch the port's Trainer: the group's initial state is the carried
    one, and every step's global loss is recorded."""
    from elasticdl_tpu_torch.worker.trainer import Trainer

    init_global = Trainer.init_state_global
    train_global = Trainer.train_on_global_batch

    def carried(self, rng, sample, mesh):
        state = init_global(self, rng, sample, mesh)
        load_init(state.model, init_path)
        return state

    def recorded(self, state, shard, mesh):
        state, loss = train_global(self, state, shard, mesh)
        losses.append(float(loss))
        return state, loss

    Trainer.init_state_global = carried
    Trainer.train_on_global_batch = recorded


def make_worker(rank, world, client, train_dir, model_params, batch,
                coordinator=""):
    from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, \
        get_model_spec
    from elasticdl_tpu_torch.data.reader import TFRecordDataReader
    from elasticdl_tpu_torch.worker.spmd import SPMDWorker

    spec = get_model_spec(ZOO_DIR, "deepfm.deepfm_functional_api.custom_model",
                          model_params=model_params)
    return SPMDWorker(
        worker_id=rank, master_client=client,
        data_reader=TFRecordDataReader(train_dir), spec=spec,
        minibatch_size=batch, process_id=rank, num_processes=world,
        coordinator_address=coordinator, device="cpu", use_bf16=False,
        wait_sleep_s=0.05)


def run_rank(rank, world, master_addr, coordinator, train_dir, model_params,
             batch, init_path, out_path):
    torch.set_num_threads(1)
    from elasticdl_tpu_torch.common import resilience
    from elasticdl_tpu_torch.proto.service import MasterStub
    from elasticdl_tpu_torch.worker.spmd import state_digest

    losses = []
    instrument(init_path, losses)
    client = MasterStub(master_addr, timeout=60,
                        retry_policy=resilience.default_policy(
                            initial_backoff_s=0.01, max_backoff_s=0.1))
    worker = make_worker(rank, world, client, train_dir, model_params,
                         batch, coordinator)
    ok = worker.run()
    torch.save({"ok": ok, "losses": losses,
                "digest": state_digest(worker.state),
                "backend": worker.mesh.backend,
                "state": {k: v.clone() for k, v in
                          worker.state.model.state_dict().items()}},
               out_path)


def restore_rank(rank, coordinator, ckpt_dir, model_def, sample_path,
                 fail_step, out_path):
    """One rank of a group restoring from `ckpt_dir` with SPMDWorker's
    agreed restore; on rank 1 the load of `fail_step` fails (a damaged
    local read).  Writes the restored step."""
    torch.set_num_threads(1)
    from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, \
        get_model_spec
    from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
    from elasticdl_tpu_torch.parallel import mesh as mesh_lib
    from elasticdl_tpu_torch.worker.spmd import SPMDWorker, state_digest
    from elasticdl_tpu_torch.worker.trainer import Trainer

    mesh = mesh_lib.create_mesh(2, rank, "cpu", coordinator,
                                init_timeout_s=60, collective_timeout_s=60)
    spec = get_model_spec(ZOO_DIR, model_def)
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, device="cpu")
    saver = CheckpointSaver(ckpt_dir)
    if rank == 1:
        load = saver.load_step_into

        def flaky(template, step):
            if step == fail_step:
                raise OSError(f"step {step}: read error on this rank")
            return load(template, step)

        saver.load_step_into = flaky
    worker = SPMDWorker.__new__(SPMDWorker)
    worker.mesh, worker.process_id, worker._saver = mesh, rank, saver
    worker.trainer = trainer
    worker.state = trainer.init_state_global(
        0, np.load(sample_path)["features"], mesh)
    worker._restore()
    torch.save({"step": int(worker.state.step),
                "digest": state_digest(worker.state)}, out_path)
    mesh_lib.destroy_mesh(mesh)

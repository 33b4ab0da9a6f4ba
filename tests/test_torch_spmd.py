"""The port's cluster rank (worker/spmd.py) against the JAX package's:

1. one rank (world 1) on the CPU against the JAX single-process SPMD
   worker (tests/test_spmd.py:121): MNIST, the same data and master, the
   port starting from the JAX init (`params_from_jax`);
2. two ranks in processes of their own over gloo on the CPU
   (torch.multiprocessing, spawn) against the JAX step over a 2-device
   CPU mesh of the conftest's 8, and against the port's one rank: tiny
   DeepFM (f32), tasks of 80 records in global batches of 32, so every
   task ends in a padded tail batch.  The two ranks end bit-equal.

Plus the data axis's rules: the backend and device choice, the row
split, the axes that are not ported, and a rank 0 that binds the
coordinator port again while the last group's sockets sit in TIME_WAIT.
"""

import os
import random
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_dp_rank
from elasticdl_tpu.common.args import parse_master_args as jax_master_args
from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.data.reader import TFRecordDataReader as JaxReader
from elasticdl_tpu.master.main import Master as JaxMaster
from elasticdl_tpu.parallel import mesh as jax_mesh
from elasticdl_tpu.proto.service import InProcessMasterClient as JaxClient
from elasticdl_tpu.worker import spmd as jax_spmd
from elasticdl_tpu.worker.trainer import Trainer as JaxTrainer
from elasticdl_tpu_torch.common import args as port_args
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.weights import flatten_params
from elasticdl_tpu_torch.data.reader import TFRecordDataReader
from elasticdl_tpu_torch.master.main import Master
from elasticdl_tpu_torch.model_zoo.deepfm.data import (
    write_dataset as write_criteo,
)
from elasticdl_tpu_torch.model_zoo.mnist.data import (
    write_dataset as write_mnist,
)
from elasticdl_tpu_torch.parallel import mesh as mesh_lib
from elasticdl_tpu_torch.proto.service import InProcessMasterClient
from elasticdl_tpu_torch.worker import trainer as port_trainer
from elasticdl_tpu_torch.worker.spmd import SPMDWorker, state_digest

torch.set_num_threads(2)

MNIST = "mnist.mnist_functional_api.custom_model"
DEEPFM = "deepfm.deepfm_functional_api.custom_model"
FM_PARAMS = "vocab_capacity=1024;embed_dim=4;bf16=False;lr=0.005"
# MNIST, 8 Adam steps (lr 1e-3, batch 32) of one rank against the JAX
# rank on its 8-device mesh: the same arithmetic in another order;
# tests/test_torch_mnist.py measured 1.7e-5 on the losses of 4 steps.
# Adam moves an element by up to lr a step whatever its gradient's size,
# so an element whose gradient is near 0 may move by lr either way: the
# parameters get two steps' worth (measured 8.9e-4)
MNIST_LOSS_TOL = 1e-4
MNIST_PARAM_TOL = 2 * 1e-3
# DeepFM f32, 6 steps: two ranks against one (only the gradient sums'
# order differs: 1.8e-6 measured at vocab 2^16, batch 512) and against
# JAX's 2-device step (tests/test_torch_deepfm.py's F32_TOL per step)
FM_LOSS_TOL = 1e-5
FM_PARAM_TOL = 1e-4


def _owned_port() -> int:
    """A free port below the kernel's ephemeral range.  A port that
    bind(("", 0)) handed out is free only until it is closed: until the
    group binds it, another process's bind to port 0 or outgoing
    connection may take it (seen under xdist as EADDRINUSE at the
    coordinator).  No bind to port 0 and no connect() picks a port below
    the range, so this one stays the test's."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768                        # Linux's default
    rng = random.Random()
    for _ in range(200):
        port = rng.randrange(max(1024, low - 8192), low)
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError(f"no free port below {low}")


def _jax_run(monkeypatch, argv, model_def, params, batch, reader_dir,
             devices=None):
    """The JAX SPMD worker in this process; returns (initial flat params,
    step losses, final flat params, the master)."""
    init, losses = {}, []
    init_global = JaxTrainer.init_state_global
    train_global = JaxTrainer.train_on_global_batch

    def capture(self, rng, sample):
        state = init_global(self, rng, sample)
        init.update(flatten_params(jax.tree.map(
            np.asarray, state.params["params"])))
        return state

    def record(self, state, gb):
        state, loss = train_global(self, state, gb)
        losses.append(float(loss))
        return state, loss

    monkeypatch.setattr(JaxTrainer, "init_state_global", capture)
    monkeypatch.setattr(JaxTrainer, "train_on_global_batch", record)
    if devices is not None:
        real = jax_mesh.create_mesh
        monkeypatch.setattr(jax_mesh, "create_mesh",
                            lambda devs=None, **kw: real(
                                jax.devices()[:devices], **kw))
    master = JaxMaster(jax_master_args(argv))
    spec = jax_spec("model_zoo", model_def, model_params=params)
    worker = jax_spmd.SPMDWorker(
        worker_id=0, master_client=JaxClient(master.servicer),
        data_reader=JaxReader(reader_dir), spec=spec,
        minibatch_size=batch)
    assert worker.run()
    final = flatten_params(jax.tree.map(np.asarray,
                                        worker.state.params["params"]))
    monkeypatch.undo()
    return init, losses, final, master, worker


def _as_torch(model, flat):
    from elasticdl_tpu_torch.common.weights import params_from_jax

    return {k: v.detach() for k, v in params_from_jax(model, flat).items()}


def _max_gap(a, b):
    return max(float((a[k].detach().float() - b[k].float()).abs().max())
               for k in a)


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    return write_mnist(str(tmp_path_factory.mktemp("spmd_mnist")),
                       n_train=256, n_val=64)


def test_one_rank_matches_the_jax_single_process_worker(mnist,
                                                        monkeypatch,
                                                        tmp_path):
    train_dir, val_dir = mnist
    argv = ["--training_data", train_dir, "--validation_data", val_dir,
            "--records_per_task", "64", "--num_epochs", "1"]
    init, jax_losses, jax_final, jax_master, _ = _jax_run(
        monkeypatch, argv, MNIST, "", 32, train_dir)
    np.savez(tmp_path / "init.npz", **init)

    losses = []
    _torch_dp_rank_instrument(monkeypatch, str(tmp_path / "init.npz"),
                              losses)
    master = Master(port_args.parse_master_args(
        argv + ["--model_def", MNIST, "--device", "cpu"]))
    spec = get_model_spec(ZOO_DIR, MNIST)
    worker = SPMDWorker(worker_id=0,
                        master_client=InProcessMasterClient(master.servicer),
                        data_reader=TFRecordDataReader(train_dir), spec=spec,
                        minibatch_size=32, device="cpu")
    assert worker.run()
    assert master.task_manager.finished
    assert master.task_manager.counters.records_done >= 256
    assert int(worker.state.step) == 256 // 32 == len(losses)
    assert worker.mesh.world_size == 1 and worker.mesh.group is None
    gaps = [abs(a - b) for a, b in zip(losses, jax_losses)]
    assert len(losses) == len(jax_losses) and max(gaps) < MNIST_LOSS_TOL, \
        (losses, jax_losses)
    want = _as_torch(worker.state.model, jax_final)
    got = dict(worker.state.model.named_parameters())
    assert _max_gap({k: got[k] for k in want}, want) < MNIST_PARAM_TOL
    # the final evaluation round ran on the rank, as on the JAX one
    port_metrics = master.evaluation_service.latest_metrics()
    jax_metrics = jax_master.evaluation_service.latest_metrics()
    assert port_metrics is not None and "accuracy" in port_metrics
    assert abs(port_metrics["accuracy"] - jax_metrics["accuracy"]) <= \
        1.0 / 64 + 1e-9


def test_steps_per_execution_gives_the_same_bits(mnist):
    """K = 2 data-parallel steps per trainer call over local stacks end
    on the state K = 1 reaches, bit for bit (the JAX contract for its
    scanned stack)."""
    train_dir, _ = mnist
    digests = []
    for k in (1, 2):
        master = Master(port_args.parse_master_args(
            ["--training_data", train_dir, "--records_per_task", "64",
             "--model_def", MNIST, "--device", "cpu"]))
        worker = SPMDWorker(
            worker_id=0, master_client=InProcessMasterClient(
                master.servicer),
            data_reader=TFRecordDataReader(train_dir),
            spec=get_model_spec(ZOO_DIR, MNIST), minibatch_size=32,
            device="cpu", steps_per_execution=k)
        assert worker.run() and int(worker.state.step) == 8
        digests.append(state_digest(worker.state))
    assert digests[0] == digests[1]


def _torch_dp_rank_instrument(monkeypatch, init_path, losses):
    """_torch_dp_rank.instrument, undone after the test."""
    monkeypatch.setattr(port_trainer.Trainer, "init_state_global",
                        port_trainer.Trainer.init_state_global)
    monkeypatch.setattr(port_trainer.Trainer, "train_on_global_batch",
                        port_trainer.Trainer.train_on_global_batch)
    _torch_dp_rank.instrument(init_path, losses)


@pytest.fixture(scope="module")
def criteo(tmp_path_factory):
    return write_criteo(str(tmp_path_factory.mktemp("spmd_fm")),
                        n_train=160, n_val=48, shards=1)


def _fm_argv(data):
    # the final evaluation round: 48 records, a full batch and a padded
    # tail, each rank predicting its rows and gathering the others'
    train_dir, val_dir = data
    return ["--training_data", train_dir, "--validation_data", val_dir,
            "--records_per_task", "80", "--num_epochs", "1"]


def test_two_gloo_ranks_are_one_model_and_match_jax_and_one_rank(
        criteo, monkeypatch, tmp_path):
    # the JAX rank on a 2-device mesh: one program over the global batch
    train_dir = criteo[0]
    init, jax_losses, jax_final, jax_master, jax_worker = _jax_run(
        monkeypatch, _fm_argv(criteo), DEEPFM, FM_PARAMS, 32, train_dir,
        devices=2)
    assert dict(jax_worker.mesh.shape)["data"] == 2
    init_path = str(tmp_path / "init.npz")
    np.savez(init_path, **init)

    # two port ranks, processes of their own, over one master's socket
    master = Master(port_args.parse_master_args(
        _fm_argv(criteo) + ["--model_def", DEEPFM, "--device", "cpu"]))
    port = master.start_rpc(0)
    ctx = torch.multiprocessing.get_context("spawn")
    coordinator = f"127.0.0.1:{_owned_port()}"
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [ctx.Process(target=_torch_dp_rank.run_rank, args=(
        r, 2, f"127.0.0.1:{port}", coordinator, train_dir, FM_PARAMS, 32,
        init_path, outs[r])) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=240)
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        master.stop()
    assert master.task_manager.finished
    assert master.task_manager.counters.records_done == 160 + 48
    ranks = [torch.load(o) for o in outs]
    # the leader reported the evaluation of all 48 rows, gathered from
    # both ranks: the JAX rank's metrics within the step tolerance
    metrics = master.evaluation_service.latest_metrics()
    jax_metrics = jax_master.evaluation_service.latest_metrics()
    assert set(metrics) == set(jax_metrics) and metrics
    for name, value in jax_metrics.items():
        assert abs(metrics[name] - value) < 1e-4, (metrics, jax_metrics)
    assert all(r["ok"] for r in ranks)
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    # one model: the ranks' states are equal bit for bit
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for key, value in ranks[0]["state"].items():
        assert torch.equal(value, ranks[1]["state"][key]), key
    assert ranks[0]["losses"] == ranks[1]["losses"]
    # 2 tasks x (2 full batches + a padded tail)
    assert len(ranks[0]["losses"]) == len(jax_losses) == 6

    # the port's one rank, the same master flow, in this process
    losses = []
    _torch_dp_rank_instrument(monkeypatch, init_path, losses)
    one_master = Master(port_args.parse_master_args(
        _fm_argv(criteo) + ["--model_def", DEEPFM, "--device", "cpu"]))
    one = _torch_dp_rank.make_worker(0, 1, InProcessMasterClient(
        one_master.servicer), train_dir, FM_PARAMS, 32)
    assert one.run()
    one_state = {k: v.detach() for k, v in
                 one.state.model.state_dict().items()}
    assert _max_gap(one_state, ranks[0]["state"]) < FM_PARAM_TOL
    assert max(abs(a - b) for a, b in zip(losses, ranks[0]["losses"])) \
        < FM_LOSS_TOL
    # and JAX's 2-device step
    assert max(abs(a - b) for a, b in zip(jax_losses, ranks[0]["losses"])) \
        < FM_LOSS_TOL, (jax_losses, ranks[0]["losses"])
    want = _as_torch(one.state.model, jax_final)
    assert _max_gap({k: ranks[0]["state"][k] for k in want}, want) \
        < FM_PARAM_TOL


# ---- the data axis's rules -------------------------------------------------


def test_backend_and_device_follow_the_stated_rule(monkeypatch):
    cpu = torch.device("cpu")
    assert mesh_lib.backend_for(1, cpu) == mesh_lib.backend_for(4, cpu) \
        == "gloo"
    assert mesh_lib.device_for_rank(3, "cpu") == cpu
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    one_card = torch.device("cuda", 0)
    # two ranks on one card: NCCL refuses them, so gloo
    assert mesh_lib.backend_for(2, one_card) == "gloo"
    assert mesh_lib.backend_for(1, one_card) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh_lib.backend_for(4, one_card) == "nccl"
    assert mesh_lib.backend_for(5, one_card) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mesh_lib.device_for_rank(6, "cuda") == torch.device("cuda", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mesh_lib.device_for_rank(0, "cuda")


def test_row_split_and_batches():
    mesh = mesh_lib.DataMesh(3, 0, torch.device("cpu"))
    spans = [mesh_lib.local_batch_range(
        mesh_lib.DataMesh(3, r, torch.device("cpu")), 32) for r in range(3)]
    assert spans == [(0, 11), (11, 22), (22, 32)]
    batch = {"features": {"x": np.arange(32 * 2).reshape(32, 2)},
             "labels": np.arange(32)}
    shard = mesh_lib.make_global_batch(batch, mesh, lambda b: b)
    assert shard.rows == 11 and shard.global_rows == 32
    assert list(shard.batch["labels"]) == list(range(11))
    local = {"features": {"x": np.zeros((11, 2))}, "labels": np.zeros(11)}
    assert mesh_lib.make_global_batch_from_local(
        local, mesh, 32, 0, lambda b: b).rows == 11
    with pytest.raises(IndexError):
        mesh_lib.make_global_batch_from_local(local, mesh, 32, 5,
                                              lambda b: b)
    padded, real = mesh_lib.pad_to_multiple(
        {"x": np.arange(5)}, 4)
    assert real == 5 and list(padded["x"]) == [0, 1, 2, 3, 4, 0, 1, 2]
    # the reference's helpers agree where both apply
    assert jax_mesh.pad_to_multiple({"x": np.arange(5)}, 4)[1] == real


_REBIND = """
import datetime, sys, torch, torch.distributed as dist
rank, port = int(sys.argv[1]), int(sys.argv[2])
sys.path.insert(0, sys.argv[3])
from elasticdl_tpu_torch.parallel import collectives, mesh as mesh_lib
mesh = mesh_lib.create_mesh(2, rank, "cpu", f"127.0.0.1:{port}",
                            init_timeout_s=30, collective_timeout_s=30)
t = torch.full((4,), float(rank + 1))
collectives.all_reduce_sum_([t], mesh)
assert t.tolist() == [3.0] * 4, t
mesh_lib.destroy_mesh(mesh)
"""


def test_a_new_rank_0_binds_the_coordinator_port_again():
    """Two groups in a row on one coordinator port: the second rank 0
    binds it while the first group's connections sit in TIME_WAIT (a
    topology restart does this).  Each rank exits 0 after destroy_mesh
    (a gloo group freed at interpreter exit sometimes aborted it)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _owned_port()
    for _ in range(2):
        procs = [subprocess.Popen(
            [sys.executable, "-c", _REBIND, str(r), str(port), repo],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
            for r in range(2)]
        outs = [p.communicate(timeout=120)[0] for p in procs]
        assert [p.returncode for p in procs] == [0, 0], outs


def test_elastic_mesh_manager_follows_the_epochs_as_the_reference():
    """parallel/elastic.py against the JAX manager over one master's
    rendezvous: the same epochs, world sizes and ranks; the port's data
    axis on the device `devices_for_world` gives."""
    from elasticdl_tpu.master.rendezvous_server import RendezvousServer \
        as JaxRendezvous
    from elasticdl_tpu.master.servicer import MasterServicer as JaxServicer
    from elasticdl_tpu.parallel.elastic import ElasticMeshManager as JaxEMM
    from elasticdl_tpu_torch.master.rendezvous_server import \
        RendezvousServer
    from elasticdl_tpu_torch.master.servicer import MasterServicer
    from elasticdl_tpu_torch.master.task_manager import TaskManager
    from elasticdl_tpu_torch.parallel.elastic import ElasticMeshManager
    from elasticdl_tpu.master.task_manager import TaskManager as JaxTM

    port_rdzv, jax_rdzv = RendezvousServer(), JaxRendezvous()
    port = ElasticMeshManager(
        InProcessMasterClient(MasterServicer(TaskManager(),
                                             rendezvous_server=port_rdzv)),
        worker_id=1, devices_for_world=lambda n: torch.device("cpu"))
    ref = JaxEMM(JaxClient(JaxServicer(JaxTM(), rendezvous_server=jax_rdzv)),
                 worker_id=1,
                 devices_for_world=lambda n: jax.devices()[:n])
    seen = []
    for verb, worker in (("add", 1), ("add", 0), ("add", 2),
                         ("remove", 0)):
        for rdzv in (port_rdzv, jax_rdzv):
            getattr(rdzv, f"{verb}_worker")(worker)
        assert port.needs_remesh() and ref.needs_remesh()
        mesh, jax_m = port.build_mesh(), ref.build_mesh()
        assert not port.needs_remesh()
        assert (port.world_size, port.rank, port.remesh_count) == \
            (ref.world_size, ref.rank, ref.remesh_count)
        assert mesh.world_size == dict(jax_m.shape)["data"]
        assert mesh.rank == port.rank and mesh.group is None
        seen.append((port.world_size, port.rank))
    assert seen == [(1, 0), (2, 1), (3, 1), (2, 0)]
    port_rdzv.remove_worker(1)
    jax_rdzv.remove_worker(1)
    assert port.build_mesh() is None and ref.build_mesh() is None


def test_host_snapshot_owns_its_copy():
    from elasticdl_tpu_torch.parallel import collectives

    live = {"w": torch.ones(3), "n": np.arange(2), "k": 5}
    snap = collectives.host_snapshot(live)
    live["w"].add_(1.0)
    live["n"] += 1
    assert snap["w"].tolist() == [1.0, 1.0, 1.0]
    assert snap["n"].tolist() == [0, 1] and snap["k"] == 5
    one = mesh_lib.DataMesh(1, 0, torch.device("cpu"))
    assert collectives.host_allgather(torch.arange(4), one).tolist() == \
        [0, 1, 2, 3]


def test_state_digest_tells_states_apart():
    spec = get_model_spec(ZOO_DIR, MNIST)
    trainer = port_trainer.Trainer(spec.model, spec.optimizer, spec.loss,
                                   device="cpu")
    x = np.zeros((2, 28, 28), np.float32)
    a = trainer.init_state(0, x)
    b = trainer.init_state(0, x)
    assert state_digest(a) == state_digest(b)
    b.step += 1
    assert state_digest(a) != state_digest(b)

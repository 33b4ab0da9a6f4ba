"""The master's serving fleet, the port against the JAX package: one argv
builds each package's `Master` over a `FakeK8sClient`, and the serving
pods (names, labels, worker ids), the services requested, the engines
built and the sections the fleet adds to `snapshot()` must be equal.
The replica pods' commands differ only in the package (its module and
its own zoo), the port's `--device`, and the port's `--feature_spec`:
the JAX master's command over a checkpoint directory has no serving
signature, and `serve` refuses a checkpoint directory without one
(`test_the_reference_replica_command_has_no_signature`)."""

import json
import os
import socket

import numpy as np
import pytest

from elasticdl_tpu.common import args as jax_args
from elasticdl_tpu.common import k8s_client as jax_k8s
from elasticdl_tpu.master import main as jax_main
from elasticdl_tpu_torch.common import args as torch_args
from elasticdl_tpu_torch.common import k8s_client as torch_k8s
from elasticdl_tpu_torch.common.export import SINGLE_FEATURE_KEY
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR
from elasticdl_tpu_torch.master import main as torch_main
from elasticdl_tpu_torch.model_zoo.mnist.data import write_dataset

MODEL = "mnist.mnist_functional_api.custom_model"
PACKAGES = {"jax": (jax_args, jax_main, jax_k8s.FakeK8sClient),
            "torch": (torch_args, torch_main, torch_k8s.FakeK8sClient)}
# the sections the fleet adds to Master.snapshot()
FLEET_SECTIONS = ("serving_fleet", "serving_policy", "freshness")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def train_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("master_fleet")
    return write_dataset(str(root), n_train=64, n_val=0)[0]


def _argv(train_dir, extra):
    return ["--distribution_strategy", "AllReduce", "--num_workers", "2",
            "--job_name", "fleet", "--training_data", train_dir,
            "--records_per_task", "32", "--minibatch_size", "16",
            "--model_def", MODEL, "--serving_port", "50071"] + extra


def _built(name, argv):
    """One package's master, started and stopped over a fake cluster:
    what it built and asked the cluster for."""
    args_lib, main, fake = PACKAGES[name]
    k8s = fake()
    master = main.Master(args_lib.parse_master_args(
        argv + ["--port", str(_free_port())]), k8s_client=k8s)
    master.start()
    try:
        snapshot = master.snapshot()
    finally:
        master.stop()
    serving = [spec for spec in k8s.create_calls
               if spec.pod_type == "serving"]
    return {
        "engines": {attr: getattr(master, attr) is not None
                    for attr in ("policy_engine", "serving_fleet",
                                 "serving_policy", "freshness")},
        "pods": [(spec.name, spec.worker_id, dict(spec.labels))
                 for spec in serving],
        "commands": [list(spec.command) for spec in serving],
        "services": dict(getattr(k8s, "services", {})),
        "sections": sorted(snapshot),
        "fleet": {key: snapshot[key] for key in FLEET_SECTIONS
                  if key in snapshot},
    }


CASES = {
    "fleet_and_policy_with_checkpoints": [
        "--serving_replicas", "2", "--max_serving_replicas", "3",
        "--checkpoint_dir", "{ckpt}"],
    "fleet_and_policy": ["--serving_replicas", "2",
                         "--max_serving_replicas", "3"],
    "fleet_without_policy": ["--serving_replicas", "2",
                             "--checkpoint_dir", "{ckpt}"],
    "no_fleet": ["--max_serving_replicas", "3"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_masters_build_one_serving_fleet(train_dir, tmp_path, case):
    argv = _argv(train_dir, [a.format(ckpt=str(tmp_path / "ckpt"))
                             for a in CASES[case]])
    jax, port = _built("jax", argv), _built("torch", argv)
    for key in ("engines", "pods", "services", "sections", "fleet"):
        assert port[key] == jax[key], key
    want = case != "no_fleet"
    assert port["engines"] == {"policy_engine": True, "serving_fleet": want,
                               "serving_policy": "--max_serving_replicas"
                               in CASES[case] and want,
                               "freshness": want}
    if not want:
        assert port["pods"] == [] and port["services"] == {}
        return
    assert [p[0] for p in port["pods"]] == ["fleet-serving-0-0",
                                            "fleet-serving-1-0"]
    assert port["services"]["fleet-serving-0"]["port"] == 50071
    assert set(FLEET_SECTIONS[:1] + FLEET_SECTIONS[2:]) <= set(
        port["sections"])
    for jax_cmd, torch_cmd in zip(jax["commands"], port["commands"]):
        assert jax_cmd[1:4] == ["-m", "elasticdl_tpu.client.main", "serve"]
        assert torch_cmd[1:4] == ["-m", "elasticdl_tpu_torch.client.main",
                                  "serve"]
        jax_flags = dict(zip(jax_cmd[4::2], jax_cmd[5::2]))
        torch_flags = dict(zip(torch_cmd[4::2], torch_cmd[5::2]))
        # each package names its own zoo, by its default
        assert jax_flags.pop("--model_zoo") == "model_zoo"
        assert torch_flags.pop("--model_zoo") == ZOO_DIR
        assert torch_flags.pop("--device") == "cuda"
        if "--checkpoint_dir" in jax_flags:
            signature = json.loads(torch_flags.pop("--feature_spec"))
            assert signature == {SINGLE_FEATURE_KEY: {"shape": [784],
                                                      "dtype": "float32"}}
        assert torch_flags == jax_flags


def test_the_replica_command_forwards_the_device(train_dir, tmp_path):
    _, main, fake = PACKAGES["torch"]
    master = main.Master(torch_args.parse_master_args(_argv(
        train_dir, ["--serving_replicas", "1", "--device", "cpu",
                    "--checkpoint_dir", str(tmp_path / "ckpt")])),
        k8s_client=fake())
    command = master._serving_command(0)
    assert command[-2:] == ["--device", "cpu"]
    # computed once, from the first training record through the feed
    assert master.serving_signature() is master.serving_signature()


def test_the_reference_replica_command_has_no_signature(train_dir,
                                                        tmp_path):
    """The JAX master's replica over a checkpoint directory: `serve`
    refuses to build it (no --feature_spec); the port's command builds a
    serving server from its own flags."""
    from elasticdl_tpu.client import api as jax_api
    from elasticdl_tpu.client import main as jax_cli
    from elasticdl_tpu_torch.client import api as torch_api
    from elasticdl_tpu_torch.client import main as torch_cli

    argv = _argv(train_dir, ["--serving_replicas", "1",
                             "--checkpoint_dir", str(tmp_path / "ckpt"),
                             "--device", "cpu"])
    jax_master = jax_main.Master(jax_args.parse_master_args(argv),
                                 k8s_client=jax_k8s.FakeK8sClient())
    with pytest.raises(ValueError, match="--feature_spec"):
        jax_api.build_serving_server(jax_cli._build_parser().parse_args(
            jax_master._serving_command(0)[3:]))
    # a committed step for the port's replica to serve
    from elasticdl_tpu_torch.common.model_handler import get_model_spec
    from elasticdl_tpu_torch.common.save_utils import CheckpointSaver
    from elasticdl_tpu_torch.worker.trainer import Trainer

    spec = get_model_spec(ZOO_DIR, MODEL)
    state = Trainer(spec.model, spec.optimizer, spec.loss,
                    device="cpu").init_state(0, np.zeros((1, 784), np.float32))
    state.step = 1
    saver = CheckpointSaver(str(tmp_path / "ckpt"))
    saver.save(state)
    saver.wait_until_finished()
    torch_master = torch_main.Master(torch_args.parse_master_args(argv),
                                     k8s_client=torch_k8s.FakeK8sClient())
    args = torch_cli.parse_args(torch_master._serving_command(0)[3:])
    assert args.device == "cpu"
    assert json.loads(args.feature_spec) == {
        SINGLE_FEATURE_KEY: {"shape": [784], "dtype": "float32"}}
    server = torch_api.build_serving_server(args)
    try:
        assert server.engine.step == 1
    finally:
        server.stop(grace=0)

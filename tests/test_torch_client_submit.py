"""`elasticdl train|evaluate|predict` with a cluster strategy: the
port's `_submit_master_pod` against the JAX client's, each on its
package's `FakeK8sClient` (the JAX side's `K8sClient` patched to the
fake): the same master pod (name, type, image, resources, volumes) and
the same Service, the command naming the port's master entry point
with the job's flags (the policy engine's and `--compilation_cache_dir`
among them) as the JAX command carries them, which the port's master
parser reads back.  With
the default client, the real Kubernetes one, the submission raises
naming KUBECONFIG when no cluster is configured, and reaches the stub
API server when a kubeconfig names it.  Also the JAX parser's helpers the
port carries: `add_evaluate_params`, `add_predict_params` and
`wrap_python_args_with_string`.
"""

import argparse
import dataclasses

import pytest

import _torch_k8s_stub
from elasticdl_tpu.client import api as jax_api
from elasticdl_tpu.client import main as jax_cli
from elasticdl_tpu.common import args as jax_args
from elasticdl_tpu.common import k8s_client as jax_k8s
from elasticdl_tpu_torch.client import api
from elasticdl_tpu_torch.client import main as cli
from elasticdl_tpu_torch.common import args as port_args
from elasticdl_tpu_torch.common import k8s_client as port_k8s
from elasticdl_tpu_torch.common.k8s_config import K8sConfigError

ARGV = ["--distribution_strategy", "AllReduce",
        "--model_def", "mnist.mnist_functional_api.custom_model",
        "--training_data", "/data/train", "--validation_data", "/data/val",
        "--minibatch_size", "32", "--num_workers", "3",
        "--job_name", "mnist-job", "--namespace", "research",
        "--image_name", "registry/mnist:1", "--port", "50123",
        "--volume", "host_path=/a,mount_path=/b;claim_name=pvc,"
        "mount_path=/c",
        # the policy engine's bounds and thresholds, and the library cache
        "--policy_interval", "0.5", "--min_workers", "1",
        "--max_workers", "4", "--backlog_per_worker", "2.0",
        "--backlog_ticks", "2", "--data_wait_share", "1.0",
        "--scale_hold_ticks", "2", "--straggler_dwell_s", "15.0",
        "--eviction_budget", "1", "--scale_step", "2",
        "--compilation_cache_dir", "/c/cache"]


def _pairs(command):
    """{flag: value} of an argv of `--flag value` pairs."""
    assert len(command) % 2 == 0
    return {command[i][2:]: command[i + 1]
            for i in range(0, len(command), 2)}


def _submit_both(monkeypatch, job_type):
    jfake, pfake = jax_k8s.FakeK8sClient(), port_k8s.FakeK8sClient()
    made = []

    def jax_client(namespace, job_name):
        made.append((namespace, job_name))
        return jfake

    monkeypatch.setattr(jax_k8s, "K8sClient", jax_client)
    jargs = jax_cli._build_parser().parse_args([job_type, *ARGV])
    pargs = cli.parse_args([job_type, *ARGV])
    assert getattr(jax_api, job_type)(jargs) == 0
    assert api._submit_master_pod(pargs, job_type, client=pfake) == 0
    assert made == [("research", "mnist-job")]
    return jfake, pfake, pargs


@pytest.mark.parametrize("job_type", ["train", "evaluate", "predict"])
def test_the_master_pod_and_service_are_the_jax_clients(monkeypatch,
                                                        job_type):
    jfake, pfake, pargs = _submit_both(monkeypatch, job_type)
    (jpod,), (ppod,) = jfake.create_calls, pfake.create_calls
    for field in dataclasses.fields(jpod):
        if field.name != "command":
            assert getattr(ppod, field.name) == getattr(jpod, field.name), \
                field.name
    assert ppod.name == "mnist-job-master"
    assert ppod.volumes == [{"host_path": "/a", "mount_path": "/b"},
                            {"claim_name": "pvc", "mount_path": "/c"}]
    assert pfake.services == jfake.services == {"mnist-job-master": {
        "selector": {"elasticdl-job": "mnist-job",
                     "elasticdl-type": "master"}, "port": 50123}}
    # the command: the package differs; each flag the user gave and the
    # job type go to both masters alike (the parsers' defaults differ
    # where the packages do, and the JAX client also passes its parser's
    # subcommand, which the port's strict master parser does not take)
    assert jpod.command[:3] == ["python", "-m", "elasticdl_tpu.master.main"]
    assert ppod.command[:3] == ["python", "-m",
                                "elasticdl_tpu_torch.master.main"]
    jflags, pflags = _pairs(jpod.command[3:]), _pairs(ppod.command[3:])
    assert jflags.pop("command") == job_type and "command" not in pflags
    for flag, value in {**_pairs(ARGV), "job_type": job_type}.items():
        assert pflags[flag] == jflags[flag] == value, flag
    # and every other flag of the JAX command, defaults included, as the
    # JAX command carries it (the zoo is each package's own)
    assert set(jflags) - {"model_zoo"} <= set(pflags)
    for flag in set(jflags) - {"model_zoo"}:
        assert pflags[flag] == jflags[flag], flag
    # the master reads the command back into the client's settings
    master = port_args.parse_master_args(ppod.command[3:])
    for key, value in vars(pargs).items():
        if key not in ("func", "command"):
            assert getattr(master, key) == value, key


def test_the_default_client_needs_kubernetes(capsys, monkeypatch,
                                             tmp_path):
    """The JAX default client needs the `kubernetes` package.  The
    port's talks to the API server itself: with no cluster configured it
    raises naming KUBECONFIG, and with a kubeconfig for the stub API
    server it creates the master pod and its Service there."""
    _torch_k8s_stub.no_cluster(monkeypatch, tmp_path)
    args = cli.parse_args(["train", *ARGV])
    with pytest.raises(K8sConfigError, match="KUBECONFIG"):
        api.train(args)
    with pytest.raises(ImportError, match="kubernetes"):
        jax_api.train(jax_cli._build_parser().parse_args(["train", *ARGV]))
    assert cli.main(["train", *ARGV]) == 1
    assert "KUBECONFIG" in capsys.readouterr().err
    with _torch_k8s_stub.stub_cluster(monkeypatch, tmp_path,
                                      kubelet=False) as stub:
        assert cli.main(["train", *ARGV]) == 0
    assert [(kind, body["metadata"]["name"])
            for kind, body in stub.bodies] == [
        ("pod", "mnist-job-master"), ("service", "mnist-job-master")]
    assert [(r["verb"], r["path"]) for r in stub.requests] == [
        ("POST", "/api/v1/namespaces/research/pods"),
        ("POST", "/api/v1/namespaces/research/services")]


def test_run_local_still_refuses_a_cluster_strategy():
    with pytest.raises(ValueError, match="cluster"):
        api.run_local(cli.parse_args(["train", *ARGV]), "train")


@pytest.mark.parametrize("adder", ["add_evaluate_params",
                                   "add_predict_params"])
def test_job_param_adders_parse_as_the_jax_ones(adder):
    argv = ["--minibatch_size", "8", "--checkpoint_dir_for_init", "/ck",
            "--records_per_task", "16", "--data_reader_params", "a=1"]
    argv += (["--validation_data", "/v"] if "evaluate" in adder
             else ["--prediction_data", "/p"])
    parsed = []
    for module in (jax_args, port_args):
        parser = argparse.ArgumentParser()
        getattr(module, adder)(parser)
        parsed.append((vars(parser.parse_args(argv)),
                       vars(parser.parse_args([]))))
    assert parsed[0] == parsed[1]


def test_wrapped_python_args_are_the_jax_ones():
    argv = ["--model_def", "a.b.c", "--model_params", "x=1;y='z'",
            "--num_workers", "2"]
    assert port_args.wrap_python_args_with_string(argv) == \
        jax_args.wrap_python_args_with_string(argv)

"""The port stands alone: no module of elasticdl_tpu_torch, and not
chip_smoke.py, imports jax, flax, optax, orbax, tensorstore, zstandard,
grain, protobuf, grpc, msgpack, ml_dtypes, kubernetes, elasticdl_tpu or
model_zoo — at import time
(checked in a subprocess that blocks them) or lazily inside a function
(checked on the source).
And the entry points pick the GPU unless told "cpu"."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from elasticdl_tpu_torch import device as device_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "elasticdl_tpu_torch")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "elasticdl_tpu",
           "model_zoo", "google.protobuf", "grpc", "ml_dtypes", "msgpack",
           "kubernetes", "zstandard", "tensorstore", "grain")


def _blocked(name: str) -> bool:
    """`name` is a blocked module or inside one."""
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PACKAGE):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


_IMPORT_ALL = textwrap.dedent("""
    import importlib, importlib.abc, importlib.util, os, pkgutil, sys
    BLOCKED = {blocked!r}

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    for name in list(sys.modules):
        if blocked(name):
            del sys.modules[name]

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, fullname, path=None, target=None):
            if blocked(fullname):
                raise ImportError(f"blocked import of {{fullname}}")
            return None

    sys.meta_path.insert(0, Blocker())
    sys.path.insert(0, {repo!r})
    import elasticdl_tpu_torch
    names = ["elasticdl_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            elasticdl_tpu_torch.__path__, "elasticdl_tpu_torch.")
    ]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join({repo!r}, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)   # defines main(); does not run it
    leaked = sorted(n for n in sys.modules if blocked(n))
    assert not leaked, leaked
    print(" ".join(names))
""")

# the serving slice's modules (each must be among those imported above)
SERVING_MODULES = (
    "elasticdl_tpu_torch.proto.serving",
    "elasticdl_tpu_torch.proto.service",
    "elasticdl_tpu_torch.serving.server",
    "elasticdl_tpu_torch.serving.reloader",
    "elasticdl_tpu_torch.serving.engine",
    "elasticdl_tpu_torch.common.telemetry",
    "elasticdl_tpu_torch.common.export",
)

# the rest of the zoo, its readers and the preprocessing layers
ZOO_MODULES = (
    "elasticdl_tpu_torch.preprocessing.layers",
    "elasticdl_tpu_torch.data.reader.csv_reader",
    "elasticdl_tpu_torch.data.reader.memory_reader",
    "elasticdl_tpu_torch.data.reader.table_reader",
    "elasticdl_tpu_torch.model_zoo.census.wide_and_deep",
    "elasticdl_tpu_torch.model_zoo.census.data",
    "elasticdl_tpu_torch.model_zoo.deepfm.xdeepfm",
    "elasticdl_tpu_torch.model_zoo.mnist.mnist_functional_api",
    "elasticdl_tpu_torch.model_zoo.mnist.mnist_subclass",
    "elasticdl_tpu_torch.model_zoo.mnist.data",
    "elasticdl_tpu_torch.model_zoo.cifar10.resnet",
    "elasticdl_tpu_torch.model_zoo.cifar10.data",
    "elasticdl_tpu_torch.model_zoo.clickstream.ctr_mlp",
)


# the resilience slice: faults, retries, constants, summaries and the
# native TFRecord scanner's bindings
RESILIENCE_MODULES = (
    "elasticdl_tpu_torch.common.constants",
    "elasticdl_tpu_torch.common.faults",
    "elasticdl_tpu_torch.common.resilience",
    "elasticdl_tpu_torch.common.summary",
    "elasticdl_tpu_torch.data.native_io",
)


# streams and judgment: the stream reader, the metric history, SLOs,
# the flight recorder, window lineage and freshness
JUDGMENT_MODULES = (
    "elasticdl_tpu_torch.data.reader.stream_reader",
    "elasticdl_tpu_torch.common.history",
    "elasticdl_tpu_torch.common.slo",
    "elasticdl_tpu_torch.common.flight",
    "elasticdl_tpu_torch.common.lineage",
    "elasticdl_tpu_torch.master.freshness",
)


# the online loop: the k8s seam, the traffic generator, the sharded
# store, the serving fleet, the policy engines and the pipeline
ONLINE_MODULES = (
    "elasticdl_tpu_torch.common.k8s_client",
    "elasticdl_tpu_torch.traffic",
    "elasticdl_tpu_torch.traffic.generator",
    "elasticdl_tpu_torch.store.sharding",
    "elasticdl_tpu_torch.master.serving_fleet",
    "elasticdl_tpu_torch.master.policy",
    "elasticdl_tpu_torch.online",
    "elasticdl_tpu_torch.online.pipeline",
)


# the program observatory, the operator commands and the export runner
OBSERVATORY_MODULES = (
    "elasticdl_tpu_torch.common.programs",
    "elasticdl_tpu_torch.client.top",
    "elasticdl_tpu_torch.client.slo",
    "elasticdl_tpu_torch.client.programs",
    "elasticdl_tpu_torch.client.trace",
    "elasticdl_tpu_torch.client.lineage",
    "elasticdl_tpu_torch.client.incident",
    "elasticdl_tpu_torch.serving.run_export",
)


# the elastic cluster: the data axis, collectives, the rendezvous, the
# pod manager, the recovery clock, the master's socket transport, the
# ranks and their entry point
CLUSTER_MODULES = (
    "elasticdl_tpu_torch.parallel",
    "elasticdl_tpu_torch.parallel.mesh",
    "elasticdl_tpu_torch.parallel.collectives",
    "elasticdl_tpu_torch.parallel.elastic",
    "elasticdl_tpu_torch.master.rendezvous_server",
    "elasticdl_tpu_torch.master.spmd_assigner",
    "elasticdl_tpu_torch.master.recovery",
    "elasticdl_tpu_torch.master.pod_manager",
    "elasticdl_tpu_torch.master.server",
    "elasticdl_tpu_torch.common.http_rpc",
    "elasticdl_tpu_torch.common.net_utils",
    "elasticdl_tpu_torch.common.preemption",
    "elasticdl_tpu_torch.worker.spmd",
    "elasticdl_tpu_torch.worker.main",
)


def test_every_port_module_imports_with_jax_and_reference_blocked():
    proc = subprocess.run(
        [sys.executable, "-c",
         _IMPORT_ALL.format(blocked=BLOCKED, repo=REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    names = proc.stdout.strip().splitlines()[-1].split()
    # every module of the slices, down to the BERT zoo's data writer and
    # the serving front end
    assert len(names) >= 59 + len(ZOO_MODULES) + len(RESILIENCE_MODULES) \
        + len(JUDGMENT_MODULES) + len(ONLINE_MODULES) \
        + len(OBSERVATORY_MODULES) + len(CLUSTER_MODULES)
    assert set(SERVING_MODULES) <= set(names)
    assert set(ONLINE_MODULES) <= set(names)
    assert set(ZOO_MODULES) <= set(names)
    assert set(RESILIENCE_MODULES) <= set(names)
    assert set(JUDGMENT_MODULES) <= set(names)
    assert set(OBSERVATORY_MODULES) <= set(names)
    assert set(CLUSTER_MODULES) <= set(names)


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_jax_or_the_reference_anywhere_in_source(path):
    """Lazy imports inside functions never run at import time; the AST
    sees them."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert not _blocked(name), (
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports "
                f"{name}")


def test_no_port_source_reaches_the_reference_native_directory():
    """The native scanner builds from the port's own copy of the C++
    source (elasticdl_tpu_torch/hostsrc/), never from the JAX package's
    native/ directory, not even lazily."""
    from elasticdl_tpu_torch.data import native_io
    from elasticdl_tpu_torch.ops import _build

    host = os.path.join(PACKAGE, "hostsrc")
    paths = _port_sources() + [os.path.join(host, f)
                               for f in os.listdir(host)]
    for path in paths:
        text = open(path).read()
        assert "native/" not in text, os.path.relpath(path, REPO)
        assert "'native'" not in text and '"native",' not in text, \
            os.path.relpath(path, REPO)
    assert str(_build.HOSTSRC_DIR) == host
    assert os.path.isfile(os.path.join(host, native_io.SOURCE))


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_lib.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_lib.resolve_device("cuda")


@pytest.mark.parametrize("model_def", [
    "census.wide_and_deep.custom_model", "deepfm.xdeepfm.custom_model",
    "mnist.mnist_functional_api.custom_model",
    "mnist.mnist_subclass.custom_model", "cifar10.resnet.custom_model",
    "clickstream.ctr_mlp.custom_model"])
def test_zoo_local_jobs_need_cuda_unless_asked(monkeypatch, model_def):
    from elasticdl_tpu_torch.client import api
    from elasticdl_tpu_torch.client import main as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli.parse_args(["train", "--distribution_strategy", "Local",
                           "--model_def", model_def,
                           "--training_data", "unused.csv"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.run_local(args, "train")


def test_resolve_device_cpu_only_when_asked():
    assert device_lib.resolve_device("cpu") == torch.device("cpu")
    assert device_lib.resolve_device(torch.device("cpu")).type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        device_lib.resolve_device("meta")


def test_float32_products_are_pinned_to_full_precision():
    device_lib.resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_build_paths_resolve_from_the_package():
    from elasticdl_tpu_torch.ops import _build

    assert _build.CSRC_DIR == \
        __import__("pathlib").Path(PACKAGE) / "csrc"
    assert str(_build.BUILD_DIR).startswith(os.path.join(REPO, "build"))
    assert "flash_attention_fwd.cu" in _build.sources()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

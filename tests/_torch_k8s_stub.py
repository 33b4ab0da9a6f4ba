"""Shared by the port's tests of the default Kubernetes client: no
cluster configuration at all, or the stub API server
(elasticdl_tpu_torch/common/k8s_stub_apiserver.py) with a kubeconfig
that points at it over TLS (the client certificate of
tests/data/k8s_tls/)."""

import contextlib
import os

from elasticdl_tpu_torch.common import k8s_stub_apiserver as stub_lib

TLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "k8s_tls")


def no_cluster(monkeypatch, tmp_path) -> None:
    """KUBECONFIG at a missing path, HOME at an empty directory, no
    in-cluster variables."""
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.delenv("KUBERNETES_SERVICE_PORT", raising=False)
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "no-kubeconfig"))
    home = tmp_path / "empty-home"
    home.mkdir(exist_ok=True)
    monkeypatch.setenv("HOME", str(home))


@contextlib.contextmanager
def stub_cluster(monkeypatch, tmp_path, **kwargs):
    """The stub API server, KUBECONFIG at a JSON kubeconfig for it (the
    one its pods get too)."""
    no_cluster(monkeypatch, tmp_path)
    kubeconfig = str(tmp_path / "kubeconfig.json")
    server = stub_lib.StubApiServer(TLS, pod_kubeconfig=kubeconfig,
                                    **kwargs)
    try:
        stub_lib.write_kubeconfig(kubeconfig, server.url, TLS)
        monkeypatch.setenv("KUBECONFIG", kubeconfig)
        yield server
    finally:
        server.stop()

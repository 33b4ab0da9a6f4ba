"""Recovery after a prewarm, end to end on the CPU (the port's twin of
tests/test_elastic_cluster.py:474 `test_warm_recovery_via_prewarmed_cache`):
two live jobs share one `--compilation_cache_dir`, with the prewarm
forced on (`ELASTICDL_FORCE_PREWARM=1`, as the JAX test forces it past
its starved-host guard).

- Run 1 has no scale event.  Its ranks prewarm the train step for the
  world a failure would leave (a world of one): each logs the prewarm
  line for the 1-rank world, its abstract compile.
- Run 2 scales 2 -> 1 mid-job.  The relaunched rank builds no kernel
  library (its exit line's `kernel_builds` is empty: what its step loads
  is in the cache), and the recovery measured at the master lies within
  the JAX test's 60 s budget.

What shows the prewarm is run 1's lines: without it no rank logs one.
The build count of run 2 is the JAX test's cache-hit check, and holds
with or without the prewarm: on the CPU a step loads no kernel library
(the wrappers' rule), and on the card no world size changes the
libraries a step loads (flash by dtype, head size and alignment, the
scatter-add by device), which run 1's first steps have built into the
shared cache; `chip_smoke.py`'s cluster phases read the same exit lines.
What a relaunched rank cannot inherit is its captured CUDA graph
(worker/graphs.py); a rank of a data-parallel world runs eagerly anyway.
"""

import json

from test_torch_elastic_cluster import (
    JOB_TIMEOUT_S,
    cluster_argv,
    pod_logs,
    start_job,
    wait_for_commit,
)

from elasticdl_tpu_torch.common.k8s_client import ProcessK8sClient
from elasticdl_tpu_torch.model_zoo.mnist.data import write_dataset
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.worker.spmd import KERNEL_LAUNCHES_TAG

import test_torch_elastic_cluster as cluster

RECORDS = 384
# the JAX test's warm-recovery budget
WARM_BUDGET_S = 60.0
PREWARM_LINE = "prewarmed train step for 1-rank world in "


def _k8s():
    """The cluster tests' worker pods, with the prewarm forced on."""
    return ProcessK8sClient(extra_env=dict(
        cluster.process_k8s()._extra_env, ELASTICDL_FORCE_PREWARM="1"))


def _exit_lines(k8s, pods):
    lines = {}
    for name in pods:
        for line in k8s.pod_output(name).splitlines():
            at = line.find(KERNEL_LAUNCHES_TAG)
            if at >= 0:
                lines[name] = json.loads(line[at + len(KERNEL_LAUNCHES_TAG):])
    return lines


def _run(tmp_path, name, train_dir, cache, scale_down):
    ckpt = str(tmp_path / name / "ckpt")
    k8s = _k8s()
    thread, held, result = start_job(
        cluster_argv(train_dir, ckpt, name, minibatch_size=24,
                     extra=("--compilation_cache_dir", cache)), k8s)
    try:
        if scale_down:
            wait_for_commit(ckpt, thread.is_alive)
            held["master"].pod_manager.scale_down(1)
        thread.join(JOB_TIMEOUT_S)
        assert not thread.is_alive(), "the job did not end"
    finally:
        k8s.stop()
    logs = pod_logs(k8s, tail=20000)
    assert result["rc"] == 0, logs
    return k8s, held["master"], logs


def test_warm_recovery_via_prewarmed_cache(tmp_path, monkeypatch):
    # the in-process master applies the flag: this process's view of the
    # library cache starts there, as before anything loaded
    cache = str(tmp_path / "shared_cache")
    monkeypatch.setattr(_build, "_cache_dir", None)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "_HOST_PATHS", {})
    _build.set_cache_dir(cache)
    train_dir, _ = write_dataset(str(tmp_path / "data"), n_train=RECORDS,
                                 n_val=0)

    _, _, logs1 = _run(tmp_path, "warmprime", train_dir, cache,
                       scale_down=False)
    prewarmed = [line for log in logs1.values()
                 for line in log.splitlines() if PREWARM_LINE in line]
    assert len(prewarmed) == 2, logs1      # each rank of the world of two
    assert all(line.endswith("(library cache populated)")
               for line in prewarmed)

    k8s, master, logs2 = _run(tmp_path, "warmdrill", train_dir, cache,
                              scale_down=True)
    history = master.recovery_clock.history
    assert history, "the warm run measured no recovery"
    assert max(history) < WARM_BUDGET_S, history
    relaunched = [s.name for s in k8s.create_calls[2:]
                  if s.pod_type == "worker"]
    assert relaunched, logs2
    exits = _exit_lines(k8s, relaunched)
    assert exits, logs2
    for pod, line in exits.items():
        assert line["kernel_builds"] == {}, (pod, line)
    # a world of one has no smaller world to prewarm
    assert not any(PREWARM_LINE in logs2[p] for p in relaunched)

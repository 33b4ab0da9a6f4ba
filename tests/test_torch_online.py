"""The port's online loop (online/pipeline.py) against the JAX package's.

- chip_smoke.py's chaos driver on the CPU gives bench.py::
  _online_chaos_run's canonical text byte for byte (fault trace, fleet
  and SLO decisions, normalized events, lineage decompositions) and its
  summary, for seeds 17 and 20260805; the traffic-spike driver gives
  _traffic_spike_run's.  Both texts carry the `program_compiled` events
  of their program registries (the replicas' `serving_forward` buckets
  and the trainer's `worker_train_step`), at the same places; the raw
  events agree in program names, order and `signatures`, with
  `signature`, `seconds`, `flops` and `bytes` masked (reasons at
  `_compiles`).
- Three trainers, a faulted shard move, a master restart mid-window and
  a second kill (tests/test_online_pipeline.py:147), and the
  backpressure cadence (:287), each beside the JAX loop.
- A loop from the JAX loop's initial weights (carried with
  `params_from_jax` by patching the port Trainer's `init_state`) ends 8
  windows with parameters and served predictions within PARAM_TOL and
  PRED_TOL of the JAX loop's.
- `OnlinePipeline` runs on CUDA unless told "cpu", and raises without a
  GPU."""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import bench
from elasticdl_tpu.common import events as jax_events
from elasticdl_tpu.common import faults as jax_faults
from elasticdl_tpu.common import metrics as jax_metrics
from elasticdl_tpu.common import programs as jax_programs
from elasticdl_tpu.common.model_handler import get_model_spec as jax_spec
from elasticdl_tpu.online import OnlineConfig as JaxConfig
from elasticdl_tpu.online import OnlinePipeline as JaxPipeline
from elasticdl_tpu.serving.server import (
    make_predict_request as jax_request,
)
from elasticdl_tpu_torch.common import events as port_events
from elasticdl_tpu_torch.common import faults as port_faults
from elasticdl_tpu_torch.common import metrics as port_metrics
from elasticdl_tpu_torch.common import programs as port_programs
from elasticdl_tpu_torch.common import model_handler as port_handler
from elasticdl_tpu_torch.common.weights import (
    flatten_params,
    params_from_jax,
)
from elasticdl_tpu_torch.model_zoo.clickstream import ctr_mlp
from elasticdl_tpu_torch.online import OnlineConfig, OnlinePipeline
from elasticdl_tpu_torch.proto import serving as spb
from elasticdl_tpu_torch.serving.server import (
    from_tensor_proto,
    make_predict_request,
)
from elasticdl_tpu_torch.worker import trainer as port_trainer

torch.set_num_threads(2)

CTR = "clickstream.ctr_mlp.custom_model"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides, 32 Adam steps (lr 1e-2) over the same 16-record
# batches from the same initial weights: XLA and PyTorch sum the matmuls
# in different orders (a few ulp a step), and Adam's update divides by
# sqrt(v) + 1e-8, which can carry a gap on a parameter whose gradient is
# near 0 up to lr-sized steps.  A correct run's gaps on the CPU are
# ~8e-6 (parameters) and ~2e-6 (predictions); the bounds sit an order
# over them and far under a wrong step or batch (~1e-2).
PARAM_TOL = 1e-4
PRED_TOL = 1e-4


@pytest.fixture(autouse=True)
def _clean_globals():
    yield
    for faults, events in ((jax_faults, jax_events),
                           (port_faults, port_events)):
        faults.uninstall()
        events.configure(None)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)     # defines main(); does not run it
    return module


def _compiles(seen) -> list:
    """(program, signatures) of each `program_compiled` event, in order.
    Masked: `signature` hashes each package's own signature (jax avals
    against torch leaves); `seconds` is wall time; `flops` and `bytes`
    are 0 on the reference's dispatch path (XLA's cost model comes only
    from its AOT query) and counted in the port."""
    return [(e["program"], e["signatures"]) for e in seen
            if e["event"] == "program_compiled"]


def _fake_clock(start):
    clk = [start]

    def clock():
        clk[0] += 0.125
        return clk[0]

    return clock


@pytest.mark.parametrize("seed", [17, 20260805])
def test_chaos_replay_equals_the_jax_loops_byte_for_byte(seed, monkeypatch):
    cs = _chip_smoke()
    # a fresh program registry in each package: `signatures` counts the
    # digests a registry has seen, which earlier runs in the process
    # would otherwise add to
    for programs in (jax_programs, port_programs):
        fresh = programs.ProgramRegistry(
            metrics=(jax_metrics if programs is jax_programs
                     else port_metrics).MetricsRegistry())
        monkeypatch.setattr(programs, "default_program_registry",
                            lambda fresh=fresh: fresh)
    seen, jax_seen = [], []
    port_events.add_observer(seen.append)
    try:
        text, summary, _ = cs.online_chaos_run(seed, "cpu")
    finally:
        port_events.remove_observer(seen.append)
    jax_events.add_observer(jax_seen.append)
    try:
        jax_text, jax_summary = bench._online_chaos_run(seed)
    finally:
        jax_events.remove_observer(jax_seen.append)
    assert text == jax_text
    assert _compiles(seen) == _compiles(jax_seen) == [
        ("serving_forward", 1), ("serving_forward", 2),
        ("serving_forward", 2), ("serving_forward", 2),
        ("worker_train_step", 1)]
    assert summary == jax_summary
    cs.check_online_chaos(summary)
    assert summary["windows_lost"] == summary["duplicate_reports"] == 0
    assert summary["lineage_reconcile"]["within_5pct"]
    assert summary["replayed_original_ingest"]


def test_serving_control_loop_equals_the_jax_loop_byte_for_byte():
    cs = _chip_smoke()
    text, summary = cs.traffic_spike_run(20260807, "cpu")
    jax_text, jax_summary = bench._traffic_spike_run(20260807)
    assert text == jax_text
    assert {k: summary[k] for k in jax_summary} == jax_summary
    cs.check_traffic_spike(summary)
    assert summary["first_scale_up_tick"] == 10


def _three_trainers(config, pipeline, faults, spec, root):
    cfg = config(seed=9, window_records=32, records_per_poll=32,
                 records_per_task=8, checkpoint_every_windows=2,
                 replicas=1, workers=3, num_shards=4, store_cache_rows=64)
    kwargs = {"device": "cpu"} if pipeline is OnlinePipeline else {}
    pipe = pipeline(str(root), spec, cfg, clock=_fake_clock(2_000_000.0),
                    **kwargs)
    faults.install(faults.FaultRegistry(schedule=[
        faults.FaultSpec(faults.POINT_STORE_SHARD_HANDOFF, 0, "raise")],
        seed=9))
    try:
        for i in range(6):
            if i == 3:
                pipe.tick(max_train_tasks=1)
                restored = pipe.restart_master()
                continue
            pipe.tick()
            if i == 2:
                killed = pipe.kill_worker(1)
            if i == 4:
                pipe.kill_worker(2)
        pipe.tick()
    finally:
        faults.uninstall()
    snap = pipe.snapshot()
    with pytest.raises(ValueError):
        pipe.kill_worker(0)
    pipe.shutdown()
    return killed, restored, snap


def test_three_trainers_survive_a_kill_and_a_master_restart(tmp_path):
    port_spec = port_handler.get_model_spec(port_handler.ZOO_DIR, CTR)
    killed, restored, snap = _three_trainers(
        OnlineConfig, OnlinePipeline, port_faults, port_spec,
        tmp_path / "port")
    j_killed, j_restored, j_snap = _three_trainers(
        JaxConfig, JaxPipeline, jax_faults, jax_spec("model_zoo", CTR),
        tmp_path / "jax")
    assert (killed, restored) == (j_killed, j_restored)
    for key in ("online", "store", "trainers", "stream",
                "windows_trained", "examples_trained", "model_step",
                "latest_saved_step"):
        assert snap[key] == j_snap[key], key
    # Both packages keep the task counters in the manager's registry,
    # which the replacement master adopts: the counts go on across the
    # restart.  The port's snapshot also has `training_records_done`.
    tasks, j_tasks = dict(snap["tasks"]), dict(j_snap["tasks"])
    tasks.pop("training_records_done")
    assert tasks == j_tasks
    assert tasks["counters"]["finished"] == 28
    assert snap["serving_fleet"]["decisions"] == \
        j_snap["serving_fleet"]["decisions"]
    assert killed["handoffs"] == 0
    assert restored == {"windows_restored": 1, "tasks_rearmed": 3}
    online = snap["online"]
    assert online["windows_lost"] == online["duplicate_reports"] == 0
    assert online["open_windows"] == 0
    assert (online["handoffs"], online["pending_handoffs"]) == (2, 0)
    assert snap["store"]["handoff_faults"] == 1
    assert snap["trainers"] == {"alive": [0], "master_restarts": 1}
    assert set(snap["store"]["shard_owners"].values()) == {0}


def _backpressure(config, pipeline, spec, root):
    cfg = config(seed=11, window_records=64, records_per_poll=64,
                 records_per_task=16, checkpoint_every_windows=4,
                 replicas=1, backpressure_threshold=0.25,
                 backpressure_stride=4)
    kwargs = {"device": "cpu"} if pipeline is OnlinePipeline else {}
    pipe = pipeline(str(root), spec, cfg, clock=_fake_clock(3_000_000.0),
                    **kwargs)
    try:
        ticks = [pipe.tick(max_train_tasks=1)]
        # pressure pinned over the threshold, as a sustained overload
        pipe._serving_pressure = 1.0
        refresh, pipe._refresh_pressure = pipe._refresh_pressure, \
            lambda: None
        ticks += [pipe.tick(max_train_tasks=1) for _ in range(4)]
        held = pipe.snapshot()["backpressure"]
        pipe._refresh_pressure = refresh
        pipe._serving_pressure = 0.0
        ticks.append(pipe.tick(max_train_tasks=1))
        skipped = pipe.snapshot()["backpressure"]["polls_skipped"]
    finally:
        pipe.shutdown()
    for t in ticks:
        t.pop("loss")
    return ticks, held, skipped


def test_backpressure_slows_the_poll_cadence_and_recovers(tmp_path):
    port_spec = port_handler.get_model_spec(port_handler.ZOO_DIR, CTR)
    ticks, held, skipped = _backpressure(OnlineConfig, OnlinePipeline,
                                         port_spec, tmp_path / "port")
    assert (ticks, held, skipped) == _backpressure(
        JaxConfig, JaxPipeline, jax_spec("model_zoo", CTR),
        tmp_path / "jax")
    assert ticks[0]["polled"] > 0 and not ticks[0]["backpressured"]
    assert all(t["backpressured"] and t["polled"] == 0
               for t in ticks[1:4])
    assert sum(t["trained_tasks"] for t in ticks[1:4]) == 3
    assert not ticks[4]["backpressured"]       # the stride tick polls
    assert held == {"serving_pressure": 1.0, "polls_skipped": 3,
                    "threshold": 0.25, "stride": 4}
    assert not ticks[5]["backpressured"] and skipped == 3


def _loop(pipe, encode, request_fn, ticks=8):
    rng = np.random.RandomState(5)
    responses = []
    for _ in range(ticks):
        pipe.tick()
        for _ in range(2):
            x = encode(rng.randint(0, 512, 2), rng.randint(0, 128, 2))
            responses.append(pipe.predict(request_fn(x)))
    return responses


def test_loop_from_jax_weights_matches_the_jax_loop(tmp_path,
                                                    monkeypatch):
    cfg = dict(seed=5, window_records=64, records_per_poll=64,
               records_per_task=16, checkpoint_every_windows=2,
               replicas=2)
    jpipe = JaxPipeline(str(tmp_path / "jax"), jax_spec("model_zoo", CTR),
                        JaxConfig(**cfg), clock=_fake_clock(1_000_000.0))
    init = flatten_params(jax.tree.map(np.asarray,
                                       jpipe.state.params["params"]))
    original = port_trainer.Trainer.init_state

    def carried(self, rng, sample):
        state = original(self, rng, sample)
        state.model.load_state_dict(params_from_jax(state.model, init),
                                    strict=True)
        return state

    monkeypatch.setattr(port_trainer.Trainer, "init_state", carried)
    pipe = OnlinePipeline(
        str(tmp_path / "port"),
        port_handler.get_model_spec(port_handler.ZOO_DIR, CTR),
        OnlineConfig(**cfg), clock=_fake_clock(1_000_000.0), device="cpu")
    try:
        from model_zoo.clickstream import ctr_mlp as jax_ctr

        j_resp = _loop(jpipe, jax_ctr.encode, jax_request)
        p_resp = _loop(pipe, ctr_mlp.encode, make_predict_request)
        snap, j_snap = pipe.snapshot(), jpipe.snapshot()
        trained = flatten_params(jax.tree.map(
            np.asarray, jpipe.state.params["params"]))
        expect = params_from_jax(pipe.state.model, trained)
        gaps = {k: float((pipe.state.model.state_dict()[k] - v).abs().max())
                for k, v in expect.items()}
    finally:
        jpipe.shutdown()
        pipe.shutdown()
    assert snap["windows_trained"] == j_snap["windows_trained"] == 8
    assert snap["model_step"] == j_snap["model_step"] == 32
    assert max(gaps.values()) < PARAM_TOL, gaps
    assert [r.code for r in p_resp] == [spb.SERVING_OK] * 16
    assert [r.model_step for r in p_resp] == \
        [r.model_step for r in j_resp]
    assert max(r.model_step for r in p_resp) > 0
    from elasticdl_tpu.serving.server import (
        from_tensor_proto as jax_from_proto,
    )
    pred_gap = max(
        float(np.max(np.abs(from_tensor_proto(p.predictions)
                            - jax_from_proto(j.predictions))))
        for p, j in zip(p_resp, j_resp))
    assert pred_gap < PRED_TOL


def test_the_pipeline_needs_cuda_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = port_handler.get_model_spec(port_handler.ZOO_DIR, CTR)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlinePipeline(str(tmp_path / "a"), spec, OnlineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OnlinePipeline(str(tmp_path / "b"), spec, OnlineConfig(),
                       device="cuda")
    assert not os.listdir(tmp_path / "a") if (tmp_path / "a").exists() \
        else True


def test_shutdown_untaps_the_lineage_and_clears_the_fault_registry(
        tmp_path):
    """Several loops share a process: a finished one leaves no observer
    behind, so the next run's events are its own."""
    spec = port_handler.get_model_spec(port_handler.ZOO_DIR, CTR)
    before = len(port_events._observers)
    pipe = OnlinePipeline(str(tmp_path), spec, OnlineConfig(replicas=1),
                          clock=_fake_clock(0.0), device="cpu")
    assert len(port_events._observers) == before + 1
    pipe.tick()
    pipe.shutdown()
    assert len(port_events._observers) == before

"""The port's train-to-serve freshness tracker (master/freshness.py)
against the JAX package's, under one fake clock: the staleness each
response records, the histograms, quantiles, snapshots and first-serve
callbacks match exactly.  Then the tracker on the port's own path, on
the CPU: a CheckpointSaver's `produced` stamp read back through
`save_utils.read_produced_meta`, a ServingEngine + CheckpointReloader
serving the steps, and the staleness_p99 SLO over a MetricHistory of
the tracker's registry going `ok` while reloads keep up and `breach`
when a reload is held past the objective."""

from types import SimpleNamespace

import numpy as np
import torch

from elasticdl_tpu.master import freshness as jax_freshness
from elasticdl_tpu_torch.common import save_utils
from elasticdl_tpu_torch.common.flight import FlightRecorder, list_bundles
from elasticdl_tpu_torch.common.history import MetricHistory
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.slo import SloEvaluator, shipped_specs
from elasticdl_tpu_torch.master import freshness as port_freshness
from elasticdl_tpu_torch.model_zoo.clickstream import ctr_mlp
from elasticdl_tpu_torch.serving.engine import ServingEngine
from elasticdl_tpu_torch.serving.reloader import CheckpointReloader
from elasticdl_tpu_torch.worker.trainer import Trainer

torch.set_num_threads(2)


class FakeClock:
    def __init__(self, start=2_000.0):
        self.now = start

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


# (advance s, produced step or None, served step) per event
SCRIPT = ((1.0, 4, 0), (0.5, None, 4), (2.0, 8, 4), (0.25, None, 4),
          (3.0, None, 8), (1.0, 12, 8), (40.0, None, 8), (0.5, 16, 12),
          (0.0, None, 16), (5.0, 20, 16), (200.0, None, 16),
          (0.1, None, 20), (0.0, 3, 20))


def _drive(mod, produced_time_fn=None):
    clock = FakeClock()
    first = []
    tracker = mod.FreshnessTracker(
        clock=clock, produced_time_fn=produced_time_fn,
        on_first_serve=lambda step, at: first.append((step, at)))
    out = []
    for dt, produced, served in SCRIPT:
        clock.advance(dt)
        if produced is not None:
            out.append(("produced", tracker.note_produced(produced)))
        out.append(("latest", tracker.latest()))
        out.append(("observed", tracker.observe_response(served)))
    out.append(("explicit", tracker.note_produced(30, 1.5),
                tracker.latest()))
    return {"trace": out, "first": first,
            "quantiles": tracker.quantiles(),
            "snapshot": tracker.snapshot(),
            "metrics": tracker.metrics_registry.snapshot()}


def test_tracker_matches_the_jax_tracker():
    assert _drive(port_freshness) == _drive(jax_freshness)
    stamps = {8: 1_990.0, 16: None}
    produced_time_fn = stamps.get
    want = _drive(jax_freshness, produced_time_fn)
    assert _drive(port_freshness, produced_time_fn) == want
    assert want["snapshot"]["latest_step"] == 30
    assert want["snapshot"]["observations"] == len(SCRIPT)
    assert [s for s, _ in want["first"]] == [0, 4, 8, 12, 16, 20]


def test_a_first_serve_hook_that_raises_never_fails_the_response():
    def broken(step, at):
        raise RuntimeError("a lineage hook that fails")

    tracker = port_freshness.FreshnessTracker(clock=FakeClock(),
                                              on_first_serve=broken)
    tracker.note_produced(2)
    assert tracker.observe_response(2) == (0, 0.0)


def _ctr_batch(rng):
    records = [{"user": int(u), "item": int(i), "clicked": int(c)}
               for u, i, c in zip(rng.integers(0, 512, 32),
                                  rng.integers(0, 128, 32),
                                  rng.integers(0, 2, 32))]
    return ctr_mlp.feed(records)


def test_staleness_slo_over_served_checkpoints_on_the_cpu(tmp_path):
    clock = FakeClock(10_000.0)
    spec = get_model_spec(ZOO_DIR, "clickstream.ctr_mlp.custom_model")
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, device="cpu")
    rng = np.random.default_rng(0)
    batch = _ctr_batch(rng)
    state = trainer.init_state(0, batch["features"])
    ckpt = str(tmp_path / "ckpt")
    saver = save_utils.CheckpointSaver(ckpt, keep_max=3, clock=clock)
    tracker = port_freshness.FreshnessTracker(
        clock=clock,
        produced_time_fn=lambda s: (save_utils.read_produced_meta(ckpt, s)
                                    or {}).get("produced_unix_s"))
    history = MetricHistory(registries=[tracker.metrics_registry],
                            clock=clock)
    recorder = FlightRecorder(incident_dir=str(tmp_path / "incidents"),
                              history=history).install()
    args = SimpleNamespace(slo_staleness_p99_s=20.0)
    evaluator = SloEvaluator(history, specs=shipped_specs(args),
                             clock=clock, on_breach=recorder.breach)

    def produce():
        nonlocal state
        state, _ = trainer.train_on_batch(state, batch)
        assert saver.save(state)
        saver.wait_until_finished()
        assert tracker.note_produced(state.step)
        assert save_utils.read_produced_meta(ckpt, state.step) == {
            "model_step": state.step, "produced_unix_s": clock.now}
        assert tracker.latest() == (state.step, clock.now)

    features = {"features": batch["features"][:4]}
    reloader = None
    try:
        produce()
        engine = ServingEngine.from_checkpoint(ckpt, spec,
                                               batch["features"],
                                               buckets=(4,), device="cpu")
        reloader = CheckpointReloader(engine, ckpt)
        states = []
        for mode in ["keep_up"] * 4 + ["hold"] * 10:
            clock.advance(5.0)
            if mode == "keep_up" or states[-1][0] == "keep_up":
                produce()
            if mode == "keep_up":
                assert reloader.check_once()
            for _ in range(3):
                _, step = engine.predict(features, 4)
                tracker.observe_response(step)
            history.tick()
            evaluator.tick()
            states.append((mode, evaluator.state("staleness_p99")))
    finally:
        recorder.close()
        saver.close()
        if reloader is not None:
            reloader.stop()
    assert {s for m, s in states if m == "keep_up"} == {"ok"}
    assert states[-1] == ("hold", "breach")
    (bundle,) = list_bundles(str(tmp_path / "incidents"))
    assert bundle["trigger"] == "slo_breach"
    assert bundle["evidence"]["slo"] == "staleness_p99"
    assert tracker.snapshot()["latest_step"] == 6
    assert tracker.quantiles()["staleness_p99_steps"] >= 1.0

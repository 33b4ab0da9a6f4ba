"""The registered programs that are not train steps, as graphs
(worker/graphs.py): the serving forward per bucket, the eval forward and
the tiered store seam's admit and gather, on the CPU through the
stand-in backend of tests/test_torch_compile.py (its capture runs
nothing; each replay runs the captured body and writes into one static
output, which the next replay rewrites, as a real graph's does).

- Parity with the JAX package, at the tolerances the eager tests state:
  every bucket of the graphed ServingEngine against the JAX engine
  (tests/test_torch_serving.py), `predict_on_batch` through the eval
  graph against the JAX trainer's eval step (tests/test_torch_deepfm.py's
  f32 tolerance), and the admit and gather graphs against the JAX seam
  (tests/test_torch_store.py), fp32 and int8, with duplicate padded
  indices; each graph also bit for bit against the port's eager seam.
- The dispatch rules: a swap copies into the static generation in place
  and captures nothing; a response never carries one step with another
  step's predictions; the storm drill's counts are those of the eager
  engine; an eval snapshot captures its own graph; an admit graph made
  before the moments exist is captured again once they do; a sharded
  cache stays eager; a failed capture raises; captures are serialized
  across threads, and a launch on another thread during a capture is
  counted, not taken back; a capture records no second compile.
"""

import gc
import threading
import time
import weakref

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.serving import engine as jax_engine_lib
from elasticdl_tpu.store import device as jax_device
from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common import programs
from elasticdl_tpu_torch.common.export import feature_meta
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.common.weights import flatten_params, params_from_jax
from elasticdl_tpu_torch.model_zoo.bert import bert_finetune as port_bert
from elasticdl_tpu_torch.ops import launches as ops_launches
from elasticdl_tpu_torch.ops import scatter_add as sa
from elasticdl_tpu_torch.serving import engine as port_engine_lib
from elasticdl_tpu_torch.serving.batcher import OK, DynamicBatcher
from elasticdl_tpu_torch.store import device as port_device
from elasticdl_tpu_torch.store.serving import TieredServingEngine
from elasticdl_tpu_torch.worker import graphs as graphs_lib
from elasticdl_tpu_torch.worker import trainer as port_trainer
from elasticdl_tpu_torch.worker.sync import snapshot_state
from elasticdl_tpu_torch.worker.trainer import TrainState
from model_zoo.bert import bert_finetune as jax_bert
from test_torch_compile import StandInBackend
from test_torch_store import (
    CACHE_ROWS,
    JAX_PATHS,
    PLANES,
    PORT_PATHS,
    _assert_reads_match,
    _assert_tables_match,
    _Cache,
    _states,
)
from test_torch_trainer import _batches, _carried_states, _trainers

torch.set_num_threads(2)

# tests/test_torch_serving.py's BERT and tolerance (f32, both packages on
# their plain attention)
CFG = dict(hidden=64, num_layers=2, heads=4, mlp_dim=128, max_len=128,
           vocab_size=512)
BUCKETS = (1, 4, 8)
SERVE_TOL = 1e-4
# tests/test_torch_deepfm.py: f32 DeepFM predictions across the packages
F32_TOL = 1e-5
MNIST = "mnist.mnist_functional_api.custom_model"
MNIST_SPEC = {"features": {"shape": [784], "dtype": "float32"}}


def _requests(rows, seed):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, CFG["vocab_size"],
                                     (rows, CFG["max_len"])).astype(np.int32)}


def _graphed_engine(monkeypatch, engine, backend):
    """`engine` on the graph path (outside `eager_loop`) through
    `backend`."""
    engine._graphs.backend = backend
    monkeypatch.setattr(engine, "graph_ok",
                        lambda: not graphs_lib.in_eager_loop())
    return engine


@pytest.fixture(scope="module")
def bert_pair():
    """The JAX engine and the port's weights carried from its init."""
    jax_model = jax_bert.custom_model(**CFG)
    sample = _requests(8, 0)
    variables = jax_model.init(jax.random.PRNGKey(0), sample)
    feature_spec = feature_meta({"input_ids": sample["input_ids"][:1]})
    jax_engine = jax_engine_lib.ServingEngine(
        jax_model, variables, step=5, feature_spec=feature_spec,
        buckets=BUCKETS)
    params = params_from_jax(
        port_bert.custom_model(**CFG), flatten_params(jax.tree.map(
            np.asarray, variables["params"])))
    return jax_engine, params, feature_spec


def _bert_engine(monkeypatch, bert_pair, backend, **kwargs):
    _, params, feature_spec = bert_pair
    engine = port_engine_lib.ServingEngine(
        port_bert.custom_model(**CFG), params, step=5,
        feature_spec=feature_spec, buckets=BUCKETS, device="cpu",
        precompile=False, **kwargs)
    return _graphed_engine(monkeypatch, engine, backend)


# ---- serving ---------------------------------------------------------------


def test_every_bucket_replays_its_graph_and_matches_the_jax_engine(
        monkeypatch, bert_pair):
    """Warm-up runs each bucket once eagerly and captures it; every
    request then replays its bucket's graph.  The responses, read after
    later replays rewrote the static outputs, are the JAX engine's."""
    jax_engine = bert_pair[0]
    backend = StandInBackend()
    engine = _bert_engine(monkeypatch, bert_pair, backend)
    engine.warmup()
    assert backend.side == backend.captures == len(BUCKETS)
    assert backend.replays == 0
    assert engine.compile_count == len(BUCKETS)
    got = []
    for rows in (1, 2, 3, 5, 8, 4, 1):
        x = _requests(rows, seed=100 + rows)
        got.append((x, rows, engine.predict(x, rows)))
    assert backend.replays == 7 and backend.captures == len(BUCKETS)
    assert engine.compile_count == len(BUCKETS)
    for x, rows, (preds, step) in got:
        want, jax_step = jax_engine.predict(x, rows)
        assert step == jax_step == 5 and preds.shape == (rows, 2)
        np.testing.assert_allclose(preds, np.asarray(want), rtol=SERVE_TOL,
                                   atol=SERVE_TOL)
    # the graphs replay the eager forward bit for bit
    with graphs_lib.eager_loop():
        for x, rows, (preds, _) in got:
            np.testing.assert_array_equal(engine.predict(x, rows)[0], preds)
    assert backend.replays == 7


def test_the_batcher_replays_what_warmup_captured(monkeypatch, bert_pair):
    """The dispatch thread makes no eager call and captures nothing: it
    only replays the warming thread's graphs."""
    backend = StandInBackend()
    engine = _bert_engine(monkeypatch, bert_pair, backend)
    engine.warmup()
    batcher = DynamicBatcher(engine, max_latency_s=0.002)
    try:
        futures = [batcher.submit(_requests(rows, seed=rows))
                   for rows in (1, 3, 8, 2)]
        results = [f.result(timeout=60) for f in futures]
    finally:
        batcher.shutdown()
    assert all(r.code == OK for r in results)
    assert backend.side == backend.captures == len(BUCKETS)
    assert backend.replays >= 1


def test_a_swap_copies_in_place_and_captures_nothing(monkeypatch,
                                                     bert_pair):
    backend = StandInBackend()
    engine = _bert_engine(monkeypatch, bert_pair, backend)
    engine.warmup()
    x = _requests(4, seed=7)
    before, _ = engine.predict(x, 4)
    tensors = {k: v for k, v in engine.variables.items()}
    ptrs = {k: v.data_ptr() for k, v in tensors.items()}
    doubled = {k: v * 2 for k, v in engine.variables.items()}
    engine.swap(doubled, step=12, produced_unix_s=3.0)
    assert engine.step == 12 and engine.swap_count == 1
    assert all(engine.variables[k] is tensors[k] for k in tensors)
    assert {k: v.data_ptr() for k, v in engine.variables.items()} == ptrs
    for k, v in doubled.items():
        assert torch.equal(engine.variables[k], v), k
    after, step = engine.predict(x, 4)
    assert step == 12 and not np.allclose(before, after)
    assert backend.captures == len(BUCKETS)
    # the new generation's eager forward, bit for bit
    ref = port_engine_lib.ServingEngine(
        port_bert.custom_model(**CFG), doubled, step=12,
        feature_spec=bert_pair[2], buckets=BUCKETS, device="cpu",
        precompile=False)
    np.testing.assert_array_equal(ref.predict(x, 4)[0], after)
    # the caller's tensors are the engine's copies, not its own
    assert not any(t is doubled[k] for k, t in engine.variables.items())


def test_a_response_never_carries_another_steps_predictions(monkeypatch,
                                                            bert_pair):
    """A swap that starts while a batch replays waits for the batch's
    result to be copied out: the batch is labelled with the step whose
    weights computed it, and the next batch runs on the new step."""
    backend = StandInBackend()
    engine = _bert_engine(monkeypatch, bert_pair, backend)
    engine.warmup()
    old = {k: v.clone() for k, v in engine.variables.items()}
    new = {k: v * 1.5 for k, v in old.items()}
    swapper = []
    replay_body = backend.capture

    def capture(body):
        replay = replay_body(body)

        def racing_replay():
            if not swapper:
                swapper.append(threading.Thread(
                    target=engine.swap, args=(new, 6)))
                swapper[0].start()
                # the swap would land inside this batch without the lock
                time.sleep(0.2)
            return replay()

        return racing_replay

    backend.capture = capture
    engine._graphs.backend = backend
    engine.graphs.clear()
    x = _requests(4, seed=3)
    engine.predict(x, 4)                 # eager (a fresh key)
    preds, step = engine.predict(x, 4)   # capture, replay, swap starts
    swapper[0].join(timeout=30)
    assert step == 5 and engine.step == 6
    refs = {s: port_engine_lib.ServingEngine(
        port_bert.custom_model(**CFG), v, step=s,
        feature_spec=bert_pair[2], buckets=BUCKETS, device="cpu",
        precompile=False) for s, v in ((5, old), (6, new))}
    np.testing.assert_array_equal(preds, refs[5].predict(x, 4)[0])
    preds, step = engine.predict(x, 4)
    assert step == 6
    np.testing.assert_array_equal(preds, refs[6].predict(x, 4)[0])


def test_threads_see_one_generation_per_response(monkeypatch, bert_pair):
    """Requests from two threads while generations alternate: every
    response equals the eager forward of the generation its step
    names."""
    backend = StandInBackend()
    engine = _bert_engine(monkeypatch, bert_pair, backend)
    engine.warmup()
    gens = {5: {k: v.clone() for k, v in engine.variables.items()}}
    gens[6] = {k: v * 0.5 for k, v in gens[5].items()}
    results, errors = [], []
    stop = threading.Event()

    def client(seed):
        rng = np.random.RandomState(seed)
        try:
            while not stop.is_set():
                rows = int(rng.choice([1, 3, 4]))
                x = _requests(rows, seed=int(rng.randint(1 << 20)))
                results.append((x, rows) + engine.predict(x, rows))
        except Exception as exc:     # asserted empty below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    try:
        for i in range(6):
            step = 6 if i % 2 == 0 else 5
            engine.swap(gens[step], step)
            time.sleep(0.02)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors, errors[0]
    assert {s for *_, s in results} == {5, 6}
    refs = {s: port_engine_lib.ServingEngine(
        port_bert.custom_model(**CFG), v, step=s,
        feature_spec=bert_pair[2], buckets=BUCKETS, device="cpu",
        precompile=False) for s, v in gens.items()}
    for x, rows, preds, step in results:
        np.testing.assert_array_equal(preds, refs[step].predict(x, rows)[0])
    assert backend.captures == len(BUCKETS)


def test_a_failed_capture_raises_out_of_warmup(monkeypatch, bert_pair):
    engine = _bert_engine(monkeypatch, bert_pair,
                          StandInBackend(fail=True))
    with pytest.raises(RuntimeError, match="capture failed"):
        engine.warmup()
    # nothing went eager in its place: the next call raises as well
    x = _requests(1, seed=1)
    with pytest.raises(RuntimeError, match="capture failed"):
        engine.predict(x, 1)


@pytest.fixture(scope="module")
def mnist():
    spec = get_model_spec(ZOO_DIR, MNIST)
    x = np.random.RandomState(0).rand(2, 784).astype(np.float32)
    state = port_trainer.Trainer(spec.model, spec.optimizer, spec.loss,
                                 device="cpu").init_state(0, x)
    return spec, dict(state.model.state_dict())


def _mnist_engine(monkeypatch, mnist, registry, backend=None, **kwargs):
    spec, variables = mnist
    monkeypatch.setattr(programs, "default_program_registry",
                        lambda: registry)
    engine = port_engine_lib.ServingEngine(
        spec.model, dict(variables), step=7, feature_spec=MNIST_SPEC,
        buckets=(2, 8), device="cpu", precompile=False, **kwargs)
    if backend is not None:
        _graphed_engine(monkeypatch, engine, backend)
    engine.warmup()
    return engine


def test_a_capture_records_no_second_compile(monkeypatch, mnist):
    """The registry counts each bucket's eager first call; the warm-up's
    captures and the replays that follow record nothing more."""
    registry = programs.ProgramRegistry(
        metrics=metrics_lib.MetricsRegistry())
    backend = StandInBackend()
    engine = _mnist_engine(monkeypatch, mnist, registry, backend)
    x = np.random.RandomState(1).rand(8, 784).astype(np.float32)
    for rows in (1, 2, 3, 5, 8):
        engine.predict({"features": x[:rows]}, rows)
    rec = registry.ledger()["serving_forward"]
    assert rec["compiles"] == rec["signatures"] == 2
    assert rec["storms"] == 0 and rec["flops_per_execution"] > 0
    assert backend.captures == 2 and backend.replays == 5


def test_the_storm_drills_counts_are_the_eager_engines(monkeypatch, mnist):
    """Without padding each request size is a shape of its own: its
    first call runs eagerly, so the drill's four sizes capture nothing,
    and the compiles, signatures and storm are the eager engine's."""
    x = np.random.RandomState(1).rand(8, 784).astype(np.float32)
    counts = {}
    for mode in ("eager", "graph"):
        registry = programs.ProgramRegistry(
            metrics=metrics_lib.MetricsRegistry())
        backend = StandInBackend() if mode == "graph" else None
        engine = _mnist_engine(monkeypatch, mnist, registry, backend,
                               pad_to_bucket=False)
        preds = [engine.predict({"features": x[:rows]}, rows)[0]
                 for rows in (1, 3, 5, 7)]
        rec = registry.ledger()["serving_forward"]
        counts[mode] = (engine.compile_count, rec["compiles"],
                        rec["signatures"], rec["storms"], preds)
        if backend is not None:
            assert backend.captures == 0 and backend.replays == 0
    assert counts["eager"][:4] == counts["graph"][:4] == (6, 6, 6, 1)
    for a, b in zip(counts["eager"][4], counts["graph"][4]):
        np.testing.assert_array_equal(a, b)


def test_a_tiered_swap_adopts_the_sidecar_and_the_static_weights(
        monkeypatch, tmp_path):
    """TieredServingEngine over a graphed engine: its translation and
    overlays feed the bucket's graph, and a tiered swap (sidecar and
    variables, one generation) copies into the static weights with no
    capture; each response equals the eager forward of its step."""
    from elasticdl_tpu_torch.store import checkpoint as port_ckpt
    from test_torch_tiered import (
        BATCHES,
        FEATURE_SPEC,
        NUM_FIELDS,
        _driven_pair,
        _serving_model,
    )
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_tiered

    _, _, store, state = _driven_pair()
    ckpt = str(tmp_path / "serve")
    for step in (1, 2):
        port_ckpt.save_sidecar(ckpt, step, store, state)
    model = _serving_model()
    backend = StandInBackend()
    engine = _graphed_engine(monkeypatch, port_engine_lib.ServingEngine(
        model, model.state_dict(), step=1, feature_spec=FEATURE_SPEC,
        buckets=(4,), device="cpu", precompile=False), backend)
    engine.warmup()
    tiered = TieredServingEngine(engine, ckpt, 1,
                                 deepfm_tiered.OVERLAY_FEATURES)
    unknown = np.full((1, NUM_FIELDS), 10 ** 9, np.int64)
    sparse = np.concatenate([BATCHES[0][:2], BATCHES[1][:1], unknown])
    feats = {"dense": np.random.RandomState(0).rand(4, 13).astype(
        np.float32), "sparse": sparse}

    def both():
        got = tiered.predict(feats, 4)
        with graphs_lib.eager_loop():
            want = tiered.predict(feats, 4)
        return got, want

    (got, step), (want, _) = both()
    assert step == 1
    np.testing.assert_array_equal(got, want)
    new = {k: v * 0.75 if v.is_floating_point() else v
           for k, v in model.state_dict().items()}
    ptrs = [t.data_ptr() for t in engine.variables.values()]
    tiered.swap(new, 2)
    (got2, step2), (want2, _) = both()
    assert step2 == 2 and tiered.step == 2
    np.testing.assert_array_equal(got2, want2)
    assert not np.array_equal(got, got2)
    assert [t.data_ptr() for t in engine.variables.values()] == ptrs
    assert backend.captures == 1


# ---- the eval forward ------------------------------------------------------


def _graphed_trainer(monkeypatch, trainer, backend):
    trainer._graphs.backend = backend
    monkeypatch.setattr(trainer, "eval_graph_ok",
                        lambda state, features:
                        not graphs_lib.in_eager_loop())
    return trainer


def test_predict_on_batch_through_the_eval_graph_matches_jax(monkeypatch):
    batches = _batches(4, seed=9)
    jt, pt = _trainers()
    backend = StandInBackend()
    _graphed_trainer(monkeypatch, pt, backend)
    jstate, pstate = _carried_states(jt, pt, batches[0]["features"])
    got = [pt.predict_on_batch(pstate, b["features"]) for b in batches]
    # eager, capture + replay, replay, replay
    assert backend.side == 1 and backend.captures == 1
    assert backend.replays == 3
    for b, preds in zip(batches, got):
        want = np.asarray(jt.predict_on_batch(jstate, b["features"]))
        assert preds.dtype == np.float32 and preds.shape == want.shape
        np.testing.assert_allclose(preds, want, rtol=F32_TOL, atol=F32_TOL)
        with graphs_lib.eager_loop():
            np.testing.assert_array_equal(
                pt.predict_on_batch(pstate, b["features"]), preds)
    assert set(pstate.graphs) == {("eval", graphs_lib.batch_shapes(
        port_trainer._to_device(batches[0]["features"],
                                torch.device("cpu"))))}


def test_an_eval_snapshot_captures_its_own_graph(monkeypatch):
    batches = _batches(3, seed=4)
    _, pt = _trainers()
    backend = StandInBackend()
    _graphed_trainer(monkeypatch, pt, backend)
    state = pt.init_state(0, batches[0]["features"])
    for b in batches[:2]:
        pt.predict_on_batch(state, b["features"])
    assert backend.captures == 1
    snap = snapshot_state(state)
    pt.train_on_batch(state, batches[0])          # the live state moves on
    got = [pt.predict_on_batch(snap, b["features"]) for b in batches]
    assert backend.captures == 2 and len(snap.graphs) == 1
    (key,) = snap.graphs
    assert state.graphs[key].captured is not snap.graphs[key].captured
    with graphs_lib.eager_loop():
        for b, preds in zip(batches, got):
            np.testing.assert_array_equal(
                pt.predict_on_batch(snap, b["features"]), preds)
    # the live state's graph reads its own (trained) weights
    live = pt.predict_on_batch(state, batches[0]["features"])
    assert not np.array_equal(live, got[0])
    # the snapshot's graph goes with it
    gone = weakref.ref(snap.graphs[key].captured)
    del snap
    gc.collect()
    assert gone() is None
    assert state.graphs[key].captured is not None


def test_a_batchnorm_model_evaluates_in_eval_mode_as_a_graph(monkeypatch):
    """ResNet's eval graph runs its BatchNorms on their running
    statistics (train=False): the predictions are the eager ones, and
    the running statistics stay as they were."""
    spec = get_model_spec(ZOO_DIR, "cifar10.resnet.custom_model",
                          model_params="stage_sizes=(1, 1)")
    trainer = port_trainer.Trainer(spec.model, spec.optimizer, spec.loss,
                                   device="cpu")
    backend = StandInBackend()
    _graphed_trainer(monkeypatch, trainer, backend)
    rng = np.random.RandomState(0)
    xs = [rng.rand(4, 32, 32, 3).astype(np.float32) for _ in range(3)]
    state = trainer.init_state(0, xs[0])
    stats = {k: v.clone() for k, v in state.model.state_dict().items()
             if "running" in k}
    got = [trainer.predict_on_batch(state, x) for x in xs]
    assert backend.captures == 1 and backend.replays == 2
    for k, v in stats.items():
        assert torch.equal(state.model.state_dict()[k], v), k
    with graphs_lib.eager_loop():
        for x, preds in zip(xs, got):
            np.testing.assert_array_equal(
                trainer.predict_on_batch(state, x), preds)


def test_eval_graph_ok_names_where_eval_graphs_run(monkeypatch):
    from elasticdl_tpu_torch.parallel.mesh import ProcessMesh

    _, pt = _trainers()
    batch = port_trainer._to_device(_batches(1)[0], torch.device("cpu"))
    state = pt.init_state(0, batch["features"])
    assert not pt.eval_graph_ok(state, batch["features"])     # the CPU
    pt.device = torch.device("cuda")
    # a CUDA trainer over CPU tensors, a sharded state, or graphs off
    assert not pt.eval_graph_ok(state, batch["features"])
    state.mesh = ProcessMesh(world_size=2)
    assert not pt.eval_graph_ok(state, batch["features"])
    with graphs_lib.eager_loop():
        assert not pt.eval_graph_ok(state, batch["features"])


def test_a_failed_eval_capture_raises(monkeypatch):
    batches = _batches(2)
    _, pt = _trainers()
    _graphed_trainer(monkeypatch, pt, StandInBackend(fail=True))
    state = pt.init_state(0, batches[0]["features"])
    pt.predict_on_batch(state, batches[0]["features"])        # eager
    with pytest.raises(RuntimeError, match="capture failed"):
        pt.predict_on_batch(state, batches[1]["features"])


# ---- the store seam --------------------------------------------------------


@pytest.fixture
def graphed_seam(monkeypatch):
    """The seam on the graph path through a stand-in backend."""
    backend = StandInBackend()
    runner = graphs_lib.ProgramGraphs(torch.device("cpu"), backend=backend)
    monkeypatch.setattr(port_device, "graph_ok",
                        lambda state, shard=None: shard is None and
                        not graphs_lib.in_eager_loop())
    monkeypatch.setattr(port_device, "_graphs",
                        lambda device, program: runner)
    return backend


def _seam_rounds(cache_dtype, seed=3):
    """Rounds of (slots, values) of distinct slots, each padded to the
    64-row bucket with duplicates of its first slot."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (5, 9, 3, 17, 6):
        slots = rng.choice(CACHE_ROWS, size=n, replace=False).astype(
            np.int32)
        values = {name: (rng.standard_normal((slots.size, dim)) * 2)
                  .astype(np.float32) for name, dim in PLANES.items()}
        out.append((slots, values))
    return out


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_admit_and_gather_graphs_match_the_eager_seam_and_jax(
        graphed_seam, cache_dtype):
    jstate, graphed = _states(cache_dtype)
    _, eager = _states(cache_dtype)
    for slots, values in _seam_rounds(cache_dtype):
        jstate = jax_device.apply_admissions(
            jstate, JAX_PATHS, slots, values, cache_dtype=cache_dtype)
        port_device.apply_admissions(graphed, PORT_PATHS, slots, values,
                                     cache_dtype=cache_dtype)
        with graphs_lib.eager_loop():
            port_device.apply_admissions(eager, PORT_PATHS, slots, values,
                                         cache_dtype=cache_dtype)
        for a, b in zip(graphed.model.state_dict().values(),
                        eager.model.state_dict().values()):
            assert torch.equal(a, b)
        for p, q in zip(graphed.model.parameters(),
                        eager.model.parameters()):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(graphed.optimizer.state[p][key],
                                   eager.optimizer.state[q][key])
        _assert_tables_match(graphed, jstate, cache_dtype)
        probe = slots[::-1]
        got = port_device.read_rows(graphed, PORT_PATHS, probe,
                                    cache_dtype=cache_dtype)
        with graphs_lib.eager_loop():
            want = port_device.read_rows(eager, PORT_PATHS, probe,
                                         cache_dtype=cache_dtype)
        for name in PLANES:
            np.testing.assert_array_equal(got[name], want[name])
        _assert_reads_match(got, jax_device.read_rows(
            jstate, JAX_PATHS, probe, cache_dtype=cache_dtype), cache_dtype)
    # (admit, gather) at one bucket: the first call of each eager, then
    # one capture each and replays
    assert graphed_seam.side == 2 and graphed_seam.captures == 2
    assert graphed_seam.replays == 2 * 5 - 2


def test_a_read_is_its_own_after_the_next_replay(graphed_seam):
    """Two reads of one bucket: the first's rows stay its own when the
    second replay rewrites the static rows."""
    _, state = _states("float32")
    reads = [port_device.read_rows(state, PORT_PATHS, np.array(s, np.int32))
             for s in ([1, 2], [3, 4], [5, 6], [7, 8])]
    table = state.model.fm_embedding.embedding.detach().numpy()
    for s, got in zip(([1, 2], [3, 4], [5, 6], [7, 8]), reads):
        np.testing.assert_array_equal(got["fm_embedding"], table[s])
    assert graphed_seam.captures == 1 and graphed_seam.replays == 3


def test_an_admit_graph_is_captured_again_once_moments_exist(graphed_seam):
    """A state whose optimizer has not stepped has no moments to zero:
    its admit graph is another one than the graph with moments, and the
    state's fingerprint tells them apart."""
    model = _Cache()
    state = TrainState(step=0, model=model,
                       optimizer=torch.optim.Adam(model.parameters()))
    values = {name: np.ones((2, dim), np.float32)
              for name, dim in PLANES.items()}
    for slots in ([1, 2], [3, 4]):
        port_device.apply_admissions(state, PORT_PATHS,
                                     np.array(slots, np.int32), values)
    assert graphed_seam.captures == 1 and not state.optimizer.state
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    port_device.apply_admissions(state, PORT_PATHS,
                                 np.array([5, 6], np.int32), values)
    assert graphed_seam.captures == 2
    for name in PLANES:
        arena = getattr(model, name)
        moments = state.optimizer.state[arena.embedding]
        assert not moments["exp_avg"][[5, 6]].any()
        assert moments["exp_avg"][[1, 2]].all()


def test_a_sharded_cache_stays_eager(monkeypatch):
    """The seam's predicate: whole tables on CUDA run as graphs; a row
    block over `model` (`shard`), the eager loop, or the CPU do not."""
    _, state = _states("float32")
    assert not port_device.graph_ok(state, None)              # the CPU
    monkeypatch.setattr(port_device, "_device",
                        lambda state: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    assert port_device.graph_ok(state, None)
    assert not port_device.graph_ok(state, (object(), 0, 16))
    with graphs_lib.eager_loop():
        assert not port_device.graph_ok(state, None)


def test_a_failed_store_capture_raises(monkeypatch):
    backend = StandInBackend(fail=True)
    runner = graphs_lib.ProgramGraphs(torch.device("cpu"), backend=backend)
    monkeypatch.setattr(port_device, "graph_ok",
                        lambda state, shard=None: True)
    monkeypatch.setattr(port_device, "_graphs",
                        lambda device, program: runner)
    _, state = _states("float32")
    values = {name: np.ones((2, dim), np.float32)
              for name, dim in PLANES.items()}
    slots = np.array([1, 2], np.int32)
    port_device.apply_admissions(state, PORT_PATHS, slots, values)
    with pytest.raises(RuntimeError, match="capture failed"):
        port_device.apply_admissions(state, PORT_PATHS, slots, values)


# ---- captures across threads -----------------------------------------------


class _Owner:
    def __init__(self):
        self.graphs = {}


def test_captures_are_serialized_across_threads():
    """Two threads capturing at once take turns (one capture stream and
    one launch tally in a process); their replays then run freely."""
    active, peak = [0], [0]
    lock = threading.Lock()

    class Slow(StandInBackend):
        def capture(self, body):
            with lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            time.sleep(0.05)
            try:
                return super().capture(body)
            finally:
                with lock:
                    active[0] -= 1

    # a runner (a pool) each, as two engines or a trainer beside an
    # engine have: only the process's capture lock is shared
    runners = [graphs_lib.ProgramGraphs(
        torch.device("cpu"), backend=Slow(), fingerprint=lambda owner: ())
        for _ in range(4)]
    owners = [_Owner() for _ in range(4)]
    x = torch.arange(4.0)
    outs, errors = {}, []

    def work(i):
        try:
            key = ("p", graphs_lib.batch_shapes(x))
            for _ in range(3):
                outs.setdefault(i, []).append(runners[i].run(
                    owners[i], key, x + i, lambda t: t * 2))
        except Exception as exc:     # asserted empty below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[0]
    assert peak[0] == 1
    assert [r.backend.captures for r in runners] == [1] * 4
    for i, got in outs.items():
        for out in got:
            assert torch.equal(out, (x + i) * 2)


def test_the_cuda_backend_captures_under_the_process_lock(monkeypatch):
    held = []

    class Graph:
        def replay(self):
            pass

    def probe():
        free = graphs_lib.CAPTURE_LOCK.acquire(blocking=False)
        if free:
            graphs_lib.CAPTURE_LOCK.release()
        held.append(not free)

    import contextlib

    @contextlib.contextmanager
    def graph(g, pool, capture_error_mode):
        t = threading.Thread(target=probe)
        t.start()
        t.join()
        yield

    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: 0)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    backend = graphs_lib.CudaGraphBackend(torch.device("cpu"))
    assert backend.capture(lambda: 1)() == 1
    assert held == [True]


def test_a_launch_beside_a_capture_is_counted_not_taken_back(monkeypatch):
    """A capture's own launches go to its graph's tally (each replay adds
    them); a launch another thread makes meanwhile, on a stream that is
    not capturing, is counted as it runs."""
    capturing = set()
    monkeypatch.setattr(ops_launches, "stream_capturing",
                        lambda: threading.get_ident() in capturing)
    beside = threading.Event()
    done = threading.Event()

    def other_thread():
        beside.wait(timeout=30)
        ops_launches.count("scatter_add")
        done.set()

    class Launching(StandInBackend):
        def capture(self, body):
            capturing.add(threading.get_ident())
            try:
                ops_launches.count("scatter_add")
                ops_launches.count("scatter_add")
                beside.set()
                assert done.wait(timeout=30)
            finally:
                capturing.discard(threading.get_ident())
            return super().capture(body)

    runner = graphs_lib.ProgramGraphs(
        torch.device("cpu"), backend=Launching(),
        fingerprint=lambda owner: ())
    owner = _Owner()
    x = torch.ones(2)
    key = ("p", graphs_lib.batch_shapes(x))
    t = threading.Thread(target=other_thread)
    t.start()
    before = sa.scatter_add.launches
    runner.run(owner, key, x, lambda v: v + 1)            # eager
    runner.run(owner, key, x, lambda v: v + 1)            # capture, replay
    t.join(timeout=30)
    assert owner.graphs[key].captured.launches == {"scatter_add": 2}
    # the other thread's launch, and one replay of the graph's two
    assert sa.scatter_add.launches - before == 1 + 2

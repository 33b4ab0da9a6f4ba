"""The port's program observatory (elasticdl_tpu_torch/common/programs.py)
against the JAX package's registry: the fake-clock compile histogram, a
signature cache hit that is not a retrace, concurrent first calls
counted once, one storm per program, the clock-free forensics, the
process singleton, the serving engine's buckets as its budget, the
byte-stable recompile-storm bundle, `programs` on /varz, the kernel
builds, and the counted cost: flops equal to torch.utils.flop_counter's,
the hand kernels' custom ops charged by the formulas `chip_smoke.py`
divides by the card's peaks, and a backward's ops counted.

Where the two registries are fed the same `note_compile` / `note_storm`
calls their ledgers, summaries and forensics are equal.  Where a JAX
program and a port program run, the ledgers are compared with the cost
fields masked: the reference's dispatch-path compiles carry flops 0 and
bytes 0 (XLA's cost model comes only from its AOT query), the port's
carry the counted cost (a difference kept on purpose, ROADMAP.md queue
3)."""

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from elasticdl_tpu.common import events as jax_events
from elasticdl_tpu.common import metrics as jax_metrics
from elasticdl_tpu.common import programs as jax_programs
from elasticdl_tpu.common.flight import FlightRecorder as JaxRecorder
from elasticdl_tpu_torch.common import events
from elasticdl_tpu_torch.common import metrics as metrics_lib
from elasticdl_tpu_torch.common import programs
from elasticdl_tpu_torch.common.flight import FlightRecorder
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.ops import scatter_add as sa

torch.set_num_threads(2)

COST_KEYS = ("flops_per_execution", "bytes_per_execution")


class FakeClock:
    """Monotonic fake: every read returns the current time and advances
    by `dt`, so compile wall seconds replay exactly."""

    def __init__(self, start=0.0, dt=1.0):
        self.t = float(start)
        self.dt = float(dt)

    def __call__(self):
        now = self.t
        self.t += self.dt
        return now


def _registry(clock=None):
    return programs.ProgramRegistry(
        clock=clock or FakeClock(), metrics=metrics_lib.MetricsRegistry())


def _jax_registry(clock=None):
    return jax_programs.ProgramRegistry(
        clock=clock or FakeClock(), metrics=jax_metrics.MetricsRegistry())


def _masked(ledger):
    return {name: {k: v for k, v in rec.items() if k not in COST_KEYS}
            for name, rec in ledger.items()}


@pytest.fixture(autouse=True)
def _clean_events():
    yield
    events.configure(None)
    jax_events.configure(None)


# ---- registry semantics, held against the JAX registry ------------------


def test_compile_histogram_is_deterministic_under_fake_clock():
    port, ref = _registry(), _jax_registry()
    prog = programs.registered_jit("p", lambda x: x + 1, registry=port)
    jprog = jax_programs.registered_jit("p", lambda x: x + 1, registry=ref)
    for rows in (2, 3):
        x = np.ones((rows,), np.float32)
        prog(torch.from_numpy(x))
        jprog(x)
    rec = port.ledger()["p"]
    assert rec["compiles"] == 2 and rec["signatures"] == 2
    # each first call brackets its dispatch with exactly one clock tick
    assert rec["compile_seconds_total"] == 2.0
    assert rec["compile_seconds_p50"] == rec["compile_seconds_p99"] == 1.0
    assert rec["avals"] == "float32[3]"
    assert _masked(port.ledger()) == _masked(ref.ledger())


def test_signature_cache_hit_is_not_a_retrace():
    port = _registry()
    prog = programs.registered_jit("p", lambda x: x * 2, registry=port)
    seen = []
    events.add_observer(seen.append)
    try:
        prog(torch.ones(2))
        prog(torch.ones(3))
        prog(torch.ones(2))  # cache hit
        prog(torch.ones(2, dtype=torch.float64))  # a new dtype retraces
    finally:
        events.remove_observer(seen.append)
    rec = port.ledger()["p"]
    assert rec["compiles"] == 3 and rec["signatures"] == 3
    compiled = [e for e in seen if e.get("event") == events.PROGRAM_COMPILED]
    assert [e["signatures"] for e in compiled] == [1, 2, 3]
    assert all(e["program"] == "p" for e in compiled)


def test_a_first_call_inside_a_counted_call_counts_for_both_programs():
    port = _registry()
    inner = programs.registered_jit("inner", lambda x: x @ x,
                                    registry=port)
    outer = programs.registered_jit("outer", lambda x: inner(x) + 1,
                                    registry=port)
    out = outer(torch.ones(4, 4))
    assert torch.equal(out, torch.full((4, 4), 5.0))
    led = port.ledger()
    assert led["inner"]["compiles"] == led["outer"]["compiles"] == 1
    assert led["inner"]["flops_per_execution"] == 2 * 4 * 4 * 4
    assert led["outer"]["flops_per_execution"] == 2 * 4 * 4 * 4
    # the inner signature is seen: its next call, alone or nested, is
    # not counted again
    inner(torch.ones(4, 4))
    outer(torch.ones(4, 4))
    assert port.ledger()["inner"]["compiles"] == 1


@pytest.mark.parametrize("rows", [(2, 3, 4, 5), (3, 3, 3, 3)])
def test_concurrent_first_calls_are_counted_exactly_once_each(rows):
    port = _registry()
    prog = programs.registered_jit("p", lambda x: (x * x).sum(),
                                   registry=port)
    barrier = threading.Barrier(len(rows))
    errors = []

    def call(n):
        try:
            barrier.wait(timeout=30)
            prog(torch.ones(n, 3))
        except Exception as exc:  # pragma: no cover - failure detail
            errors.append(exc)

    threads = [threading.Thread(target=call, args=(n,)) for n in rows]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    rec = port.ledger()["p"]
    assert rec["signatures"] == rec["compiles"] == len(set(rows))


def test_cost_for_reads_the_counted_cost_and_raises_before_a_run():
    """Before a run, `cost_for` answers with the abstract compile's cost
    (once, recorded, marked abstract), as the reference's AOT query
    does; the first run at that signature records no second compile."""
    port = _registry()
    prog = programs.registered_jit("p", lambda x: x @ x.T, registry=port)
    x = torch.ones(8, 8)
    before = prog.cost_for(x)
    assert before["flops"] == 2 * 8 * 8 * 8
    assert before["abstract"] is True
    rec = port.ledger()["p"]
    assert rec["compiles"] == 1 and rec["abstract"] is True
    assert rec["flops_per_execution"] == before["flops"]
    assert rec["bytes_per_execution"] == before["bytes accessed"]
    prog(x)
    cost = prog.cost_for(x)
    assert cost["flops"] == before["flops"]
    assert cost["bytes accessed"] == before["bytes accessed"]
    assert port.ledger()["p"]["compiles"] == 1
    # a signature that has run answers with its counted cost
    y = torch.ones(4, 4)
    prog(y)
    assert prog.cost_for(y)["flops"] == 2 * 4 * 4 * 4
    assert "abstract" not in prog.cost_for(y)
    assert port.ledger()["p"]["compiles"] == 2


def test_storm_fires_once_per_program_and_names_the_churn():
    hooks = {}
    for name, reg, make, arr in (
            ("port", _registry(FakeClock(dt=0.001)), programs.registered_jit,
             torch.ones),
            ("jax", _jax_registry(FakeClock(dt=0.001)),
             jax_programs.registered_jit,
             lambda n: np.ones((n,), np.float32))):
        hooks[name] = []
        reg.set_on_storm(hooks[name].append)
        prog = make("s", lambda x: x + 1, registry=reg, signature_budget=1)
        for rows in (2, 3, 4, 5):
            prog(arr(rows))
        rec = reg.ledger()["s"]
        assert rec["storms"] == 1 and rec["budget"] == 1
    assert hooks["port"] == hooks["jax"] == [
        {"program": "s", "signatures": 2, "budget": 1}]


def test_forensics_is_clock_free():
    port = _registry()
    prog = programs.registered_jit("p", lambda x: x + 1, registry=port)
    prog(torch.ones(2))
    rec = port.forensics()["ledger"]["p"]
    assert not any(k.startswith("compile_seconds") for k in rec)
    assert rec["compiles"] == 1


def test_default_registry_is_a_process_singleton():
    assert (programs.default_program_registry()
            is programs.default_program_registry())


def _scripted(reg):
    """One sequence of compiles, a build and a storm, as both packages'
    registries take them."""
    reg.declare("serving_forward", budget=2)
    reg.note_compile("worker_train_step", "aaa", 2.5,
                     cost={"flops": 1e9, "bytes accessed": 3e8},
                     avals="float32[64,13], int32[64,26]")
    reg.note_compile("worker_train_step", "bbb", 0.5,
                     cost={"flops": 2e9, "bytes accessed": 6e8})
    reg.note_compile("kernel_build_scatter_add", "0123abcd", 3.25,
                     avals="scatter_add.cu")
    for i, sig in enumerate(("s1", "s2", "s3")):
        reg.note_compile("serving_forward", sig, 0.125 * (i + 1),
                         cost={"flops": 4e6, "bytes accessed": 2e6})
    reg.note_storm("serving_forward", 3, 2)
    reg.bind_step_rate("worker_train_step", lambda: 10.0)


def test_scripted_ledger_and_forensics_equal_the_jax_registrys():
    port, ref = _registry(), _jax_registry()
    seen, jseen = [], []
    events.add_observer(seen.append)
    jax_events.add_observer(jseen.append)
    try:
        _scripted(port)
        _scripted(ref)
    finally:
        events.remove_observer(seen.append)
        jax_events.remove_observer(jseen.append)
    assert port.ledger() == ref.ledger()
    assert port.forensics() == ref.forensics()
    # neither has a card with datasheet peaks here: the ratios read 0
    assert port.summary() == ref.summary()
    assert port.live()["bytes_per_sec"] == 6e9
    strip = ("ts", "pid", "role")
    assert [{k: v for k, v in e.items() if k not in strip} for e in seen] \
        == [{k: v for k, v in e.items() if k not in strip} for e in jseen]


def test_device_peaks_name_the_h100_datasheet_and_nothing_else(monkeypatch):
    assert programs.device_peaks() is None   # the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, want in (("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
                       ("NVIDIA H100 PCIe", None),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(programs, "_PEAKS", {})
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda _i=0, n=name: n)
        peaks = programs.device_peaks()
        got = None if peaks is None else (peaks["bf16_flops"],
                                          peaks["hbm_bytes_per_s"])
        assert got == want, name
    monkeypatch.setattr(programs, "_PEAKS", {})
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda _i=0: "NVIDIA H100 80GB HBM3")
    port = _registry()
    _scripted(port)
    live = port.live()
    assert live["mfu"] == pytest.approx(2e9 * 10.0 / 989e12)
    assert live["hbm_utilization"] == pytest.approx(6e8 * 10.0 / 3.35e12)


# ---- the counted cost ----------------------------------------------------


def test_mlp_step_flops_equal_the_flop_counters():
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(13, 32), torch.nn.ReLU(),
                                torch.nn.Linear(32, 2))
    for p in model.parameters():
        p.data = torch.randn(p.shape, generator=gen)
    opt = torch.optim.Adam(model.parameters())
    x = torch.randn(16, 13, generator=gen)
    y = torch.randint(0, 2, (16,), generator=gen)

    def step(x, y):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        return loss.detach()

    port = _registry()
    prog = programs.registered_jit("worker_train_step", step, registry=port)
    prog(x, y)
    with FlopCounterMode(display=False) as counter:
        step(x, y)
    rec = port.ledger()["worker_train_step"]
    assert rec["flops_per_execution"] == counter.get_total_flops() > 0
    # at least the parameters, gradients and both Adam moments move
    params = sum(p.numel() * 4 for p in model.parameters())
    assert rec["bytes_per_execution"] > 4 * params


def test_a_registered_call_ends_where_an_unregistered_one_does():
    torch.manual_seed(3)
    a = torch.nn.Linear(8, 4)
    b = torch.nn.Linear(8, 4)
    b.load_state_dict(a.state_dict())
    opts = [torch.optim.Adam(m.parameters()) for m in (a, b)]
    x = torch.randn(5, 8)

    def stepper(model, opt):
        def step(x):
            opt.zero_grad()
            model(x).square().sum().backward()
            opt.step()
        return step

    prog = programs.registered_jit("p", stepper(a, opts[0]),
                                   registry=_registry())
    plain = stepper(b, opts[1])
    for _ in range(3):
        prog(x)
        plain(x)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


@pytest.mark.parametrize("causal,backward", [
    (False, False), (True, False), (False, True), (True, True)])
def test_flash_ops_are_charged_by_the_bound_formula(causal, backward):
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 2, 8).astype(np.float32))
               for _ in range(3))
    port = _registry()
    if backward:
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
        g = torch.ones_like(out)
        prog = programs.registered_jit(
            "bwd", lambda *a: fa.flash_attention_backward(*a, causal=causal),
            registry=port)
        prog(q, k, v, out, lse, g)
    else:
        prog = programs.registered_jit(
            "fwd", lambda q, k, v: fa.flash_attention_forward(
                q, k, v, causal=causal), registry=port)
        prog(q, k, v)
    (counted,) = prog.counted.values()
    flops, nbytes = fa.attention_cost(q.shape, k.shape, 4, causal,
                                      backward=backward)
    assert (counted["flops"], counted["bytes"]) == (flops, nbytes)
    op = fa.OP_BACKWARD if backward else fa.OP_FORWARD
    assert counted["kernel_calls"] == {op: 1}


def test_scatter_op_is_charged_by_the_bound_formula_with_its_rows():
    rng = np.random.RandomState(2)
    ids = torch.from_numpy(rng.randint(0, 50, 300).astype(np.int32))
    grads = torch.from_numpy(rng.randn(300, 16).astype(np.float32))
    table = torch.zeros(64, 16)
    prog = programs.registered_jit(
        "scatter", lambda t, i, g: sa.scatter_add_forward(t, i, g,
                                                          inplace=True),
        registry=_registry())
    prog(table, ids, grads)
    (counted,) = prog.counted.values()
    touched = len(np.unique(ids.numpy()))
    assert (counted["flops"], counted["bytes"]) == sa.scatter_cost(
        300, 16, touched)
    assert counted["kernel_calls"] == {sa.OP_SCATTER_ADD: 1}
    np.testing.assert_array_equal(
        table.numpy(), sa.scatter_add_reference(
            torch.zeros(64, 16), ids, grads).numpy())


def test_an_embedding_backward_charges_the_scatter_kernel():
    """The scatter-add runs only in the backward: a train step's counted
    call sees it, so the backward's ops are counted."""
    from elasticdl_tpu_torch.layers.embedding import DistributedEmbedding

    emb = DistributedEmbedding(64, 8)
    emb.reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.arange(40, dtype=torch.int32).remainder(13).reshape(10, 4)
    prog = programs.registered_jit(
        "worker_train_step", lambda i: emb(i).square().sum().backward(),
        registry=_registry())
    prog(ids)
    (counted,) = prog.counted.values()
    assert counted["kernel_calls"] == {sa.OP_SCATTER_ADD: 1}
    assert emb.embedding.grad is not None


# ---- the serving engine's programs --------------------------------------

MODEL_DEF = "mnist.mnist_functional_api.custom_model"
FEATURE_SPEC = {"features": {"shape": [784], "dtype": "float32"}}


@pytest.fixture(scope="module")
def mnist():
    from elasticdl_tpu_torch.common.model_handler import (
        ZOO_DIR, get_model_spec)
    from elasticdl_tpu_torch.worker.trainer import Trainer

    spec = get_model_spec(ZOO_DIR, MODEL_DEF)
    x = np.random.RandomState(0).rand(2, 784).astype(np.float32)
    state = Trainer(spec.model, spec.optimizer, spec.loss,
                    device="cpu").init_state(0, x)
    return spec, dict(state.model.state_dict())


def _engine(monkeypatch, mnist, registry, **kwargs):
    from elasticdl_tpu_torch.serving.engine import ServingEngine

    spec, variables = mnist
    monkeypatch.setattr(programs, "default_program_registry",
                        lambda: registry)
    return ServingEngine(spec.model, dict(variables), step=7,
                         feature_spec=FEATURE_SPEC, buckets=(2, 8),
                         device="cpu", **kwargs)


def test_prewarm_compiles_at_most_one_program_per_bucket(monkeypatch,
                                                         mnist):
    registry = _registry()
    engine = _engine(monkeypatch, mnist, registry)
    # the engine's own counter agrees with the observatory ledger
    assert engine.compile_count == len(engine.buckets)
    rec = registry.ledger()["serving_forward"]
    assert rec["compiles"] <= len(engine.buckets)
    assert rec["signatures"] == rec["budget"] == len(engine.buckets)
    assert rec["flops_per_execution"] > 0 and rec["bytes_per_execution"] > 0
    x = np.random.RandomState(1).rand(8, 784).astype(np.float32)
    for rows in (1, 2, 3, 5, 8):
        engine.predict({"features": x[:rows]}, rows)
    rec = registry.ledger()["serving_forward"]
    assert rec["signatures"] == len(engine.buckets)
    assert rec["storms"] == 0
    assert engine.compile_count == rec["compiles"]


def _storm_run(root, make_engine, registry, recorder_cls, rows_of):
    recorder = recorder_cls(incident_dir=str(root),
                            program_registry=registry)
    engine = make_engine(registry)
    x = np.random.RandomState(1).rand(8, 784).astype(np.float32)
    for rows in (1, 3, 5, 7):  # none of these is a bucket
        engine.predict(rows_of(x[:rows]), rows)
    recorder.close()
    assert sorted(os.listdir(root)) == ["incident-0001-recompile_storm"]
    bundle = root / "incident-0001-recompile_storm"
    return engine, {name: (bundle / name).read_bytes()
                    for name in sorted(os.listdir(bundle))}


def test_bucket_missing_engine_captures_one_byte_stable_storm_bundle(
        monkeypatch, tmp_path, mnist):
    """An engine that stopped padding to its buckets blows its
    bucket-count budget, and the recorder captures exactly one
    recompile_storm bundle naming the program and its churn, byte for
    byte the same across two runs; its manifest is the JAX engine's."""
    runs = []
    for sub in ("a", "b"):
        engine, files = _storm_run(
            tmp_path / sub,
            lambda reg: _engine(monkeypatch, mnist, reg,
                                pad_to_bucket=False),
            _registry(FakeClock(dt=0.001)), FlightRecorder,
            lambda x: {"features": x})
        runs.append(files)
        assert engine.compile_count == 6
    assert runs[0] == runs[1]
    files = runs[0]
    assert set(files) == {"decisions.json", "faults.json", "lineage.json",
                          "manifest.json", "programs.json", "spans.json"}
    manifest = json.loads(files["manifest.json"])
    assert manifest["trigger"] == "recompile_storm"
    assert manifest["evidence"] == {"program": "serving_forward",
                                    "signatures": 3, "budget": 2}
    ledger = json.loads(files["programs.json"])["ledger"]
    assert ledger["serving_forward"]["storms"] == 1
    assert ledger["serving_forward"]["signatures"] == 3

    from elasticdl_tpu.common.model_handler import get_model_spec
    from elasticdl_tpu.serving.engine import ServingEngine as JaxEngine

    jspec = get_model_spec("model_zoo", MODEL_DEF)
    xs = np.random.RandomState(0).rand(2, 784).astype(np.float32)
    jvars = dict(jspec.model.init(jax.random.PRNGKey(0), xs))

    def jax_engine(reg):
        monkeypatch.setattr(jax_programs, "default_program_registry",
                            lambda: reg)
        return JaxEngine(jspec.model, dict(jvars), step=7,
                         feature_spec=FEATURE_SPEC, buckets=(2, 8),
                         pad_to_bucket=False)

    _, jfiles = _storm_run(tmp_path / "jax", jax_engine,
                           _jax_registry(FakeClock(dt=0.001)), JaxRecorder,
                           lambda x: {"features": x})
    for name in ("manifest.json", "decisions.json", "faults.json",
                 "lineage.json", "spans.json"):
        assert files[name] == jfiles[name], name
    jledger = json.loads(jfiles["programs.json"])["ledger"]
    strip = COST_KEYS + ("avals",)
    assert ({k: v for k, v in ledger["serving_forward"].items()
             if k not in strip}
            == {k: v for k, v in jledger["serving_forward"].items()
                if k not in strip})


# ---- surfaces ------------------------------------------------------------


def test_varz_json_carries_the_programs_summary():
    from elasticdl_tpu_torch.common.telemetry import TelemetryServer

    server = TelemetryServer(registries=[metrics_lib.MetricsRegistry()],
                             role="test")
    doc = json.loads(server.varz_json())
    assert "ledger" in doc["programs"]
    assert doc["programs"] == json.loads(json.dumps(
        programs.default_program_registry().summary()))


def test_kernel_builds_are_programs_and_a_cache_hit_records_nothing(
        monkeypatch, tmp_path):
    """`_build.build_all` reports each nvcc build as the program
    `kernel_build_<stem>` with its wall seconds; a library already in
    the cache records nothing.  A stand-in nvcc writes the library."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ \"$1\" != \"-o\" ]; do shift; "
                    "done\necho 'ptxas info'\ntouch \"$2\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    registry = _registry()
    monkeypatch.setattr(programs, "default_program_registry",
                        lambda: registry)
    built = _build.build_all([sa.SOURCE, fa.SOURCE])
    assert all(path.exists() for path in built.values())
    led = registry.ledger()
    assert sorted(led) == ["kernel_build_flash_attention_fwd",
                           "kernel_build_scatter_add"]
    rec = led["kernel_build_scatter_add"]
    assert rec["compiles"] == 1 and rec["avals"] == sa.SOURCE
    assert rec["flops_per_execution"] == 0.0
    assert _build.build_logs[sa.SOURCE].strip() == "ptxas info"
    _build.build_all([sa.SOURCE, fa.SOURCE])   # both cached now
    assert registry.ledger()["kernel_build_scatter_add"]["compiles"] == 1


def test_a_local_job_under_the_registry_ends_where_one_without_it_does(
        monkeypatch, tmp_path):
    """A Local DeepFM job whose programs count their first calls ends
    bit for bit on the state of the same job with every registered
    program called straight through."""
    from elasticdl_tpu_torch.client import api
    from elasticdl_tpu_torch.client import main as cli
    from elasticdl_tpu_torch.model_zoo.deepfm.data import write_dataset

    train_dir, val_dir = write_dataset(str(tmp_path / "data"), n_train=512,
                                       n_val=128)
    argv = ["train", "--distribution_strategy", "Local",
            "--model_def", "deepfm.deepfm_functional_api.custom_model",
            "--model_params", "vocab_capacity=4096;embed_dim=8;lr=0.005",
            "--minibatch_size", "64", "--records_per_task", "128",
            "--use_bf16", "false", "--training_data", train_dir,
            "--validation_data", val_dir, "--steps_per_execution", "2",
            "--device", "cpu"]
    registry = _registry()
    monkeypatch.setattr(programs, "default_program_registry",
                        lambda: registry)
    counted = api.run_local(cli.parse_args(argv), "train")
    led = registry.ledger()
    assert led["worker_train_step_many"]["compiles"] >= 1
    assert led["worker_eval_step"]["flops_per_execution"] > 0
    monkeypatch.setattr(programs.RegisteredProgram, "__call__",
                        lambda self, *a, **k: self._fn(*a, **k))
    plain = api.run_local(cli.parse_args(argv), "train")
    assert counted.ok and plain.ok
    assert counted.owner.step == plain.owner.step == 8
    want = plain.owner.state.model.state_dict()
    got = counted.owner.state.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert counted.metrics == plain.metrics

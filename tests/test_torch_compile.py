"""The port's compile (common/programs.py `aot_compile`, worker/graphs.py,
the Trainer's graph dispatch and prewarm) on the CPU.

- `aot_compile` runs a program on fake tensors (`abstract_like`, the
  port's ShapeDtypeStruct): one ledger compile, flops and bytes, no real
  state changed, no kernel run, CUDA never initialised.  At the CPU's
  device its flops equal the eager first call's at the same shapes, and
  its bytes too, apart from the scatter-add's touched rows, which an
  abstract call counts at their bound min(N, R).  At the card's device
  (fake `cuda` tensors) a kernel's program runs here and names the
  library it loads, chosen by the wrappers' predicates.  A model's
  step there needs a CUDA build of PyTorch (its ops ask the device for a
  guard and a stream), so here the train step raises before it starts,
  and `chip_smoke.py` runs it on the card.
- The int8 fold's counter-based draw: the same on every run, a row shard
  draws its rows of the whole plane, zero-delta rows stay bit-stable,
  the rounding is unbiased, and the codes lie within one step of the JAX
  fold's on the same planes.
- A checkpoint's optimizer state restores across the capturable
  setting, either way.  The graphs' Adam (capturable, float64 step
  counts) steps as plain Adam does, to an ulp of an update.
- The graph runner with a stand-in backend (a "capture" that replays by
  running the captured body on the static buffers): graph steps equal
  eager steps bit for bit, launch counts, recapture after a restore, and
  a failed capture raises.
- `prewarm_for_device_counts(block=True)` records the compile and logs
  its line (the twin of tests/test_prewarm.py).
"""

import contextlib
import copy
import logging
import os

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.layers import arena as jax_arena
from elasticdl_tpu_torch.common import model_handler as port_handler
from elasticdl_tpu_torch.common import programs
from elasticdl_tpu_torch.common import save_utils
from elasticdl_tpu_torch.layers import arena as port_arena
from elasticdl_tpu_torch.model_zoo.deepfm.data import synthetic_criteo
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.ops import launches as ops_launches
from elasticdl_tpu_torch.ops import scatter_add as sa
from elasticdl_tpu_torch.worker import graphs as graphs_lib
from elasticdl_tpu_torch.worker import trainer as port_trainer

torch.set_num_threads(2)

DEEPFM = "deepfm.deepfm_functional_api.custom_model"
DEEPFM_PARAMS = "vocab_capacity=4096;embed_dim=8;lr=0.005"
BERT = "bert.bert_finetune.custom_model"
BERT_PARAMS = ("hidden=64;num_layers=2;heads=4;mlp_dim=128;max_len=64;"
               "vocab_size=512")
BATCH = 64
# Rounding of a constant x: the mean of n draws lies within 3 sigma of
# x, sigma = sqrt(f (1 - f) / n) for x's fraction f.
SIGMAS = 3.0
# The JAX fold and the port's derive each touched row's scale by the same
# f32 formula from the same planes and delta.
SCALE_RTOL = 1e-6


@pytest.fixture
def registry(monkeypatch):
    reg = programs.ProgramRegistry()
    monkeypatch.setattr(programs, "default_program_registry", lambda: reg)
    return reg


@pytest.fixture
def trainer_log():
    """The trainer's log lines (its logger does not propagate)."""
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    port_trainer.logger.addHandler(handler)
    yield lines
    port_trainer.logger.removeHandler(handler)


@pytest.fixture
def built(monkeypatch):
    """The sources an abstract compile asks the library cache for,
    recorded instead of built (the CPU tests run no nvcc)."""
    names = []
    monkeypatch.setattr(_build, "build_all",
                        lambda sources=None: names.extend(sources))
    return names


def _spec(model=DEEPFM, params=DEEPFM_PARAMS):
    return port_handler.get_model_spec(port_handler.ZOO_DIR, model,
                                       model_params=params)


def _trainer(model=DEEPFM, params=DEEPFM_PARAMS, **kwargs):
    spec = _spec(model, params)
    return port_trainer.Trainer(spec.model, spec.optimizer, spec.loss,
                                device="cpu", **kwargs)


def _deepfm_batch(n=BATCH, seed=0):
    dense, sparse, labels = synthetic_criteo(n, seed=seed)
    return {"features": {"dense": dense, "sparse": sparse},
            "labels": labels.astype(np.int32)}


def _bert_batch(n=8, length=64, seed=0):
    rng = np.random.RandomState(seed)
    return {"features": {"input_ids": rng.randint(
                0, 512, (n, length)).astype(np.int32)},
            "labels": rng.randint(0, 2, n).astype(np.int32)}


def _host(batch):
    return port_trainer._to_device(batch, torch.device("cpu"))


def _snapshot(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


# ---- aot_compile -----------------------------------------------------------


@pytest.mark.parametrize("model,params,make_batch", [
    (DEEPFM, DEEPFM_PARAMS, _deepfm_batch),
    (DEEPFM, DEEPFM_PARAMS + ";arena_dtype='int8'", _deepfm_batch),
    (BERT, BERT_PARAMS, _bert_batch),
], ids=["deepfm", "deepfm_int8", "bert"])
def test_abstract_train_step_counts_the_eager_first_call(
        registry, built, monkeypatch, model, params, make_batch):
    calls = {"abstract": [], "eager": []}
    cost = programs._KERNEL_COSTS[sa.OP_SCATTER_ADD]

    def recorded(table, ids, grads):
        kind = "abstract" if programs.is_abstract(ids) else "eager"
        touched = (min(ids.numel(), table.shape[0]) if kind == "abstract"
                   else int(torch.unique(ids).numel()))
        calls[kind].append((touched, table.shape[1]))
        return cost(table, ids, grads)

    monkeypatch.setitem(programs._KERNEL_COSTS, sa.OP_SCATTER_ADD, recorded)
    trainer = _trainer(model, params)
    template = _snapshot(trainer.model)
    batch = make_batch()
    got = trainer.train_step.aot_compile(
        trainer.abstract_state("cpu"), programs.abstract_like(_host(batch)))
    rec = registry.ledger()["worker_train_step"]
    assert rec["compiles"] == 1 and rec["abstract"] is True
    assert got["cost"]["abstract"] is True
    assert got["libraries"] == [] and built == []   # the CPU loads none
    # the template is untouched
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, template[k]), k
    assert not torch.cuda.is_initialized()

    eager = _trainer(model, params)
    state = eager.init_state(0, batch["features"])
    eager.train_on_batch(state, batch)
    counted = next(iter(eager.train_step.counted.values()))
    assert got["cost"]["flops"] == counted["flops"] > 0
    bound_extra = sum(2 * (ua - ue) * dim * 4 for (ua, dim), (ue, _)
                      in zip(calls["abstract"], calls["eager"]))
    assert len(calls["abstract"]) == len(calls["eager"])
    assert got["cost"]["bytes accessed"] == counted["bytes"] + bound_extra
    assert got["kernel_calls"] == counted["kernel_calls"]


def test_a_real_call_after_the_abstract_compile_records_no_second(registry):
    trainer = _trainer()
    batch = _deepfm_batch()
    state = trainer.init_state(0, batch["features"])
    before = _snapshot(state.model)
    trainer.train_step.aot_compile(state_like := trainer.abstract_state(
        "cpu"), programs.abstract_like(_host(batch)))
    assert state_like.step == 1          # the fake copy stepped
    assert state.step == 0               # the real one did not
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    trainer.train_on_batch(state, batch)
    assert registry.ledger()["worker_train_step"]["compiles"] == 1
    assert state.step == 1


def _fake_qkv(dtype, batch=2, length=64, heads=4, dim=64):
    """Fake contiguous (B, L, H, D) q, k, v on the card's device."""
    with programs.in_abstract_mode():
        return [torch.empty(batch, length, heads, dim, dtype=dtype,
                            device="cuda") for _ in range(3)]


@pytest.mark.parametrize("dtype,forward,backward", [
    (torch.bfloat16, fa.SOURCE_SM90, fa.SOURCE_BWD_SM90),
    (torch.float32, fa.SOURCE, fa.SOURCE_BWD),
], ids=["bf16", "f32"])
def test_flash_library_needs_follow_the_wrappers_predicates(
        dtype, forward, backward):
    """The libraries an abstract compile builds for the flash ops are the
    variants `tensor_core_ok` and `backward_wgmma_ok` pick; the CPU loads
    none."""
    q, k, v = _fake_qkv(dtype)
    needs = programs._KERNEL_LIBRARIES
    assert needs[fa.OP_FORWARD](q, k, v, False, 0.125) == (forward,)
    with programs.in_abstract_mode():
        lse = torch.empty(2, 64, 4, device="cuda")
    assert needs[fa.OP_BACKWARD](q, k, v, q, lse, q, False, 0.125) == (
        backward,)
    cpu = [torch.zeros(2, 64, 4, 64, dtype=dtype) for _ in range(3)]
    assert needs[fa.OP_FORWARD](*cpu, False, 0.125) == ()
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("offset,aligned", [(0, True), (4, False),
                                            (8, True)])
def test_a_fake_tensor_is_aligned_by_its_storage_offset(offset, aligned):
    """A fake tensor has no pointer: the wgmma predicate reads its bf16
    elements' offset into the storage (8 elements = 16 bytes)."""
    base = torch.zeros(2 * 64 * 4 * 64 + 8, dtype=torch.bfloat16)
    view = base[offset:offset + 2 * 64 * 4 * 64].view(2, 64, 4, 64)
    with programs.in_abstract_mode():
        fake = programs.abstract_mode().from_tensor(view)
    assert programs.is_abstract(fake)
    assert fa.tensor_core_ok(fake, fake, fake) is aligned
    assert fa.tensor_core_ok(view, view, view) is (
        view.data_ptr() % 16 == 0)


def test_abstract_scatter_on_fake_cuda_counts_the_touched_bound(
        registry, built):
    prog = programs.registered_jit("scatter", sa.scatter_add,
                                   registry=registry)
    rows, n, dim = 100, 256, 16
    table, ids, grads = programs.abstract_like(
        (torch.zeros(rows, dim), torch.zeros(n, dtype=torch.int32),
         torch.zeros(n, dim)), "cuda")
    launches = sa.scatter_add.launches
    got = prog.aot_compile(table, ids, grads)
    assert got["cost"]["flops"] == n * dim
    assert got["cost"]["bytes accessed"] == sa.scatter_cost(
        n, dim, min(n, rows))[1] + 2 * rows * dim * 4   # + the clone
    assert got["libraries"] == [sa.SOURCE] == built
    assert sa.scatter_add.launches == launches
    assert not torch.cuda.is_initialized()


def test_abstract_cuda_train_step_needs_a_cuda_build(registry, built):
    if torch.backends.cuda.is_built():
        pytest.skip("this PyTorch has CUDA: chip_smoke.py runs it")
    trainer = _trainer()
    with pytest.raises(RuntimeError, match="CUDA build"):
        trainer.train_step.aot_compile(
            trainer.abstract_state("cuda"),
            programs.abstract_like(_host(_deepfm_batch()), "cuda"))
    assert "worker_train_step" not in registry.ledger() or \
        registry.ledger()["worker_train_step"]["compiles"] == 0


# ---- the int8 fold's draw --------------------------------------------------


def _planes(rows=64, dim=8, seed=0, touched=None):
    rng = np.random.RandomState(seed)
    table = rng.normal(0, 0.05, (rows, dim)).astype(np.float32)
    q8, scale = port_arena.quantize_rows(torch.from_numpy(table))
    delta = rng.normal(0, 0.01, (rows, dim)).astype(np.float32)
    if touched is not None:
        delta[~touched] = 0.0
    return q8, scale, torch.from_numpy(delta)


def test_the_draw_is_the_same_on_every_run_and_moves_with_the_step():
    path = ("fm_embedding", "embedding")
    a = port_arena.uniform_draw(port_arena.fold_key(11, path), 64, 8)
    b = port_arena.uniform_draw(port_arena.fold_key(11, path), 64, 8)
    c = port_arena.uniform_draw(port_arena.fold_key(12, path), 64, 8)
    d = port_arena.uniform_draw(
        port_arena.fold_key(11, ("fm_linear", "embedding")), 64, 8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    # a device step counter keys the same draw as the host int
    assert torch.equal(port_arena.fold_key(torch.tensor(11), path),
                       port_arena.fold_key(11, path))
    assert a.min() >= 0 and a.max() < 1


def test_a_row_shard_folds_its_rows_of_the_whole_plane():
    q8, scale, delta = _planes(rows=64)
    key = port_arena.fold_key(3, ("fm_embedding", "embedding"))
    whole = port_arena._requantize_plane(q8, scale, delta, key)
    for first in (0, 32):
        rows = slice(first, first + 32)
        part = port_arena._requantize_plane(q8[rows], scale[rows],
                                            delta[rows], key, first)
        assert torch.equal(part[0], whole[0][rows])
        assert torch.equal(part[1], whole[1][rows])


def test_zero_delta_rows_stay_bit_stable():
    touched = np.zeros(64, bool)
    touched[[1, 7, 30]] = True
    q8, scale, delta = _planes(touched=touched)
    key = port_arena.fold_key(5, ("fm_embedding", "embedding"))
    new_q8, new_scale = port_arena._requantize_plane(q8, scale, delta, key)
    assert torch.equal(new_q8[~touched], q8[~touched])
    assert torch.equal(new_scale[~touched], scale[~touched])


@pytest.mark.parametrize("value", [2.3, -5.7, 0.5, 100.01])
def test_the_rounding_is_unbiased(value):
    n = 100_000
    got = port_arena.stochastic_round(torch.full((n, 4), value), 9)
    got = got.double()
    frac = value - np.floor(value)
    sigma = np.sqrt(frac * (1 - frac) / got.numel())
    assert abs(float(got.mean()) - value) <= SIGMAS * sigma
    assert set(torch.unique(got).tolist()) <= {np.floor(value),
                                               np.floor(value) + 1}


def test_codes_lie_within_one_of_the_jax_fold():
    touched = np.random.RandomState(4).rand(64) < 0.5
    q8, scale, delta = _planes(touched=touched)
    path = ("fm_embedding", "embedding")
    key = port_arena.fold_key(7, path)
    new_q8, new_scale = port_arena._requantize_plane(q8, scale, delta, key)
    quant = {"fm_embedding": {"embedding": {
        "q8": q8.numpy(), "scale": scale.numpy()}}}
    params = {"params": {"fm_embedding": {"embedding": delta.numpy()}}}
    _, state = jax_arena.fold_quantized_updates(
        params, {"quantized": quant}, 7)
    jplanes = state["quantized"]["fm_embedding"]["embedding"]
    jq8, jscale = np.asarray(jplanes["q8"]), np.asarray(jplanes["scale"])
    np.testing.assert_allclose(new_scale.numpy(), jscale, rtol=SCALE_RTOL)
    diff = np.abs(new_q8.numpy().astype(np.int32) - jq8.astype(np.int32))
    assert diff.max() <= 1
    assert (diff[~touched] == 0).all()
    assert diff[touched].any()           # two draws, not one


# ---- the optimizer state across the capturable setting ---------------------


def _adam(params, capturable):
    return torch.optim.Adam(params, lr=1e-3, capturable=capturable)


def test_a_state_saved_before_capturable_adam_restores_into_it():
    """A pre-capturable state (its step a host count) into a capturable
    optimizer: the group stays capturable and the step lands on the
    parameter's device in float64, as a CUDA trainer's optimizer keeps
    it (`graphs.capturable_adam`)."""
    p = torch.nn.Parameter(torch.ones(3))
    old = _adam([p], capturable=False)
    p.grad = torch.ones(3)
    old.step()
    saved = copy.deepcopy(old.state_dict())
    q = torch.nn.Parameter(torch.ones(3))
    new = _adam([q], capturable=True)
    save_utils.load_optimizer_state(new, saved)
    assert new.param_groups[0]["capturable"] is True
    step = new.state[q]["step"]
    assert step.dtype == torch.float64 and step.device == q.device
    assert float(step) == 1.0


def test_a_capturable_state_restores_on_the_cpu(tmp_path):
    """A state saved from a CUDA trainer (capturable groups) restores
    into the CPU trainer's plain optimizer, which then steps."""
    trainer = _trainer()
    batch = _deepfm_batch()
    state = trainer.init_state(0, batch["features"])
    trainer.train_on_batch(state, batch)
    host = save_utils.host_state(state)
    for group in host["optimizer"]["param_groups"]:
        group["capturable"] = True
    fresh = trainer.init_state(0, batch["features"])
    save_utils.load_optimizer_state(fresh.optimizer, host["optimizer"])
    assert all(not g["capturable"] for g in fresh.optimizer.param_groups)
    fresh.step = host["step"]
    trainer.train_on_batch(fresh, batch)
    assert fresh.step == 2


# Each step of the graphs' Adam lies within STEP_UNITS x t units of
# (the element's ulp + lr's ulp) of plain Adam's after t steps: the two
# order the update's last multiply and divide differently (2.9 units
# after one step, 6.4 to 8.9 after six, measured at these shapes).
STEP_UNITS = 4.0


def _units(a, b, lr):
    b = b.detach().numpy()
    unit = np.spacing(np.abs(b)) + np.spacing(np.float32(lr))
    return float((np.abs(a.detach().numpy() - b) / unit).max())


@pytest.mark.parametrize("cls", [torch.optim.Adam, torch.optim.AdamW],
                         ids=["adam", "adamw"])
def test_the_graphs_adam_steps_as_plain_adam(monkeypatch, cls):
    """`capturable_adam` (capturable, float64 step counts) against plain
    Adam on the same gradients, on the CPU (PyTorch's device rule for
    capturable lifted for the test: the arithmetic is the CUDA path's).
    PyTorch's capturable Adam as it comes counts in float32, whose bias
    corrections shrink the first update by 6.7e-6: 72 units off."""
    import torch.optim.adam as torch_adam

    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda supports_xla=True: ["cpu", "cuda"])
    rng = np.random.default_rng(0)
    p0 = rng.normal(0, 0.05, (4096, 16)).astype(np.float32)
    grads = [(rng.normal(0, 1, p0.shape)
              * np.exp(rng.normal(0, 3, p0.shape)) * 1e-4).astype(np.float32)
             for _ in range(4)]
    lr = 0.005

    def run(make):
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = make([p])
        out = []
        for g in grads:
            p.grad = torch.from_numpy(g.copy())
            opt.step()
            out.append(p.detach().clone())
        return out, opt.state[p]["step"]

    plain, step = run(lambda ps: cls(ps, lr=lr))
    ours, ours_step = run(lambda ps: graphs_lib.capturable_adam(
        cls(ps, lr=lr)))
    theirs, their_step = run(lambda ps: cls(ps, lr=lr, capturable=True))
    assert ours_step.dtype == torch.float64 and float(ours_step) == 4.0
    assert their_step.dtype == torch.float32
    for t, (a, b) in enumerate(zip(ours, plain), start=1):
        assert _units(a, b, lr) <= STEP_UNITS * t, t
    assert _units(theirs[0], plain[0], lr) > 10 * STEP_UNITS


# ---- the graph runner ------------------------------------------------------


@contextlib.contextmanager
def capturing_stream():
    """The current stream reads as capturing inside the block, as a
    wrapper called inside a real capture sees it."""
    real = ops_launches.stream_capturing
    ops_launches.stream_capturing = lambda: True
    try:
        yield
    finally:
        ops_launches.stream_capturing = real


def _rewrite(static, fresh):
    """Copy a replay's fresh output into the static one, leaf by leaf."""
    for dst, src in zip(torch.utils._pytree.tree_leaves(static),
                        torch.utils._pytree.tree_leaves(fresh)):
        if not isinstance(dst, torch.Tensor):
            continue
        # a forward's output under inference_mode is an inference tensor
        with torch.inference_mode(dst.is_inference()):
            dst.copy_(src)


class StandInBackend:
    """A backend whose capture runs nothing and whose replay runs the
    captured body (on the static buffers), and which counts its calls; a
    capture runs each wrapper's Python once, on a capturing stream,
    which `launches` stands for.  As a real graph, every replay writes
    into one static output (the first replay's), which the next replay
    rewrites: a result read after the next replay is that replay's."""

    def __init__(self, fail=False, launches=0):
        self.fail = fail
        self.launches = launches
        self.captures = 0
        self.replays = 0
        self.side = 0

    @contextlib.contextmanager
    def side_stream(self):
        self.side += 1
        yield

    def capture(self, body):
        if self.fail:
            raise RuntimeError("capture failed: operation not permitted "
                               "when stream is capturing")
        self.captures += 1
        with capturing_stream():
            for _ in range(self.launches):
                ops_launches.count("scatter_add")
        static = []

        def replay():
            self.replays += 1
            fresh = body()
            if not static:
                static.append(fresh)
            else:
                _rewrite(static[0], fresh)
            return static[0]

        return replay


def _graphed(trainer, monkeypatch, backend):
    trainer._graphs.backend = backend
    monkeypatch.setattr(trainer, "graph_ok", lambda state, batches: True)
    return trainer


@pytest.mark.parametrize("params", [
    DEEPFM_PARAMS, DEEPFM_PARAMS + ";arena_dtype='int8'"],
    ids=["fp32", "int8"])
def test_graph_steps_equal_eager_steps(monkeypatch, params):
    batches = [_deepfm_batch(seed=s) for s in range(12)]
    eager = _trainer(params=params)
    graphed = _graphed(_trainer(params=params), monkeypatch,
                       StandInBackend())
    states = [t.init_state(0, batches[0]["features"])
              for t in (eager, graphed)]
    got = {"eager": [], "graph": []}
    for trainer, state, label in ((eager, states[0], "eager"),
                                  (graphed, states[1], "graph")):
        for b in batches[:4]:
            got[label].append(trainer.train_on_batch(state, b)[1])
        for i in (4, 8):
            got[label] += list(trainer.train_on_batch_stack(
                state, batches[i:i + 4])[1])
    for a, b in zip(got["eager"], got["graph"]):
        assert torch.equal(a, b)
    assert states[0].step == states[1].step == 12
    for (name, a), b in zip(states[0].model.state_dict().items(),
                            states[1].model.state_dict().values()):
        assert torch.equal(a, b), name
    for p, q in zip(states[0].model.parameters(),
                    states[1].model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(states[0].optimizer.state[p][key],
                               states[1].optimizer.state[q][key])
    backend = graphed._graphs.backend
    # single step: eager, capture + replay, replay, replay; the K=4
    # stack: eager, capture + replay
    assert backend.side == 2 and backend.captures == 2
    assert backend.replays == 4


def test_a_replay_adds_the_launches_its_capture_took_back(monkeypatch):
    backend = StandInBackend(launches=2)
    trainer = _graphed(_trainer(), monkeypatch, backend)
    batch = _deepfm_batch()
    state = trainer.init_state(0, batch["features"])
    before = sa.scatter_add.launches
    for _ in range(4):
        trainer.train_on_batch(state, batch)
    # the CPU's plain scatter counts nothing; 3 replays of a graph whose
    # capture counted 2
    assert sa.scatter_add.launches - before == 3 * 2
    entry = state.graphs[("step", graphs_lib.batch_shapes(
        [port_trainer._to_device(batch, torch.device("cpu"))]))]
    assert entry.captured.launches == {"scatter_add": 2}


def test_a_restore_captures_anew(monkeypatch, tmp_path):
    backend = StandInBackend()
    trainer = _graphed(_trainer(), monkeypatch, backend)
    batch = _deepfm_batch()
    state = trainer.init_state(0, batch["features"])
    for _ in range(3):
        trainer.train_on_batch(state, batch)
    assert backend.captures == 1
    host = save_utils.host_state(state)
    save_utils.load_optimizer_state(state.optimizer, host["optimizer"])
    trainer.train_on_batch(state, batch)
    assert backend.captures == 2
    trainer.train_on_batch(state, batch)
    assert backend.captures == 2 and state.step == 5


def test_each_thread_makes_its_own_eager_call_before_it_captures(
        monkeypatch):
    """Two threads training one state in turn (the Local runner's
    workers): each one's first call at a key runs eagerly (a capture
    needs what it sets up on that thread), either one captures after
    it, and both replay the one graph; the steps stay those of eager
    training."""
    from concurrent.futures import ThreadPoolExecutor

    backend = StandInBackend()
    trainer = _graphed(_trainer(), monkeypatch, backend)
    eager = _trainer()
    batches = [_deepfm_batch(seed=s) for s in range(6)]
    state = trainer.init_state(0, batches[0]["features"])
    ref = eager.init_state(0, batches[0]["features"])
    losses = []

    def call(batch):
        losses.append(trainer.train_on_batch(state, batch)[1])

    with ThreadPoolExecutor(max_workers=1) as other:
        for i, batch in enumerate(batches):
            if i % 2:
                other.submit(call, batch).result()
            else:
                call(batch)
    want = [eager.train_on_batch(ref, b)[1] for b in batches]
    # main: eager, capture + replay, replay; the thread: eager (its
    # first), then replays of the main thread's graph
    assert backend.side == 2 and backend.captures == 1
    assert backend.replays == 4
    assert all(torch.equal(a, b) for a, b in zip(losses, want))
    assert state.step == ref.step == 6


def test_a_failed_capture_raises(monkeypatch):
    trainer = _graphed(_trainer(), monkeypatch, StandInBackend(fail=True))
    batch = _deepfm_batch()
    state = trainer.init_state(0, batch["features"])
    trainer.train_on_batch(state, batch)          # the eager first call
    with pytest.raises(RuntimeError, match="capture failed"):
        trainer.train_on_batch(state, batch)
    assert state.step == 1


def test_timed_steps_capture_before_the_timing(monkeypatch):
    """The timed run's warm-up is one eager step; the capture follows it
    outside the timed window, and the `iters` timed steps are replays;
    a second timing of that state captures nothing more."""
    backend = StandInBackend()
    trainer = _graphed(_trainer(), monkeypatch, backend)
    batch = _deepfm_batch()
    state = trainer.init_state(0, batch["features"])
    captures = []
    real = trainer._timed_fused

    def timed(state, staged, iters):
        captures.append((iters, backend.captures))
        return real(state, staged, iters)

    monkeypatch.setattr(trainer, "_timed_fused", timed)
    assert trainer.timed_steps_per_sec(state, batch, iters=5) > 0
    assert captures == [(1, 0), (5, 1)]
    assert backend.replays == 5 and state.step == 6
    trainer.timed_steps_per_sec(state, batch, iters=3)
    assert backend.captures == 1 and backend.replays == 8
    assert state.step == 9
    # a profiled step captures ahead the same way
    assert trainer.capture_step(state, batch) is False   # no eager call yet
    trainer.train_on_batch(state, batch)
    assert trainer.capture_step(state, batch) is True
    assert backend.captures == 2 and state.step == 10


def test_a_new_pool_once_the_last_pools_graphs_are_gone(monkeypatch):
    """The CUDA backend captures every live graph of a trainer into one
    pool; once they have all died PyTorch releases that pool, so the
    next capture takes a new handle."""
    handles = iter(range(10))
    pools = []

    class Graph:
        def replay(self):
            pass

    @contextlib.contextmanager
    def graph(g, pool, capture_error_mode):
        assert capture_error_mode == "thread_local"
        pools.append(pool)
        yield

    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: next(handles))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    backend = graphs_lib.CudaGraphBackend(torch.device("cpu"))
    first = backend.capture(lambda: 1)
    second = backend.capture(lambda: 2)
    assert pools == [0, 0] and second() == 2
    del first, second
    assert backend.capture(lambda: 3)() == 3
    assert pools == [0, 0, 1]


def test_graph_ok_names_where_graphs_run():
    trainer = _trainer()
    batch = port_trainer._to_device(_deepfm_batch(), torch.device("cpu"))
    state = trainer.init_state(0, batch["features"])
    assert not trainer.graph_ok(state, [batch])   # the CPU
    trainer.device = torch.device("cuda")
    # a CUDA trainer over CPU tensors, a fake state, or graphs off
    assert not trainer.graph_ok(state, [batch])
    assert not trainer.graph_ok(trainer.abstract_state("cpu"), [batch])
    with graphs_lib.eager_loop():
        assert graphs_lib.in_eager_loop()
        with graphs_lib.eager_loop():
            assert graphs_lib.in_eager_loop()
        assert graphs_lib.in_eager_loop()
        assert not trainer.graph_ok(state, [batch])
    assert not graphs_lib.in_eager_loop()


def test_a_graph_holds_only_an_optimizer_with_device_step_counts():
    """A plain Adam keeps its step count on the host, and a graph would
    bake in the captured step's bias corrections: `graph_ok` refuses it.
    An optimizer without a step count (SGD) or a capturable one passes."""
    p = torch.nn.Parameter(torch.ones(3))
    assert not graphs_lib.graphs_ok_for(torch.optim.Adam([p]))
    assert graphs_lib.graphs_ok_for(torch.optim.SGD([p], lr=0.1,
                                                    momentum=0.9))
    assert graphs_lib.graphs_ok_for(
        graphs_lib.capturable_adam(torch.optim.AdamW([p])))
    sgd = torch.optim.SGD([p], lr=0.1)
    assert graphs_lib.capturable_adam(sgd) is sgd


# ---- prewarm ---------------------------------------------------------------


def test_prewarm_records_the_compile_and_logs_the_line(registry, built,
                                                       trainer_log):
    trainer = _trainer()
    batch = _deepfm_batch(n=128)
    trainer.prewarm_for_device_counts(batch, [2, 1], block=True)
    lines = [line for line in trainer_log if "prewarmed train step" in line]
    assert len(lines) == 2
    assert lines[0].startswith("prewarmed train step for 2-rank world in ")
    assert lines[0].endswith("(library cache populated)")
    rec = registry.ledger()["worker_train_step"]
    assert rec["compiles"] == rec["signatures"] == 2
    assert rec["abstract"] is True
    # the last one compiled: one rank's 128 rows
    assert "int32[128,26]" in rec["avals"]
    # the trainer at the prewarmed world's rows trains, and records no
    # second compile of that signature
    half = {"features": {k: v[:64] for k, v in batch["features"].items()},
            "labels": batch["labels"][:64]}
    state = trainer.init_state(0, half["features"])
    trainer.train_on_batch(state, half)
    assert registry.ledger()["worker_train_step"]["compiles"] == 2
    assert state.step == 1


def test_prewarm_skips_impossible_world_sizes_quietly(registry, built):
    trainer = _trainer()
    trainer.prewarm_for_device_counts(_deepfm_batch(), [0, -3, 999],
                                      block=True)
    assert "worker_train_step" not in registry.ledger() or \
        registry.ledger()["worker_train_step"]["compiles"] == 0


def test_background_prewarm_does_not_disturb_training(monkeypatch,
                                                      registry, built):
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    trainer = _trainer()
    batch = _deepfm_batch(n=48)          # rows no prewarmed world has
    state = trainer.init_state(0, batch["features"])
    thread = trainer.prewarm_for_device_counts(_deepfm_batch(n=128), [2, 4])
    for _ in range(3):
        trainer.train_on_batch(state, batch)
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert state.step == 3
    assert registry.ledger()["worker_train_step"]["signatures"] == 3


def test_a_starved_host_skips_the_background_prewarm(monkeypatch,
                                                     trainer_log):
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    monkeypatch.delenv("ELASTICDL_FORCE_PREWARM", raising=False)
    assert _trainer().prewarm_for_device_counts(_deepfm_batch(), [1]) is None
    assert any("prewarm skipped" in line for line in trainer_log)

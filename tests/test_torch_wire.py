"""The port's wire formats (elasticdl_tpu_torch/data/wire.py) against the
JAX package's data/wire.py, on the CPU, from numpy-seeded inputs:

- every host packer gives byte-identical planes, bounds errors included;
- every device unpacker on those planes gives the JAX unpacker's ids;
- the bf16 pack equals ml_dtypes' cast bit for bit (the port itself does
  not import ml_dtypes);
- the trainer moves the planes at their wire width (the bytes it copies
  equal the planes' own bytes);
- the zoo's compact and dedup feeds equal the JAX zoo's byte for byte,
  and give the same model inputs and predictions as each other;
- a dedup tail batch is refused by both packages, and a missing feed
  downgrades the wire format with the JAX package's warning.

All comparisons are exact: the wire formats are integer paths.
"""

import logging
import sys
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from elasticdl_tpu.common import model_handler as jax_handler
from elasticdl_tpu.data import wire as jax_wire
from elasticdl_tpu.parallel.mesh import pad_to_multiple as jax_pad
from elasticdl_tpu_torch.common import metrics as port_metrics
from elasticdl_tpu_torch.common import model_handler as port_handler
from elasticdl_tpu_torch.data import wire as port_wire
from elasticdl_tpu_torch.model_zoo.deepfm import data as port_data
from elasticdl_tpu_torch.model_zoo.deepfm import (
    deepfm_functional_api as port_fm,
)
from elasticdl_tpu_torch.worker import trainer as port_trainer
from elasticdl_tpu_torch.worker.task_data_service import pad_to_multiple
from model_zoo.deepfm import deepfm_functional_api as jax_fm

torch.set_num_threads(2)

CPU = torch.device("cpu")
VOCAB = 4096


def _planes(packed):
    """A packer's output as {name: tensor} at wire width on the CPU."""
    if isinstance(packed, dict):
        return {k: port_wire.plane_tensor(v, CPU) for k, v in packed.items()}
    return port_wire.plane_tensor(packed, CPU)


def _assert_planes_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


def _zipf_rows(batch, fields, seed, a=1.3, vocab=VOCAB):
    rng = np.random.RandomState(seed)
    return (rng.zipf(a, (batch, fields)) % vocab).astype(np.int32)


# ---- uint24 and b22 -------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 26), (5, 3, 7), (1, 1)])
def test_uint24_packs_and_unpacks_like_jax(shape):
    rng = np.random.RandomState(len(shape))
    ids = rng.randint(0, 1 << 24, shape).astype(np.int32)
    ids.reshape(-1)[:1] = port_wire.UINT24_MAX
    got = port_wire.pack_int_to_uint24(ids)
    want = jax_wire.pack_int_to_uint24(ids)
    assert got.dtype == want.dtype == np.uint8 and got.shape == shape + (3,)
    assert got.tobytes() == want.tobytes()
    assert port_wire.is_packed_uint24(got) == jax_wire.is_packed_uint24(
        want) == (len(shape) >= 1)
    decoded = port_wire.unpack_uint24(_planes(got))
    assert decoded.dtype == torch.int32
    np.testing.assert_array_equal(decoded.numpy(),
                                  np.asarray(jax_wire.unpack_uint24(want)))
    np.testing.assert_array_equal(decoded.numpy(), ids)


@pytest.mark.parametrize("bad", [-1, 1 << 24])
def test_uint24_bounds_raise_like_jax(bad):
    ids = np.array([[0, bad]], np.int64)
    for pack in (port_wire.pack_int_to_uint24, jax_wire.pack_int_to_uint24):
        with pytest.raises(ValueError, match="uint24 packing needs ids"):
            pack(ids)


@pytest.mark.parametrize("fields", [1, 4, 26, 27])
def test_b22_packs_and_unpacks_like_jax(fields):
    rng = np.random.RandomState(fields)
    ids = rng.randint(0, 1 << 22, (33, fields)).astype(np.int32)
    ids[0, 0], ids[1, -1] = port_wire.B22_MAX, 0
    got = port_wire.pack_int_to_b22(ids)
    want = jax_wire.pack_int_to_b22(ids)
    _assert_planes_equal(got, want)
    assert port_wire.is_packed_b22(got) and jax_wire.is_packed_b22(want)
    planes = _planes(got)
    assert planes["lo16"].dtype == torch.int16     # uint16 at wire width
    decoded = port_wire.unpack_b22(planes)
    np.testing.assert_array_equal(decoded.numpy(),
                                  np.asarray(jax_wire.unpack_b22(want)))
    np.testing.assert_array_equal(decoded.numpy(), ids)


@pytest.mark.parametrize("ids,match", [
    (np.zeros((2, 3, 4), np.int32), r"b22 packing needs \(B, F\)"),
    (np.array([[0, -1]]), "b22 packing needs ids"),
    (np.array([[0, 1 << 22]]), "b22 packing needs ids"),
])
def test_b22_errors_match_jax(ids, match):
    for pack in (port_wire.pack_int_to_b22, jax_wire.pack_int_to_b22):
        with pytest.raises(ValueError, match=match):
            pack(ids)


# ---- dedup ----------------------------------------------------------------


@pytest.mark.parametrize("pads", [(0, 0), (40000, 30000), (40000, 0),
                                  (0, 30000)])
def test_dedup_packs_like_jax_and_escapes_are_used(pads):
    rows = _zipf_rows(3000, 26, seed=1)
    got = port_wire.pack_rows_dedup(rows, *pads)
    want = jax_wire.pack_rows_dedup(rows, *pads)
    _assert_planes_equal(got, want)
    assert port_wire.is_packed_dedup(got) and jax_wire.is_packed_dedup(want)
    # the zipf(1.3) stream over 4096 rows has cold ids: escapes are used
    escapes = int((got["inverse8"] == port_wire.DEDUP_ESCAPE).sum())
    assert escapes > 1000
    assert len(got["exc_val"]) == (pads[1] or escapes)
    assert port_wire.dedup_wire_bytes(got) == jax_wire.dedup_wire_bytes(want)


def test_dedup_pad_overflow_raises_like_jax():
    rows = _zipf_rows(2000, 4, seed=2)
    exact = port_wire.pack_rows_dedup(rows)
    n_unique, n_exc = len(exact["unique"]), len(exact["exc_val"])
    assert n_exc > 0
    for pad in (port_wire.pad_dedup, jax_wire.pad_dedup):
        with pytest.raises(ValueError, match="exceed unique_pad"):
            pad(exact, n_unique - 1, 0)
        with pytest.raises(ValueError, match="exceed exc_pad"):
            pad(exact, 0, n_exc - 1)


@pytest.mark.parametrize("case", ["exact", "padded", "no_escapes",
                                  "wide_exc_val", "one_field"])
def test_dedup_unpack_matches_jax(case):
    if case == "no_escapes":
        rows = np.random.RandomState(3).randint(0, 200, (500, 26))
    elif case == "wide_exc_val":
        # B > 65536: exc_val ships as uint32 (an int32 view on the wire)
        rows = np.random.RandomState(4).randint(0, 1 << 20, (65540, 2))
    elif case == "one_field":
        rows = _zipf_rows(2000, 1, seed=5)
    else:
        rows = _zipf_rows(1000, 26, seed=6)
    pads = (20000, 40000) if case == "padded" else (0, 0)
    packed = port_wire.pack_rows_dedup(rows.astype(np.int32), *pads)
    if case == "no_escapes":
        assert packed["exc_val"].shape == (0,)
    if case == "wide_exc_val":
        assert packed["exc_val"].dtype == np.uint32
    planes = _planes(packed)
    assert planes["unique"].dtype == torch.int32
    got = port_wire.unpack_rows_dedup(planes)
    assert got.dtype == torch.int32
    want = np.asarray(jax_wire.unpack_rows_dedup(
        jax_wire.pack_rows_dedup(rows.astype(np.int32), *pads)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), rows)


def test_dedup_packer_sticky_caps_match_jax_over_a_growing_sequence():
    port_packer = port_wire.DedupPacker(quantum=256, headroom=1.25)
    jax_packer = jax_wire.DedupPacker(quantum=256, headroom=1.25)
    caps = []
    for i, (batch, vocab) in enumerate([(200, 300), (400, 1000),
                                        (400, 100), (800, 4096),
                                        (100, 50)]):
        rows = _zipf_rows(batch, 26, seed=10 + i, vocab=vocab)
        got, want = port_packer.pack(rows), jax_packer.pack(rows)
        _assert_planes_equal(got, want)
        for attr in ("unique_cap", "exc_cap", "last_unique",
                     "last_exceptions"):
            assert getattr(port_packer, attr) == getattr(jax_packer, attr)
        np.testing.assert_array_equal(port_wire.unpack_rows_dedup(
            _planes(got)).numpy(), rows)
        caps.append((port_packer.unique_cap, port_packer.exc_cap))
    # caps grow and never shrink
    assert caps == sorted(caps) and caps[0] < caps[-1]


@pytest.mark.parametrize("values", [
    np.array([5, 3, 5, 9, 3, 5, 0], np.int64),
    np.random.RandomState(7).zipf(1.2, 5000) % 10000,
    np.array([3, 1 << 40, 3, 7], np.int64),           # the np.unique path
    np.array([], np.int64),
])
def test_frequency_rank_matches_jax(values):
    got = port_wire.frequency_rank(values)
    want = jax_wire.frequency_rank(values)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_frequency_rank_rejects_negatives_like_jax():
    for rank in (port_wire.frequency_rank, jax_wire.frequency_rank):
        with pytest.raises(ValueError, match="non-negative"):
            rank(np.array([1, -1]))


def test_merged_ranking_matches_jax_and_frequency_rank():
    rows = _zipf_rows(2000, 26, seed=8)
    _, got = port_wire.pack_rows_dedup(rows, return_ranking=True)
    _, want = jax_wire.pack_rows_dedup(rows, return_ranking=True)
    direct = port_wire.frequency_rank(rows.reshape(-1))
    for g, w, d in zip(got, want, direct):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, d)


def test_field_disjoint_ids_match_jax():
    sparse = np.random.RandomState(9).randint(0, 1 << 30, (50, 26))
    np.testing.assert_array_equal(port_wire.field_disjoint_ids(sparse),
                                  jax_wire.field_disjoint_ids(sparse))
    for fn in (port_wire.field_disjoint_ids, jax_wire.field_disjoint_ids):
        with pytest.raises(ValueError, match=r"expected \(B, F\)"):
            fn(np.zeros(4))
        with pytest.raises(ValueError, match="overflow"):
            fn(np.array([[np.iinfo(np.int64).max // 2, 0]]))


@pytest.mark.parametrize("obj", [
    {"lo16": 0, "hi6": 0}, {"lo16": 0}, {"unique": 0, "starts": 0,
                                         "inverse8": 0, "exc_val": 0},
    np.zeros((4, 26, 3), np.uint8), np.zeros((4, 3), np.uint8),
    np.zeros((4, 26, 3), np.int32), np.zeros(3, np.uint8),
])
def test_is_packed_predicates_match_jax(obj):
    assert port_wire.is_packed_b22(obj) == jax_wire.is_packed_b22(obj)
    assert port_wire.is_packed_uint24(obj) == jax_wire.is_packed_uint24(obj)
    assert port_wire.is_packed_dedup(obj) == jax_wire.is_packed_dedup(obj)


# ---- bf16 without ml_dtypes -------------------------------------------------


def _bits_f32(bits):
    return np.array(bits, np.uint32).view(np.float32)


@pytest.mark.parametrize("case", ["random", "wide_range", "specials",
                                  "ties", "subnormals", "nan_payloads"])
def test_bf16_pack_equals_ml_dtypes_bit_for_bit(case):
    rng = np.random.RandomState(11)
    x = {
        "random": rng.randn(100000).astype(np.float32),
        "wide_range": (rng.randn(100000) * np.exp(rng.randn(100000) * 20)
                       ).astype(np.float32),
        "specials": np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                              np.finfo(np.float32).max,
                              -np.finfo(np.float32).max], np.float32),
        # halfway between two bf16 values: round to the even one
        "ties": _bits_f32([0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000,
                           0x00008000, 0x00018000, 0x7F7F8000]),
        "subnormals": _bits_f32(rng.randint(1, 0x800000, 10000)
                                | (rng.randint(0, 2, 10000) << 31)),
        "nan_payloads": _bits_f32([0x7F800001, 0x7FC00001, 0xFF800001,
                                   0x7FFFFFFF, 0xFFFFFFFF]),
    }[case]
    got = port_wire.pack_f32_to_bf16(x)
    assert isinstance(got, port_wire.BF16Bits) and got.dtype == np.uint16
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(got.view(np.uint16), want)
    np.testing.assert_array_equal(
        got.view(np.uint16),
        jax_wire.pack_f32_to_bf16(x).view(np.uint16))
    tensor = port_wire.plane_tensor(got, CPU)
    assert tensor.dtype == torch.bfloat16 and tuple(tensor.shape) == x.shape
    finite = ~np.isnan(x)
    # the same values torch's own cast gives
    assert torch.equal(tensor[torch.from_numpy(finite)],
                       torch.from_numpy(x[finite]).to(torch.bfloat16))


def test_the_bf16_mark_survives_slicing_and_padding():
    bits = port_wire.pack_f32_to_bf16(np.arange(12, dtype=np.float32)
                                      .reshape(6, 2))
    assert isinstance(bits[:3], port_wire.BF16Bits)
    padded, real = pad_to_multiple({"dense": bits[:5]}, 4)
    assert real == 5 and isinstance(padded["dense"], port_wire.BF16Bits)
    np.testing.assert_array_equal(
        port_wire.plane_tensor(padded["dense"], CPU).float().numpy(),
        np.concatenate([np.arange(10), np.arange(6)]).reshape(8, 2))


# ---- bytes on the link ------------------------------------------------------


def _records_buffer(n, seed=0):
    dense, sparse, labels = port_data.synthetic_criteo(n, seed=seed)
    rows = port_data.record_rows(dense, sparse, labels)
    return rows.tobytes(), np.full(n, port_fm.RECORD_BYTES, np.int64)


def _flat_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat_leaves(v)]
    return [tree]


@pytest.mark.parametrize("fmt,per_example", [("compact", 99),
                                             ("dedup", None),
                                             ("plain", 160)])
def test_stage_batch_moves_the_planes_at_wire_width(fmt, per_example,
                                                    monkeypatch):
    monkeypatch.setattr(port_fm, "_DEDUP_PACKER", port_wire.DedupPacker())
    monkeypatch.setattr(port_fm, "DEDUP_VOCAB_CAPACITY", VOCAB)
    feed = {"plain": port_fm.feed_bulk, "compact": port_fm.feed_bulk_compact,
            "dedup": port_fm.feed_bulk_dedup}[fmt]
    batch = feed(*_records_buffer(256))
    spec = port_handler.get_model_spec(
        port_handler.ZOO_DIR, "deepfm.deepfm_functional_api.custom_model",
        model_params=f"vocab_capacity={VOCAB};embed_dim=4")
    trainer = port_trainer.Trainer(spec.model, spec.optimizer, spec.loss,
                                   device="cpu")
    staged = trainer.stage_batch(batch)
    host, device = _flat_leaves(batch), _flat_leaves(staged)
    # no plane is widened on the host: each tensor has its plane's bytes
    for h, d in zip(host, device):
        assert d.element_size() == h.itemsize and d.numel() == h.size
    moved = sum(d.numel() * d.element_size() for d in device)
    assert moved == sum(h.nbytes for h in host)
    if fmt == "dedup":
        sparse = batch["features"]["sparse"]
        assert moved == port_wire.dedup_wire_bytes(sparse) + 256 * (26 + 1)
        assert staged["features"]["dense"].dtype == torch.bfloat16
    else:
        assert moved == 256 * per_example
    state = trainer.init_state(0, staged["features"])
    state, loss = trainer.train_on_batch(state, staged)
    assert torch.isfinite(loss)


def test_pack_counters_count_bytes_and_rows():
    registry = port_metrics.default_registry()
    snap = registry.snapshot()
    before = (snap["data_wire_pack_bytes_total"],
              snap["data_wire_examples_rows"])
    packed = port_wire.DedupPacker().pack(_zipf_rows(300, 26, seed=12))
    snap = registry.snapshot()
    assert snap["data_wire_pack_bytes_total"] - before[0] == \
        port_wire.dedup_wire_bytes(packed)
    assert snap["data_wire_examples_rows"] - before[1] == 300


def test_shared_dedup_packer_under_two_threads_round_trips_every_batch():
    """Two threads pack through one packer with a tiny switch interval;
    every batch fits the caps it was padded to and decodes to its rows,
    and the caps end at least as large as either thread ever needed."""
    packer = port_wire.DedupPacker(quantum=64, headroom=1.0)
    errors, results = [], []
    lock = threading.Lock()

    def work(seed):
        for i in range(40):
            rows = _zipf_rows(50 + 20 * (i % 7), 26, seed=seed * 100 + i,
                              vocab=100 + 150 * i)
            packed = packer.pack(rows)
            decoded = port_wire.unpack_rows_dedup(_planes(packed)).numpy()
            with lock:
                results.append(np.array_equal(decoded, rows))
                if not np.array_equal(decoded, rows):
                    errors.append(seed)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(results) == 80 and all(results) and not errors
    assert packer.unique_cap >= packer.last_unique


# ---- the zoo's feeds --------------------------------------------------------


@pytest.fixture
def fresh_packers(monkeypatch):
    """Fresh sticky caps in both zoos and the test's vocab."""
    monkeypatch.setattr(port_fm, "_DEDUP_PACKER", port_wire.DedupPacker())
    monkeypatch.setattr(jax_fm, "_DEDUP_PACKER", None)
    monkeypatch.setattr(port_fm, "DEDUP_VOCAB_CAPACITY", VOCAB)
    monkeypatch.setattr(jax_fm, "DEDUP_VOCAB_CAPACITY", VOCAB)


@pytest.mark.parametrize("fmt", ["compact", "dedup"])
def test_zoo_feeds_match_jax_byte_for_byte(fmt, fresh_packers):
    name = f"feed_bulk_{fmt}"
    for seed in (0, 1):
        buffer, sizes = _records_buffer(300, seed=seed)
        got = getattr(port_fm, name)(buffer, sizes)
        want = getattr(jax_fm, name)(buffer, sizes)
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert got["labels"].dtype == want["labels"].dtype == np.uint8
        assert got["features"]["dense"].tobytes() == \
            want["features"]["dense"].tobytes()
        _assert_planes_equal(got["features"]["sparse"],
                             want["features"]["sparse"])


def test_dedup_feed_matches_compact_feed_bit_for_bit(fresh_packers):
    """The same records through both feeds: the same bf16 dense, the same
    table rows (the host hash equals the device hash), so the port's
    predictions agree bit for bit."""
    buffer, sizes = _records_buffer(512, seed=5)
    model = port_fm.custom_model(vocab_capacity=VOCAB, embed_dim=4)
    compact = port_trainer._to_device(port_fm.feed_bulk_compact(
        buffer, sizes)["features"], CPU)
    dedup = port_trainer._to_device(port_fm.feed_bulk_dedup(
        buffer, sizes)["features"], CPU)
    assert torch.equal(compact["dense"], dedup["dense"])
    rows_c, pre_c = port_fm.sparse_field_rows(compact, VOCAB)
    rows_d, pre_d = port_fm.sparse_field_rows(dedup, VOCAB)
    assert (pre_c, pre_d) == (False, True)
    np.testing.assert_array_equal(
        rows_d.numpy(),
        port_fm.hash_field_rows_host(
            port_fm.sparse_ids(compact).numpy(), VOCAB))
    with torch.no_grad():
        assert torch.equal(model(compact), model(dedup))


# ---- ragged batches and the wire-format fallback ----------------------------


def test_a_dedup_tail_is_refused_by_both_packages():
    """A dedup batch has four leading sizes, so wrap-padding a tail
    cannot work: the JAX package asserts, the port raises ValueError."""
    packed = port_wire.DedupPacker().pack(_zipf_rows(100, 26, seed=13))
    batch = {"features": {"dense": np.zeros((100, 13), np.float32),
                          "sparse": packed},
             "labels": np.zeros(100, np.uint8)}
    with pytest.raises(AssertionError, match="ragged batch"):
        jax_pad(batch, 128)
    with pytest.raises(ValueError, match="ragged batch"):
        pad_to_multiple(batch, 128)


def _spec(compact=True, dedup=True):
    feed = port_fm.feed_bulk
    return port_handler.ModelSpec(
        model=None, loss=None, optimizer=None, feed=None, feed_bulk=feed,
        feed_bulk_compact=feed if compact else None,
        feed_bulk_dedup=feed if dedup else None)


@pytest.mark.parametrize("wire_format,compact_wire,feeds,want,warns", [
    ("dedup", False, (True, True), "dedup", 0),
    ("dedup", False, (True, False), "compact", 1),
    ("dedup", False, (False, False), "plain", 1),
    ("compact", False, (False, False), "plain", 1),
    ("", True, (True, False), "compact", 0),
    ("", True, (False, False), "plain", 1),
    ("plain", True, (True, True), "plain", 0),
    (" Dedup ", False, (True, True), "dedup", 0),
])
def test_wire_format_resolution_and_fallback_match_jax(
        wire_format, compact_wire, feeds, want, warns, caplog):
    port_spec = _spec(*feeds)
    jax_spec = jax_handler.ModelSpec(**{
        k: getattr(port_spec, k) for k in (
            "model", "loss", "optimizer", "feed", "feed_bulk",
            "feed_bulk_compact", "feed_bulk_dedup")})
    logs = []
    for resolve, spec, name in (
            (port_handler.resolve_wire_format, port_spec, "port"),
            (jax_handler.resolve_wire_format, jax_spec, "jax")):
        log = logging.getLogger(f"test_wire.{name}")
        with caplog.at_level(logging.WARNING, logger=log.name):
            caplog.clear()
            assert resolve(spec, wire_format, compact_wire, log) == want
            logs.append([r.getMessage() for r in caplog.records])
    assert logs[0] == logs[1] and len(logs[0]) == warns


def test_unknown_wire_format_raises_like_jax():
    for resolve in (port_handler.resolve_wire_format,
                    jax_handler.resolve_wire_format):
        with pytest.raises(ValueError, match="unknown wire format"):
            resolve(_spec(), "zstd", False)

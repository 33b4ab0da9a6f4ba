"""The port's CheckpointSaver (elasticdl_tpu_torch/common/save_utils.py)
and state snapshots (worker/sync.py) on DeepFM at a small size on the
CPU: a bitwise round trip of parameters, Adam moments and step;
keep-last-K rotation with a pinned step; the manifest check and the
fall-back past a corrupt step; the `produced` stamp under a fake clock;
an asynchronous save that captures step N while step N+1 runs; and a
snapshot that stays put while training goes on."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from elasticdl_tpu_torch.common import save_utils
from elasticdl_tpu_torch.common.model_handler import ZOO_DIR, get_model_spec
from elasticdl_tpu_torch.model_zoo.deepfm.data import synthetic_criteo
from elasticdl_tpu_torch.worker.sync import ModelOwner, snapshot_state
from elasticdl_tpu_torch.worker.trainer import Trainer

torch.set_num_threads(2)

MODEL = "deepfm.deepfm_functional_api.custom_model"
PARAMS = "vocab_capacity=1024;embed_dim=8;lr=0.005"
BATCH = 32


def _batches(n, seed=0):
    dense, sparse, labels = synthetic_criteo(n * BATCH, seed=seed)
    return [{"features": {"dense": dense[i * BATCH:(i + 1) * BATCH],
                          "sparse": sparse[i * BATCH:(i + 1) * BATCH]},
             "labels": labels[i * BATCH:(i + 1) * BATCH].astype(np.int32)}
            for i in range(n)]


def _trainer():
    spec = get_model_spec(ZOO_DIR, MODEL, PARAMS)
    return Trainer(spec.model, spec.optimizer, spec.loss, device="cpu")


def _trained(trainer, steps, seed=0):
    batches = _batches(steps, seed)
    state = trainer.init_state(0, batches[0]["features"])
    for b in batches:
        state, _ = trainer.train_on_batch(state, b)
    return state


def _assert_states_equal(a, b):
    assert a.step == b.step
    for (name, pa), pb in zip(a.model.state_dict().items(),
                              b.model.state_dict().values()):
        assert torch.equal(pa, pb), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for key, moments in sa["state"].items():
        for name, value in moments.items():
            assert torch.equal(value, sb["state"][key][name]), (key, name)


def test_round_trip_is_bitwise(tmp_path):
    trainer = _trainer()
    state = _trained(trainer, 3)
    saver = save_utils.CheckpointSaver(str(tmp_path))
    assert saver.save(state)
    assert not saver.save(state)            # that step is being saved
    saver.wait_until_finished()
    assert not saver.save(state)            # and now is saved
    assert saver.all_steps() == [3] and saver.verify_step(3)
    fresh = trainer.init_state(1, _batches(1)[0]["features"])
    restored = saver.maybe_restore(fresh)
    assert restored is fresh
    _assert_states_equal(restored, state)
    # restore_step builds a separate state and leaves the template
    other = saver.restore_step(3, trainer.init_state(
        2, _batches(1)[0]["features"]))
    _assert_states_equal(other, state)
    assert saver.restore_step(4, state) is None
    # and training goes on from the restored moments as from the original
    b = _batches(1, seed=9)[0]
    state, l1 = trainer.train_on_batch(state, b)
    restored, l2 = trainer.train_on_batch(restored, b)
    assert torch.equal(l1, l2)
    _assert_states_equal(restored, state)
    saver.close()


def test_keep_last_k_rotation_keeps_a_pinned_step(tmp_path):
    trainer = _trainer()
    batches = _batches(6)
    state = trainer.init_state(0, batches[0]["features"])
    saver = save_utils.CheckpointSaver(str(tmp_path), keep_max=2)
    save_utils.pin_step(str(tmp_path), 1)
    try:
        for b in batches:
            state, _ = trainer.train_on_batch(state, b)
            saver.save(state)
            saver.wait_until_finished()
        assert saver.all_steps() == [1, 5, 6]
        assert sorted(os.listdir(tmp_path / ".manifests")) == [
            "1.json", "5.json", "6.json"]
    finally:
        save_utils.unpin_step(str(tmp_path), 1)
    assert save_utils.pinned_steps(str(tmp_path)) == frozenset()
    state, _ = trainer.train_on_batch(state, batches[0])
    saver.save(state)
    saver.close()
    assert saver.all_steps() == [6, 7]


def test_corrupt_step_fails_verify_and_restore_falls_back(tmp_path):
    trainer = _trainer()
    batches = _batches(2)
    state = trainer.init_state(0, batches[0]["features"])
    saver = save_utils.CheckpointSaver(str(tmp_path))
    state, _ = trainer.train_on_batch(state, batches[0])
    saver.save(state)
    at_one = save_utils.host_state(state)
    state, _ = trainer.train_on_batch(state, batches[1])
    saver.save(state)
    saver.wait_until_finished()
    path = tmp_path / "2" / save_utils.STATE_FILE
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    assert saver.verify_step(1) and not saver.verify_step(2)
    fresh = trainer.init_state(5, batches[0]["features"])
    restored = saver.maybe_restore(fresh)
    assert restored.step == 1
    for name, value in restored.model.state_dict().items():
        assert torch.equal(value, at_one["model"][name]), name
    assert saver.restore_step(2, fresh) is None
    # a torn save (no state.pt in place) is not a step
    os.makedirs(tmp_path / "3")
    (tmp_path / "3" / (save_utils.STATE_FILE + ".tmp")).write_bytes(b"x")
    assert saver.all_steps() == [1, 2]


def test_manifest_produced_stamps_under_a_fake_clock(tmp_path):
    trainer = _trainer()
    state = _trained(trainer, 2)
    ticks = iter([1234.5, 2000.25])
    saver = save_utils.CheckpointSaver(str(tmp_path),
                                       clock=lambda: next(ticks))
    saver.save(state)
    state, _ = trainer.train_on_batch(state, _batches(1)[0])
    saver.save(state)
    saver.wait_until_finished()
    assert saver.produced_meta(2) == {"model_step": 2,
                                      "produced_unix_s": 1234.5}
    assert save_utils.read_produced_meta(str(tmp_path), 3) == {
        "model_step": 3, "produced_unix_s": 2000.25}
    with open(tmp_path / ".manifests" / "3.json") as f:
        manifest = json.load(f)
    assert set(manifest["files"]) == {save_utils.STATE_FILE}
    assert manifest["files"][save_utils.STATE_FILE]["size"] == os.path.getsize(
        tmp_path / "3" / save_utils.STATE_FILE)


def test_async_save_captures_step_n_while_step_n_plus_1_runs(
        tmp_path, monkeypatch):
    """The writer is held until the next optimizer step has rewritten the
    live parameters and moments in place; the file must still hold step
    N."""
    trainer = _trainer()
    state = _trained(trainer, 2)
    want = save_utils.host_state(state)
    release = threading.Event()
    real_save = torch.save

    def held_save(obj, path):
        assert release.wait(timeout=60)
        real_save(obj, path)

    monkeypatch.setattr(save_utils.torch, "save", held_save)
    saver = save_utils.CheckpointSaver(str(tmp_path))
    saver.save(state)
    state, _ = trainer.train_on_batch(state, _batches(1, seed=4)[0])
    moved = state.model.state_dict()["fm_embedding.embedding"]
    assert not torch.equal(moved, want["model"]["fm_embedding.embedding"])
    release.set()
    saver.wait_until_finished()
    restored = saver.restore_step(2, state)
    assert restored.step == 2
    for name, value in restored.model.state_dict().items():
        assert torch.equal(value, want["model"][name]), name
    for key, moments in restored.optimizer.state_dict()["state"].items():
        for name, value in moments.items():
            assert torch.equal(value, want["optimizer"]["state"][key][name])


def test_snapshot_stays_put_while_training_goes_on():
    trainer = _trainer()
    owner = ModelOwner(trainer)
    batches = _batches(4)
    for b in batches[:2]:
        owner.train_batch(b)
    snap = owner.snapshot()
    held = batches[3]["features"]
    before = trainer.predict_on_batch(snap, held)
    assert np.array_equal(before, owner.predict_batch(batches[3]))
    owner.train_batch(batches[2])
    assert owner.step == 3 and snap.step == 2
    assert np.array_equal(trainer.predict_on_batch(snap, held), before)
    assert not np.array_equal(owner.predict_batch(batches[3]), before)
    assert snap.optimizer is None and snapshot_state(None) is None


def test_eval_at_version_restores_a_separate_state(tmp_path):
    trainer = _trainer()
    saver = save_utils.CheckpointSaver(str(tmp_path))
    owner = ModelOwner(trainer, checkpoint_saver=saver, checkpoint_steps=2)
    batches = _batches(3)
    for b in batches:
        owner.train_batch(b)
    saver.wait_until_finished()
    assert saver.all_steps() == [2]
    held = batches[0]["features"]
    state, version = owner.state_for_eval(2)
    assert version == 2 and state is not owner.state
    assert state.step == 2 and owner.step == 3
    current, version = owner.state_for_eval(7)    # not retrievable
    assert version == 3
    assert np.array_equal(trainer.predict_on_batch(current, held),
                          owner.predict_batch(batches[0]))
    assert not np.array_equal(trainer.predict_on_batch(state, held),
                              owner.predict_batch(batches[0]))


def test_a_failed_restore_installs_no_state_and_the_retry_restores(
        tmp_path, monkeypatch):
    """A restore that raises leaves the owner without a state, so the
    next call restores again instead of training on from the random
    init."""
    trainer = _trainer()
    saved = _trained(trainer, 3)
    saver = save_utils.CheckpointSaver(str(tmp_path))
    saver.save(saved)
    saver.wait_until_finished()
    real_restore = saver.maybe_restore
    calls = []

    def restore_failing_once(state, **kwargs):
        calls.append(state)
        if len(calls) == 1:
            raise OSError("checkpoint read failed")
        return real_restore(state, **kwargs)

    monkeypatch.setattr(saver, "maybe_restore", restore_failing_once)
    owner = ModelOwner(trainer, checkpoint_saver=saver)
    batch = _batches(1, seed=9)[0]
    with pytest.raises(OSError, match="read failed"):
        owner.train_batch(batch)
    assert owner.state is None and owner.step == 0
    loss = owner.train_batch(batch)
    assert len(calls) == 2 and owner.step == 4
    # the same step taken from the saved state itself
    want, want_loss = trainer.train_on_batch(saved, batch)
    assert torch.equal(loss, want_loss)
    _assert_states_equal(owner.state, want)
    saver.close()


def test_an_orbax_checkpoint_directory_raises(tmp_path):
    """An orbax step is listed beside the port's steps (the JAX
    package's TrainStates restore through it: tests/test_torch_orbax*.py).
    One whose stored tree is no TrainState raises on restore rather than
    letting the job train from scratch."""
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    mngr = ocp.CheckpointManager(
        str(tmp_path), options=ocp.CheckpointManagerOptions(
            enable_async_checkpointing=False))
    mngr.save(3, args=ocp.args.StandardSave({"a": jnp.ones(3)}))
    mngr.wait_until_finished()
    saver = save_utils.CheckpointSaver(str(tmp_path))
    assert saver.all_steps() == [3] and save_utils.port_steps(
        str(tmp_path)) == []
    assert save_utils.restorable_step(str(tmp_path)) is None
    with pytest.raises(ValueError, match="not a TrainState"):
        saver.maybe_restore(_trainer().init_state(0, _batches(1)[0][
            "features"]))
    saver.close()


def test_the_manifest_lands_before_the_state_file(tmp_path, monkeypatch):
    """A step is listed once its state.pt is in place; its manifest is
    there already, so a reader (the serving reloader) always verifies
    what it restores."""
    order = []
    real_replace = os.replace

    def recording_replace(src, dst):
        order.append(os.path.relpath(dst, str(tmp_path)))
        real_replace(src, dst)

    monkeypatch.setattr(save_utils.os, "replace", recording_replace)
    trainer = _trainer()
    state = _trained(trainer, 2)
    saver = save_utils.CheckpointSaver(str(tmp_path))
    saver.save(state)
    saver.close()
    assert order == [os.path.join(".manifests", "2.json"),
                     os.path.join("2", "state.pt")]
    assert saver.verify_step(2)


def test_restore_step_rebuilds_an_adamw_optimizer(tmp_path):
    """restore_step builds a fresh optimizer of the template's class from
    its settings; AdamW's `defaults` hold a key its constructor does not
    take (`decoupled_weight_decay`), which must not reach it."""
    spec = get_model_spec(
        ZOO_DIR, "bert.bert_finetune.custom_model",
        model_params="hidden=32;num_layers=1;heads=2;mlp_dim=64;"
                     "max_len=16;vocab_size=64;lr=0.001")
    trainer = Trainer(spec.model, spec.optimizer, spec.loss, device="cpu")
    rng = np.random.RandomState(0)
    batch = {"features": {"input_ids": rng.randint(
                 0, 64, (4, 16)).astype(np.int32)},
             "labels": rng.randint(0, 2, 4).astype(np.int32)}
    state = trainer.init_state(0, batch["features"])
    state, _ = trainer.train_on_batch(state, batch)
    assert isinstance(state.optimizer, torch.optim.AdamW)
    saver = save_utils.CheckpointSaver(str(tmp_path))
    saver.save(state)
    saver.wait_until_finished()
    restored = saver.restore_step(1, state)
    saver.close()
    assert isinstance(restored.optimizer, torch.optim.AdamW)
    assert restored.optimizer.defaults == state.optimizer.defaults
    _assert_states_equal(restored, state)

"""The port's click-stream MLP (elasticdl_tpu_torch/model_zoo/clickstream/
ctr_mlp.py) against the flax zoo's on the CPU: `encode` and `feed` bit
for bit on click dicts (the memory reader's records), the carried init,
the forward and a few Adam steps of the JAX Trainer."""

import jax
import numpy as np
import torch

from _torch_zoo_parity import carried_states, carry, step_gaps, trainers
from elasticdl_tpu_torch.data.reader import MemoryDataReader
from elasticdl_tpu_torch.model_zoo.clickstream import ctr_mlp as port
from elasticdl_tpu_torch.proto import messages as pb
from model_zoo.clickstream import ctr_mlp as jax_ctr

torch.set_num_threads(2)

MODEL = "clickstream.ctr_mlp.custom_model"
# logits from the same weights: measured 3.0e-8
FWD_TOL = 1e-6
# per-step losses over 5 Adam steps (lr 1e-2, batch 64): measured 6.6e-7
# at 0.58-0.68
LOSS_TOL = 1e-5


def _clicks(n, seed=0):
    rng = np.random.RandomState(seed)
    users = rng.randint(0, 1000, n)
    items = rng.randint(0, 500, n)
    clicked = ((users % 7) == (items % 7)).astype(np.int64)
    return MemoryDataReader({"user": users, "item": items,
                             "clicked": clicked})


def _records(n, seed=0, start=0):
    reader = _clicks(n + start, seed)
    return list(reader.read_records(
        pb.Task(shard=pb.Shard(name="memory", start=start, end=start + n))))


def test_encode_and_feed_match_bit_for_bit():
    records = _records(100, seed=1)
    want = jax_ctr.feed(records)
    got = port.feed(records)
    np.testing.assert_array_equal(got["features"], want["features"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    users = np.array([0, 63, 64, -1, 1 << 40])
    items = np.array([5, 64, 127, -3, 7])
    np.testing.assert_array_equal(port.encode(users, items),
                                  jax_ctr.encode(users, items))
    assert port.DIM == jax_ctr.DIM == 128


def test_forward_matches_flax():
    x = port.feed(_records(32))["features"]
    model = jax_ctr.custom_model()
    variables = model.init(jax.random.PRNGKey(0), x)
    ported = carry(port.custom_model(), variables["params"])
    np.testing.assert_allclose(
        ported(torch.from_numpy(x)).detach().numpy(),
        np.asarray(model.apply(variables, x)), atol=FWD_TOL)


def test_training_steps_match_the_jax_trainer():
    _, jt, _, pt = trainers(MODEL)
    batches = [port.feed(_records(64, seed=0, start=64 * i))
               for i in range(5)]
    jstate, pstate = carried_states(jt, pt, batches[0]["features"])
    gaps, losses, _, _ = step_gaps(jt, pt, jstate, pstate, batches)
    assert max(gaps) < LOSS_TOL, (gaps, losses)
    assert losses[-1] < losses[0]

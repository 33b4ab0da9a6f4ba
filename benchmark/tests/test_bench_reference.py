"""The plain references against the port's own models at tiny sizes on
the CPU, on the same weights: in float32 they agree to round-off, and
the control (one precision lower) does not."""

import json

import torch

from benchmark.entries.train import build_trainer, device_batch
from benchmark.harness import inputs, runner, spec
from benchmark.harness.weights import make_weights
from benchmark.reference import steps
from benchmark.reference.precision import CONTROL, REFERENCE
from benchmark.tests.tiny import tiny_bench

CPU = torch.device("cpu")


def _forward_pair(bench_dir, bench_json, cell_name, seed=2 ** 32 + 3):
    cell = spec.load_cell(cell_name, bench_dir, bench_json)
    ref_model, _ = spec.model_modules(cell)
    trainer = build_trainer(cell, CPU)
    model = trainer.model
    weights = make_weights(ref_model.param_spec(cell.config), seed, CPU)
    model.load_state_dict(weights, strict=True)
    batch = device_batch(inputs.training_pool(
        cell.config, cell.traffic, seed, CPU)[0], CPU)
    with torch.no_grad():
        program = trainer._forward(model, batch["features"], train=False)
        reference = steps.logits(ref_model, cell.config, weights,
                                 batch["features"], REFERENCE)
        control = steps.logits(ref_model, cell.config, weights,
                               batch["features"], CONTROL)
    return program.float().reshape(reference.shape), reference, control


def test_float32_forwards_agree_with_the_port(tmp_path):
    bench_dir, bench_json = tiny_bench(tmp_path, bf16=False)
    for cell in ("tiny.bert.train", "tiny.deepfm.train"):
        program, reference, control = _forward_pair(bench_dir, bench_json,
                                                    cell)
        scale = reference.abs().max()
        assert (program - reference).abs().max() <= 1e-5 * scale, cell
        # the control is one precision lower and reads a gap far wider
        assert (control - reference).abs().max() >= 1e-3 * scale, cell


def test_float32_training_steps_agree_with_the_port(tmp_path):
    bench_dir, bench_json = tiny_bench(tmp_path, bf16=False)
    for cell in ("tiny.bert.train", "tiny.deepfm.train"):
        out, rec = runner.run_cell(cell, 123456789012, 0.2, False, "cpu",
                                   bench_dir, bench_json)
        numbers = {k: v["value"] for k, v in rec.numbers.items()}
        assert numbers["loss_gap"] < 1e-6, (cell, numbers)
        assert numbers["grad_gap"] < 1e-5, (cell, numbers)
        assert numbers["change_gap"] < 1e-4, (cell, numbers)


def test_the_reference_imports_nothing_of_the_program():
    import ast
    for path in sorted((spec.BENCH_DIR / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in (
                    "elasticdl_tpu_torch", "elasticdl_tpu", "jax", "flax"), \
                    (path.name, name)


def test_configs_state_what_the_zoo_is_given():
    for path in (spec.BENCH_DIR / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        params = cfg["model_params"]
        assert params["lr"] == cfg["optimizer"]["lr"], path.name
        assert params["bf16"] == (cfg["compute_dtype"] == "bf16")

"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names."""

import ast
import subprocess
import sys
import textwrap

from benchmark.harness.isolation import forbidden_modules
from benchmark.harness.spec import BENCH_DIR

DRY_RUN = textwrap.dedent("""
    import sys, tempfile
    from pathlib import Path
    sys.path.insert(0, {root!r})
    import torch
    torch.set_num_threads(2)
    from benchmark.harness import runner
    from benchmark.harness.isolation import forbidden_modules
    from benchmark.tests.tiny import tiny_bench
    bench_dir, bench_json = tiny_bench(Path(tempfile.mkdtemp(dir={tmp!r})))
    for cell in ("tiny.bert.train", "tiny.deepfm.train", "tiny.bert.serve"):
        out, _ = runner.run_cell(cell, 9, 0.2, True, "cpu", bench_dir,
                                 bench_json)
        assert out["correct"], (cell, out["checks"])
    assert "elasticdl_tpu_torch" in sys.modules
    print("FORBIDDEN", forbidden_modules())
""")


def test_whole_names_are_compared():
    assert forbidden_modules(["elasticdl_tpu_torch",
                              "elasticdl_tpu_torch.worker", "jaxtyping",
                              "flaxen"]) == []
    assert forbidden_modules(["elasticdl_tpu.ops", "jaxlib.xla_client",
                              "jax", "flax.linen"]) == [
        "elasticdl_tpu", "flax", "jax", "jaxlib"]


def test_a_dry_run_of_every_entry_loads_no_jax(tmp_path):
    code = DRY_RUN.format(root=str(BENCH_DIR.parent), tmp=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout[-2000:]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sorted(BENCH_DIR.rglob("*.py")):
        if "tests" in path.relative_to(BENCH_DIR).parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            assert not forbidden_modules(names), (path, names)

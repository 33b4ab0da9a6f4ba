"""`--compilation_cache_dir` is the directory of the port's built
libraries (ops/_build.py `set_cache_dir`): the host scanner that a Local
job's index builds with g++ lands there, and a second process with the
same flag loads it without running the compiler; a hand kernel's
library (built here by a stand-in nvcc) lands there with its
`kernel_build_*` program, and a second process loads it and records
none.  The directory cannot move once a library has loaded, and an
empty flag keeps the default, `build/elasticdl_tpu_torch/`."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from elasticdl_tpu_torch.common import args as port_args
from elasticdl_tpu_torch.model_zoo.mnist.data import write_dataset
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.ops import scatter_add as sa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LOCAL_JOB = textwrap.dedent("""
    import json, sys
    from elasticdl_tpu_torch.client import main as cli
    from elasticdl_tpu_torch.common import programs
    from elasticdl_tpu_torch.ops import _build
    rc = cli.main(sys.argv[1:])
    print("RESULT " + json.dumps({
        "rc": rc, "cache_dir": str(_build.cache_dir()),
        "host": {k: str(v) for k, v in _build._HOST_PATHS.items()},
        "programs": sorted(programs.default_program_registry().ledger())}))
""")

_KERNEL_LOAD = textwrap.dedent("""
    import json, sys
    from elasticdl_tpu_torch.common import programs
    from elasticdl_tpu_torch.ops import _build
    _build.set_cache_dir(sys.argv[1])
    _build.load_library(sys.argv[2])
    print("RESULT " + json.dumps({
        "path": str(_build.library_path(sys.argv[2])),
        "programs": programs.default_program_registry().ledger()}))
""")


def _run(code: str, args, env) -> dict:
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    assert line, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(line[-1][len("RESULT "):])


def _shim(bin_dir, name: str, real: str, log) -> None:
    """`bin_dir/name`: logs each call to `log`, then runs `real`."""
    bin_dir.mkdir(parents=True, exist_ok=True)
    path = bin_dir / name
    path.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\nexec {real} \"$@\"\n")
    path.chmod(0o755)


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("CXX", None)
    env.update(extra)
    return env


def test_the_host_scanner_is_built_once_into_the_flags_directory(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine")
    train_dir, _ = write_dataset(str(tmp_path / "data"), n_train=64,
                                 n_val=0)
    cache = tmp_path / "cache"
    log = tmp_path / "gxx.log"
    _shim(tmp_path / "bin", "g++", gxx, log)
    env = _env(PATH=f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    argv = ["train", "--distribution_strategy", "Local",
            "--model_def", "mnist.mnist_functional_api.custom_model",
            "--training_data", train_dir, "--minibatch_size", "32",
            "--records_per_task", "64", "--device", "cpu",
            "--use_bf16", "false", "--compilation_cache_dir", str(cache)]
    first = _run(_LOCAL_JOB, argv, env)
    assert first["rc"] == 0
    assert first["cache_dir"] == str(cache.resolve())
    built = sorted(p.name for p in cache.glob("*.so"))
    assert len(built) == 1 and built[0].startswith("recordio-"), built
    assert first["host"] == {"recordio.cc": str(cache.resolve() /
                                                built[0])}
    assert len(log.read_text().splitlines()) == 1
    # a second process over data of its own (an index is cached beside
    # its file): the same library, loaded, the compiler not run
    other_dir, _ = write_dataset(str(tmp_path / "data2"), n_train=64,
                                 n_val=0, seed=1)
    argv[argv.index(train_dir)] = other_dir
    second = _run(_LOCAL_JOB, argv, env)
    assert second["rc"] == 0 and second["host"] == first["host"]
    assert len(log.read_text().splitlines()) == 1
    assert not [p for p in second["programs"] if "build" in p]
    assert sorted(p.name for p in cache.glob("*.so")) == built


def test_a_kernel_library_is_built_once_into_the_flags_directory(tmp_path):
    """A stand-in nvcc (g++ linking an empty shared library, so ctypes
    loads it) in place of the CUDA toolkit."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "while [ \"$1\" != \"-o\" ]; do shift; done\n"
        "echo 'ptxas info'\n"
        f"exec {gxx} -shared -fPIC -o \"$2\" -x c /dev/null\n")
    nvcc.chmod(0o755)
    cache = tmp_path / "cache"
    env = _env(CUDA_HOME=str(tmp_path / "cuda"))
    first = _run(_KERNEL_LOAD, [str(cache), sa.SOURCE], env)
    assert os.path.dirname(first["path"]) == str(cache.resolve())
    assert os.path.exists(first["path"])
    rec = first["programs"]["kernel_build_scatter_add"]
    assert rec["compiles"] == 1 and rec["compile_seconds_total"] > 0
    assert len(log.read_text().splitlines()) == 1
    second = _run(_KERNEL_LOAD, [str(cache), sa.SOURCE], env)
    assert second["path"] == first["path"]
    assert not [p for p in second["programs"]
                if p.startswith("kernel_build_")]
    assert len(log.read_text().splitlines()) == 1


@pytest.fixture
def fresh_build_state(monkeypatch):
    """This process's view of _build before anything loaded."""
    monkeypatch.setattr(_build, "_cache_dir", None)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "_HOST_PATHS", {})


def test_the_directory_cannot_move_after_a_load(tmp_path, fresh_build_state,
                                                monkeypatch):
    assert _build.set_cache_dir(str(tmp_path / "a")) == tmp_path / "a"
    assert _build.cache_dir() == tmp_path / "a"
    # nothing loaded yet: it may move again
    assert _build.set_cache_dir(str(tmp_path / "b")) == tmp_path / "b"
    monkeypatch.setattr(_build, "_LOADED", {sa.SOURCE: object()})
    with pytest.raises(RuntimeError, match="cannot move"):
        _build.set_cache_dir(str(tmp_path / "c"))
    # the same directory, or none named, is no move
    assert _build.set_cache_dir(str(tmp_path / "b")) == tmp_path / "b"
    assert _build.set_cache_dir("") == tmp_path / "b"
    assert _build.cache_dir() == tmp_path / "b"


def test_a_host_library_handed_out_pins_the_directory(tmp_path,
                                                      fresh_build_state,
                                                      monkeypatch):
    monkeypatch.setattr(_build, "_build_host",
                        lambda source: tmp_path / "lib.so")
    assert _build.build_host("recordio.cc") == tmp_path / "lib.so"
    with pytest.raises(RuntimeError, match="recordio.cc"):
        _build.set_cache_dir(str(tmp_path / "elsewhere"))


def test_an_empty_flag_keeps_the_default_directory(fresh_build_state):
    args = port_args.parse_master_args([])
    assert args.compilation_cache_dir == ""
    assert _build.set_cache_dir(args.compilation_cache_dir) == \
        _build.BUILD_DIR
    assert _build._cache_dir is None
    assert _build.cache_dir() == _build.BUILD_DIR
    assert _build.BUILD_DIR == _build.CSRC_DIR.parents[1] / "build" / \
        "elasticdl_tpu_torch"
    assert _build.library_path(sa.SOURCE, "nvcc").parent == \
        _build.BUILD_DIR

"""Build and load the port's hand-written CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` into a shared library with a
plain C interface, loaded through `ctypes`.  PyTorch's headers are never
included: such a build takes minutes, a plain one seconds.  Libraries go
to the cache directory, by default `build/elasticdl_tpu_torch/` at the
root of the checkout that holds this package (resolved from this file,
not from the working directory), named by a hash of every source in
`csrc/` and of the flags, so a changed source builds anew and an
unchanged one is loaded from the cache.  `set_cache_dir` (the
`--compilation_cache_dir` flag, applied first by the master, the worker
and the Local runner) moves the cache before anything is built or
loaded: a directory shared by the pods of a job (a `--volume` mount)
lets a relaunched or added pod load what the first one built.  Each
library is written under a temporary name and renamed into place, so a
process never loads half of one.  Once a library has loaded, the
directory cannot move.

Nothing is built at import time.  A missing `nvcc` or a failed build
raises; there is no fallback.  Each nvcc build that runs is reported to
the program registry (common/programs.py) as the program
`kernel_build_<source stem>` with its wall seconds and the library's
hash as its signature; a library found in the cache records nothing.

Host code (`hostsrc/*.cc`, the native TFRecord scanner) takes a second
route, `build_host`: `g++ -O3 -shared -fPIC` into the same directory,
named by a hash of that one source, the flags and the compiler, so a
change there never renames the CUDA builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from elasticdl_tpu_torch.common import programs

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
HOSTSRC_DIR = Path(__file__).resolve().parent.parent / "hostsrc"
BUILD_DIR = (
    Path(__file__).resolve().parents[2] / "build" / "elasticdl_tpu_torch"
)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills per kernel, kept in build_logs
    "-Xptxas", "-v",
)

HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
# hostsrc/ source name -> the library path build_host handed out
_HOST_PATHS: Dict[str, Path] = {}
# set_cache_dir's directory; None: BUILD_DIR
_cache_dir: Optional[Path] = None
# source name -> nvcc's output (ptxas resource usage), for the builds
# this process ran
build_logs: Dict[str, str] = {}


def cache_dir() -> Path:
    """Where the libraries are built and looked for."""
    return BUILD_DIR if _cache_dir is None else _cache_dir


def set_cache_dir(path: str) -> Path:
    """Build and load the libraries under `path` (an empty `path` keeps
    the current directory); returns the directory in use.  Raises once
    a library has loaded from another directory: what this process runs
    must come from one place."""
    global _cache_dir
    if not path:
        return cache_dir()
    new = Path(path).expanduser().resolve()
    with _LOCK:
        if new != cache_dir():
            if _LOADED or _HOST_PATHS:
                raise RuntimeError(
                    f"the kernel cache directory cannot move to {new}: "
                    f"{sorted(_LOADED) + sorted(_HOST_PATHS)} already "
                    f"loaded from {cache_dir()}")
            _cache_dir = new
    return new


def find_nvcc() -> str:
    candidates = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    for root in candidates:
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, $PATH and "
        "/usr/local/cuda); the port's CUDA kernels need the CUDA toolkit"
    )


def sources() -> List[str]:
    return sorted(p.name for p in CSRC_DIR.glob("*.cu"))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def library_path(source: str, nvcc: Optional[str] = None) -> Path:
    stem = Path(source).stem
    return cache_dir() / f"{stem}-{_digest(nvcc or find_nvcc())}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile every named source (default: all of `csrc/`) that has no
    cached library, one `nvcc` per source, all started together.  Raises
    on the first failure, after every started compile has ended."""
    nvcc = find_nvcc()
    names = list(names or sources())
    cache_dir().mkdir(parents=True, exist_ok=True)
    started = []
    for name in names:
        out = library_path(name, nvcc)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log_path = out.with_name(f"{out.stem}.{os.getpid()}.log")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / name)]
        with open(log_path, "w") as log_file:
            proc = subprocess.Popen(cmd, stdout=log_file,
                                    stderr=subprocess.STDOUT)
        started.append((name, out, tmp, log_path, proc, time.monotonic()))
    # each build's own wall time: poll, so a quick build is not charged
    # for a slow one started before it
    seconds = {}
    running = list(started)
    while running:
        for item in list(running):
            if item[4].poll() is not None:
                seconds[item[0]] = time.monotonic() - item[5]
                running.remove(item)
        if running:
            time.sleep(0.01)
    failures = []
    for name, out, tmp, log_path, proc, _ in started:
        log = log_path.read_text()
        log_path.unlink(missing_ok=True)
        build_logs[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
        programs.register_compiled(
            f"kernel_build_{Path(name).stem}", out, seconds=seconds[name],
            signature=out.stem.rsplit("-", 1)[-1], avals=name)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: library_path(name, nvcc) for name in names}


def ensure_built(names: List[str]) -> None:
    """`build_all(names)` under the loader's lock, so that a library
    another thread is loading (or building) at the same time is built
    once."""
    with _LOCK:
        build_all(names)


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            path = build_all([source])[source]
            lib = _LOADED[source] = ctypes.CDLL(str(path))
        return lib


def find_cxx() -> str:
    found = shutil.which(os.environ.get("CXX") or "g++")
    if not found:
        raise RuntimeError("g++ not found (looked for $CXX and g++ on "
                           "$PATH); the native host code needs it")
    return found


def host_library_path(source: str, cxx: Optional[str] = None) -> Path:
    cxx = cxx or find_cxx()
    h = hashlib.sha256()
    h.update((HOSTSRC_DIR / source).read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    h.update(cxx.encode())
    return cache_dir() / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_host(source: str) -> Path:
    """Compile `hostsrc/<source>` with g++ unless its library is cached;
    the output is renamed into place, so a concurrent loader never sees
    half of it.  Raises on a failed compile.  The caller loads the path
    returned, so the cache directory stays where it is from then on."""
    with _LOCK:
        out = _HOST_PATHS[source] = _build_host(source)
    return out


def _build_host(source: str) -> Path:
    cxx = find_cxx()
    out = host_library_path(source, cxx)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [cxx, *HOST_FLAGS, "-o", str(tmp), str(HOSTSRC_DIR / source)],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out

"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``build/repro_torch/`` at the
repository root (listed in ``.gitignore``).  The library's file name carries
a digest of the source, of every ``csrc`` header it includes (``#include
"<header>"``, followed through the headers) and of the flags, so an edited
source or header is rebuilt and a stale library is never loaded.  ``build_all`` starts one ``nvcc`` per source
at once and waits for all of them.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("hessian_xtx", "nm_spmm")

_LIBS: dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build made in this process
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or ""
    cand = Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and the csrc headers it includes, directly or
    through other headers, in the order first met."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = CSRC / inc.decode()
            if header.is_file():
                todo.append(header)
    return seen


def _lib_path(name: str) -> Path:
    parts = [" ".join(NVCC_FLAGS).encode()]
    for path in _sources(name):
        data = path.read_bytes()
        parts.append(f"\0{path.name}\0{len(data)}\0".encode() + data)
    digest = hashlib.sha256(b"".join(parts)).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _start(name: str) -> "tuple[subprocess.Popen, Path, Path] | None":
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)        # atomic: a half-written library never loads


def build_all() -> float:
    """Compile every kernel source not yet built, in parallel; → seconds."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in SOURCES}
    try:
        for name, job in jobs.items():
            if job is not None:
                _finish(name, job)
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{status}")

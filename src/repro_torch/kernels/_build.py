"""Build and load the CUDA kernels in ``kernels/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``: every
pointer and the stream go as ``c_void_p``, every count as ``c_int``, and
each entry point returns ``cudaGetLastError()``. The libraries go to
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
under a hash of the source and the flags, so a changed source rebuilds.
Nothing is built at import: the first ``load`` builds, and ``build_all``
starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}     # nvcc's output (ptxas registers/spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    target = _target(name)
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, target: Path, tmp: Path,
            proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)


def build_all(names: Iterable[str]) -> List[str]:
    """Build every library not yet built, one ``nvcc`` each, in parallel.
    Returns the names that were compiled in this call."""
    with _lock:
        todo = [n for n in names if n not in _libs
                and not _target(n).exists()]
        started = [(n, *_start(n)) for n in todo]
        failures = []
        for n, target, tmp, proc in started:
            try:
                _finish(n, target, tmp, proc)
            except RuntimeError as e:       # wait for every build first
                failures.append(str(e))
        if failures:
            raise RuntimeError("\n".join(failures))
        return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]

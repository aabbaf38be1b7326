"""Build the port's CUDA sources into plain-C shared libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/hyphy_tpu_torch/<name>-<hash>.so`` at the root of the checkout,
where ``<hash>`` is taken from the source's content and the compile
command, so an edited source is rebuilt and an unchanged one is reused.
The library is loaded with ``ctypes``; nothing here includes PyTorch's
headers, so one build takes seconds.  Nothing is compiled when this module
is imported: the first launch of a kernel builds it, or a caller builds all
sources at once with :func:`build_all` (one ``nvcc`` per source, run
concurrently).  ``defines`` (``NAME=VALUE`` strings passed as ``-D``)
build a variant of a source into its own library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Sequence

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "hyphy_tpu_torch"
SOURCES = ("level_products",)
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[tuple, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _flags(defines: Sequence[str]) -> tuple:
    return _FLAGS + tuple(f"-D{d}" for d in defines)


def _target(name: str, defines: Sequence[str] = ()) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str, defines: Sequence[str]):
    """Start ``nvcc`` for one source; returns (process, tmp path, target)
    or None when the library is already built."""
    target = _target(name, defines)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def _finish(name: str, job) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: concurrent builders never see half a file


def build_all(names: Sequence[str] = SOURCES, defines: Sequence[str] = ()) -> None:
    """Compile every named source, all ``nvcc`` processes at once."""
    jobs = {}
    try:
        for name in names:
            job = _start(name, defines)
            if job is not None:
                jobs[name] = job
    finally:
        # wait for every started compile, even when a later start failed
        errors = []
        for name, job in jobs.items():
            try:
                _finish(name, job)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    key = (name, tuple(defines))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            build_all([name], defines)
            lib = ctypes.CDLL(str(_target(name, defines)))
            _loaded[key] = lib
        return lib

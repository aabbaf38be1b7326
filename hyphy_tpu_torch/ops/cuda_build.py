"""Build the port's CUDA sources and host C++ sources into plain-C shared
libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``, and each
``native/<name>.cpp`` (the host kernels: TN93 distances, pattern
compression, pairwise alignment) by ``g++``, into
``build/hyphy_tpu_torch/<name>-<hash>.so`` at the root of the checkout,
where ``<hash>`` is taken from the source's content and the compile
command, so an edited source is rebuilt and an unchanged one is reused.
The library is loaded with ``ctypes``; nothing here includes PyTorch's
headers, so one build takes seconds.  Nothing is compiled when this module
is imported: the first launch of a kernel builds it, or a caller builds all
sources at once with :func:`build_all` (one compiler per source, run
concurrently; ``host=True`` for the C++ sources).  A failed build raises
with the compiler's output.  ``defines`` (``NAME=VALUE`` strings passed as ``-D``)
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
NATIVE = CSRC.parent / "native"
BUILD_DIR = CSRC.parent.parent / "build" / "hyphy_tpu_torch"
SOURCES = ("level_products",)
HOST_SOURCES = ("datapath", "align")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

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


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host kernels (native/*.cpp) need a C++ compiler")


def _flags(defines: Sequence[str], host: bool = False) -> tuple:
    return (_HOST_FLAGS if host else _FLAGS) + tuple(f"-D{d}" for d in defines)


def _source(name: str, host: bool) -> pathlib.Path:
    return NATIVE / f"{name}.cpp" if host else CSRC / f"{name}.cu"


def _target(name: str, defines: Sequence[str] = (), host: bool = False) -> pathlib.Path:
    src = _source(name, host).read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(defines, host)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str, defines: Sequence[str], host: bool = False):
    """Start the compiler for one source; returns (process, tmp path,
    target, source) or None when the library is already built."""
    target = _target(name, defines, host)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    source = _source(name, host)
    cmd = [_gxx() if host else _nvcc(), *_flags(defines, host), "-o", str(tmp), str(source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target, source


def _finish(name: str, job) -> None:
    proc, tmp, target, source = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{proc.args[0]} failed for {source.parent.name}/{source.name}:\n{out}")
    os.replace(tmp, target)  # atomic: concurrent builders never see half a file


def build_all(names: Sequence[str] = SOURCES, defines: Sequence[str] = (),
              host: bool = False) -> None:
    """Compile every named source, all compiler processes at once."""
    _build([(name, tuple(defines), host) for name in names])


def build_sources() -> None:
    """Every CUDA source and every host C++ source, all compilers at once."""
    _build([(name, (), False) for name in SOURCES] + [(name, (), True) for name in HOST_SOURCES])


def _build(specs) -> None:
    jobs = {}
    try:
        for name, defines, host in specs:
            job = _start(name, defines, host)
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


def load(name: str, defines: Sequence[str] = (), host: bool = False) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (``native/<name>.cpp``
    with ``host``), building it if needed."""
    key = (name, tuple(defines), host)
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            build_all([name], defines, host)
            lib = ctypes.CDLL(str(_target(name, defines, host)))
            _loaded[key] = lib
        return lib

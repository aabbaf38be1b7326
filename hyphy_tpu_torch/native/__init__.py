"""Host C++ kernels of the port, loaded with ctypes.

Counterpart of ``hyphy_tpu/native/__init__.py``: the runtime around the
likelihood (pattern compression, distance estimation for NJ, pairwise
alignment) mirrors the reference's native data layer
(``src/core/dataset_filter.cpp``, ``src/core/alignment.cpp``).  The sources
``datapath.cpp`` and ``align.cpp`` are compiled with g++ by
:mod:`hyphy_tpu_torch.ops.cuda_build` into ``build/hyphy_tpu_torch/`` at
the root of the checkout (never beside the source) on first use, or all at
once by ``cuda_build.build_all(cuda_build.HOST_SOURCES, host=True)``.  A
failed build raises with the compiler's output: there is no quiet fallback.
The NumPy mirrors are what the callers take when asked
(``use_native=False``), and what the tests hold these kernels to.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from hyphy_tpu_torch.ops import cuda_build

_configured = set()
_lock = threading.Lock()


def library(name: str) -> ctypes.CDLL:
    """The loaded ``native/<name>.cpp`` library with its entry points'
    argument and result types declared, built if needed."""
    lib = cuda_build.load(name, host=True)
    with _lock:
        if name not in _configured:
            _declare(name, lib)
            _configured.add(name)
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    i8p, i32p = ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32)
    dp, lp = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
    i64, dbl = ctypes.c_int64, ctypes.c_double
    if name == "datapath":
        lib.tn93_distances.argtypes = [i8p, i64, i64, dbl, dp]
        lib.tn93_distances.restype = None
        lib.compress_patterns.argtypes = [i32p, i64, i64, i32p, i32p]
        lib.compress_patterns.restype = i64
    elif name == "align":
        lib.gotoh_align.argtypes = [i32p, i64, i32p, i64, dp, i64, dbl, dbl,
                                    ctypes.c_int32, i32p, i32p, lp]
        lib.gotoh_align.restype = dbl
        lib.codon_align.argtypes = [i32p, i64, i32p, i64, dp, dbl, dbl, dbl, dbl, dbl,
                                    i32p, i32p, lp]
        lib.codon_align.restype = dbl


def tn93_distances(states: np.ndarray, saturation: float = 5.0) -> np.ndarray:
    """[taxa, taxa] TN93 distances from [taxa, sites] int8 states (0..3 =
    ACGT, negative = unresolved); a saturated pair, or one with no site both
    resolve, gets ``saturation``."""
    lib = library("datapath")
    states = np.ascontiguousarray(states, dtype=np.int8)
    taxa, sites = states.shape
    out = np.zeros((taxa, taxa), dtype=np.float64)
    lib.tn93_distances(
        states.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), taxa, sites, saturation,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def compress_patterns(codes: np.ndarray):
    """(pattern_index [sites], first_site [n_patterns]) of [taxa, sites]
    int32 column codes: patterns numbered in order of first occurrence."""
    lib = library("datapath")
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    taxa, sites = codes.shape
    pattern_index = np.empty(sites, dtype=np.int32)
    first_site = np.empty(sites, dtype=np.int32)
    n = lib.compress_patterns(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), taxa, sites,
        pattern_index.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        first_site.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return pattern_index, first_site[:n]

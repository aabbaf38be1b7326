"""Likelihood-function snapshots: save/restore a fitted state.

A numpy copy of ``hyphy_tpu/io/serialize.py`` (the port imports nothing of
the JAX package).  Counterpart of the reference's ``SerializeLF`` /
``Export`` (``src/core/likefunc.cpp:11786``): a self-contained snapshot of
a fit — data fingerprint, tree, model identity/configuration, and current
parameter values — used for method-level fit caching (BUSTED
``--save-fit`` / ``busted.use_cached_full_model``, BUSTED.bf:680-733).
The reference serializes an executable HBL program; here the snapshot is
declarative JSON (parameters + provenance): reloading re-applies the
parameter values to a freshly constructed model and verifies the data
fingerprint.  Parameters go in as numpy arrays (or anything
``np.asarray`` takes).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np

FORMAT_VERSION = 1


def data_fingerprint(names, sequences) -> str:
    h = hashlib.sha256()
    for n, s in zip(names, sequences):
        h.update(n.encode())
        h.update(b"\x00")
        h.update(s.encode())
        h.update(b"\x01")
    return h.hexdigest()[:32]


def save_snapshot(
    path: str,
    params: Dict,
    loglik: float,
    model: str = "",
    model_config: Optional[Dict] = None,
    tree: str = "",
    fingerprint: str = "",
    extra: Optional[Dict] = None,
) -> None:
    payload = {
        "format": FORMAT_VERSION,
        "model": model,
        "model_config": model_config or {},
        "tree": tree,
        "data_fingerprint": fingerprint,
        "log_likelihood": float(loglik),
        "parameters": {
            k: np.asarray(v, dtype=np.float64).tolist() for k, v in params.items()
        },
    }
    if extra:
        payload["extra"] = extra
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
    os.replace(tmp, path)


def load_snapshot(
    path: str,
    expect_fingerprint: str = "",
    expect_model: str = "",
) -> Optional[Dict]:
    """Returns the snapshot dict with parameters as numpy arrays, or None
    when the file is absent / unreadable / from different data or model
    (a stale cache is silently ignored, matching the reference's cache
    checks; cf. FUBAR.bf:160-236)."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            payload = json.load(fh)
        if payload.get("format") != FORMAT_VERSION:
            return None
        if expect_fingerprint and payload.get("data_fingerprint") != expect_fingerprint:
            return None
        if expect_model and payload.get("model") != expect_model:
            return None
        payload["parameters"] = {
            k: np.asarray(v, dtype=np.float64)
            for k, v in payload["parameters"].items()
        }
        return payload
    except Exception:
        return None

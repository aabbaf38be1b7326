"""Global configuration knobs of the PyTorch port.

Counterpart of ``hyphy_tpu/config.py``.  The ``HYPHY_TPU_*`` environment
names are kept, so one environment drives both packages.

Device rule: ``settings.device`` defaults to ``"cuda"``.  Every entry point
takes ``device=None`` and resolves it through :func:`resolve_device`, which
raises when CUDA is absent and the caller did not ask for the CPU: nothing
carries on silently on the CPU.

Mesh rule (:meth:`Settings.default_mesh`): a likelihood function or a
BS-REL engine on the card splits its patterns over every visible card only
when two or more are visible and its estimated working set is larger than
half of the first card's free memory; a gene that fits on one card stays
there, where it runs faster (PERF.md) and gives the same numbers on any
host.
``HYPHY_TPU_MESH=off`` keeps everything on the one device.
``settings.mesh`` names a mesh instead, e.g. ``("cpu",) * 3`` to run the
sharded path on the CPU, or ``("cuda:0", "cuda:1")`` for two cards; it
also splits the items of FEL's per-site solves; its first device must be
the device the analysis runs on.  One process drives the mesh, an ordered
tuple of devices (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import os

import torch


def _env(name: str, default, cast):
    raw = os.environ.get(f"HYPHY_TPU_{name}")
    if raw is None:
        return default
    if cast is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return cast(raw)


@dataclasses.dataclass
class Settings:
    """Runtime knobs (mirrors the reference's env registry, hbl_env.cpp)."""

    # lnL convergence tolerance for the outer optimizer
    # (reference: OPTIMIZATION_PRECISION, default per analysis; fixtures 0.001)
    optimization_precision: float = _env("OPTIMIZATION_PRECISION", 0.001, float)
    # max optimizer iterations scaled by #parameters
    # (reference: MAXIMUM_ITERATIONS_PER_VARIABLE)
    max_iterations_per_variable: int = _env("MAX_ITER_PER_VAR", 2000, int)
    # RNG seed (reference: RANDOM_SEED)
    random_seed: int = _env("RANDOM_SEED", 0, int)
    # warmup mode: cap L-BFGS at 3 iterations and Nelder-Mead at 32, so a
    # whole pipeline runs each of its code paths once without paying for
    # the fits
    warmup: bool = _env("WARMUP", False, bool)
    # where tensors live: "cuda" unless the caller asks for "cpu"
    device: str = "cuda"
    # the device mesh: None for the automatic one (every visible card, for
    # a likelihood one card cannot hold), or a sequence of devices, repeats
    # allowed
    mesh: "tuple | None" = None

    def default_mesh(self, device=None, nbytes=None):
        """The mesh that an analysis on ``device`` (default
        ``settings.device``) shards over: a tuple of ``torch.device`` whose
        first entry is ``device``, or ``None`` for no sharding.

        ``HYPHY_TPU_MESH=off`` (or 0, none, no) gives ``None``.  A mesh
        named by ``settings.mesh`` is taken as it is (one of a single
        device is no mesh).  Otherwise the mesh is automatic: every visible
        card, ``device`` first, when ``device`` is a card, two or more are
        visible and ``nbytes``, the working set the caller estimates, is
        larger than half of ``device``'s free memory (the margin that
        ``chunked_site_solve`` keeps too).  The reference engages its
        MPI site-template mode on its own inside ``Optimize``
        (``likefunc.cpp:3747``), and the JAX package shards whenever it
        sees two devices (``hyphy_tpu/config.py:57-84``); here one thread
        issues every block, so a mesh of cards is slower than one card
        for a gene that fits on it (PERF.md), and is engaged only where
        one card cannot hold the gene.  ``nbytes=None`` (a per-site
        solve, which ``chunked_site_solve`` already fits to one card's
        memory) never engages it: its blocks run from one host thread
        each, every block issues as many launches as one card does for all
        the items, and four H100s ran FEL's per-site stage 13x slower than
        one card at 48 taxa x 128 codons and 6.4x slower at 1000 x 2048
        (PERF.md).
        Every device goes through :func:`resolve_device`, so a mesh naming
        CUDA without a card raises.  The JAX package leaves fp64 unsharded on an accelerator,
        because its fp64 stages run on the host CPU; the port runs fp64 on
        the card, and shards it like fp32."""
        if os.environ.get("HYPHY_TPU_MESH", "auto").lower() in ("0", "off", "none", "no"):
            return None
        dev = canonical_device(resolve_device(device))
        if self.mesh is not None:
            mesh = tuple(canonical_device(resolve_device(d)) for d in self.mesh)
            if len(mesh) == 1:
                return None
            if mesh[0] != dev:
                raise ValueError(f"settings.mesh starts on {mesh[0]}, the analysis runs on {dev}")
            return mesh
        n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        if n_cards < 2 or nbytes is None or nbytes <= torch.cuda.mem_get_info(dev)[0] / 2:
            return None
        return (dev,) + tuple(torch.device("cuda", i) for i in range(n_cards) if i != dev.index)

    def likelihood_dtype(self, device=None) -> torch.dtype:
        """Compute dtype for the likelihood path: fp64 on the CPU (parity),
        fp32 on the card; ``HYPHY_TPU_PRECISION`` overrides both.  Which
        dtype should carry the card's main path is measured in PERF.md."""
        forced = os.environ.get("HYPHY_TPU_PRECISION")
        if forced:
            return getattr(torch, forced)
        dev = torch.device(device if device is not None else self.device)
        return torch.float64 if dev.type == "cpu" else torch.float32


settings = Settings()


def resolve_device(device=None) -> torch.device:
    """``device`` or ``settings.device``; raises if it names CUDA and no
    card is visible."""
    dev = torch.device(device if device is not None else settings.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (or set "
                "hyphy_tpu_torch.config.settings.device = 'cpu') to run on "
                "the CPU"
            )
        # fp32 matmuls must be true fp32 on the card: TF32 keeps ~3 decimal
        # digits, which a deep pruning recursion compounds into lnL error
        # (the JAX package pins Precision.HIGHEST in ops/expm.py for the
        # same reason)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def canonical_device(device) -> torch.device:
    """``device`` with its CUDA index filled in (``cuda`` is the current
    card), so that two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev

"""Global configuration knobs of the PyTorch port.

Counterpart of ``hyphy_tpu/config.py`` without the device mesh (this port
runs on one card).  The ``HYPHY_TPU_*`` environment names are kept, so one
environment drives both packages.

Device rule: ``settings.device`` defaults to ``"cuda"``.  Every entry point
takes ``device=None`` and resolves it through :func:`resolve_device`, which
raises when CUDA is absent and the caller did not ask for the CPU: nothing
carries on silently on the CPU.
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

"""Carry a parameter dict between the two packages.

A JAX-package parameter dict maps names to arrays; as numpy (for example
``{k: np.asarray(s.initial(), np.float64) ...}``, the way ``bench.py``
builds its point) it moves into the port with :func:`params_from_numpy`
and back with :func:`params_to_numpy`, so both packages evaluate the same
point.  Every model keeps the JAX package's parameter names and shapes (the
protein models' ``t`` and ``r_XY``, the GDD model's ``omega_c``,
``omega_w``, ``delta``, ``psi`` and ``psi_syn``), so a dict moves across by
name.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_numpy(params_np: Dict[str, np.ndarray], device, dtype=torch.float64
                      ) -> Dict[str, torch.Tensor]:
    return {
        k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
        for k, v in params_np.items()
    }


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}

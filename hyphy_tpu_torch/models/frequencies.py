"""Equilibrium frequency estimators: F (empirical), F3x4, CF3x4.

Counterpart of ``hyphy_tpu/models/frequencies.py``; behavioural ports of
``res/TemplateBatchFiles/libv3/models/frequencies.bf``:

  * F3x4 (``frequencies.bf:283``): observed position-specific nucleotide
    frequencies; codon frequency = product / (1 - sum of stop products).
  * CF3x4 (``frequencies.bf:351``; solver ``:510``): 9 stick-breaking corner
    parameters per codon position fit by least squares so the *implied*
    observable position frequencies (after removing stop-codon mass) match
    the observed 3x4 table.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hyphy_tpu_torch.config import resolve_device
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.data.genetic_code import GeneticCode
from hyphy_tpu_torch.models.parameters import ParamSpec
from hyphy_tpu_torch.optimize.core import maximize


def _combined_harvest(filts, unit: int, atom: int, position_specific: bool) -> np.ndarray:
    """Frequency harvest over one filter or a list of them.  A list (the
    partitions of a multi-partition analysis) pools the counts weighted by
    each filter's column count: the reference harvests ONE model's
    frequencies across all partition filters (``estimators.CreateLFObject``,
    ``estimators.bf:982``)."""
    if isinstance(filts, DataFilter):
        return filts.harvest_frequencies(unit, atom, position_specific)
    total, weight = None, 0.0
    for f in filts:
        w = float(f.n_units * f.n_sequences)
        h = f.harvest_frequencies(unit, atom, position_specific) * w
        total = h if total is None else total + h
        weight += w
    return total / max(weight, 1e-300)


def empirical_nucleotide(filt) -> np.ndarray:
    """4 empirical nucleotide frequencies (GTR's estimator), from one
    DataFilter or pooled over a list of them."""
    return _combined_harvest(filt, 1, 1, False)[:, 0]


def empirical_character(filt: DataFilter) -> np.ndarray:
    """Pooled single-character frequencies (the protein models' +F)."""
    return filt.harvest_frequencies(1, 1, False)[:, 0]


def _codon_from_corners(corners: np.ndarray, gc: GeneticCode) -> np.ndarray:
    """pi_c = n0[c0] n1[c1] n2[c2] / (1 - sum_stops n0 n1 n2)
    (reference: ``codon_from_nuc``, frequencies.bf)."""
    stops = gc.stop_codons
    sense = gc.sense_codons
    d = 1.0 - np.sum(
        corners[stops // 16, 0] * corners[(stops // 4) % 4, 1] * corners[stops % 4, 2]
    )
    return (
        corners[sense // 16, 0]
        * corners[(sense // 4) % 4, 1]
        * corners[sense % 4, 2]
        / d
    )


def f3x4(filt, gc: GeneticCode) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (corner_freqs [4,3], codon_freqs [n_sense]); ``filt`` is
    one DataFilter or a list of them (pooled)."""
    obs = _combined_harvest(filt, 3, 1, True)  # [4, 3]
    return obs, _codon_from_corners(obs, gc)


def f1x4(filt, gc: GeneticCode) -> Tuple[np.ndarray, np.ndarray]:
    """F1x4: the pooled nucleotide frequencies at all three codon positions.
    Returns (corner_freqs [4,3], codon_freqs [n_sense]); ``filt`` is one
    DataFilter or a list of them (pooled)."""
    pooled = _combined_harvest(filt, 1, 1, False)[:, 0]
    corners = np.tile(pooled[:, None], (1, 3))
    return corners, _codon_from_corners(corners, gc)


def _stick_break(p: torch.Tensor) -> torch.Tensor:
    """[3] fractions in (0,1) -> [4] frequencies summing to 1."""
    one = torch.ones((1,), dtype=p.dtype, device=p.device)
    rem = torch.cat([one, torch.cumprod(1.0 - p, dim=0)])
    return torch.cat([p, one]) * rem


def _stick_init(freqs: np.ndarray) -> np.ndarray:
    """Invert stick-breaking for initial values."""
    p = np.zeros(3)
    acc = 1.0
    for k in range(3):
        p[k] = min(max(freqs[k] / acc, 1e-8), 1 - 1e-8)
        acc *= 1.0 - p[k]
    return p


def cf3x4(filt, gc: GeneticCode, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Corrected F3x4: returns (corner_freqs n [4,3], codon_freqs [n_sense]);
    ``filt`` is one DataFilter or a list of them (pooled).

    Solves the least-squares problem of ``frequencies._aux.CF3x4``
    (frequencies.bf:510) in fp64 on ``device``.
    """
    device = resolve_device(device)
    obs = _combined_harvest(filt, 3, 1, True)  # [4, 3] observed
    stops = gc.stop_codons
    s0, s1, s2 = (torch.as_tensor(x.astype(np.int64), device=device)
                  for x in (stops // 16, (stops // 4) % 4, stops % 4))
    col = [torch.full_like(s0, c) for c in range(3)]

    def implied(n: torch.Tensor) -> torch.Tensor:
        """n [4,3] -> N [4,3] implied observable frequencies."""
        d = 1.0 - torch.sum(n[s0, 0] * n[s1, 1] * n[s2, 2])
        # stop-mass correction per (base, position); repeated stop bases
        # accumulate, as ``.at[].add`` does
        corr = torch.ones((4, 3), dtype=n.dtype, device=device)
        corr = corr.index_put((s0, col[0]), -(n[s1, 1] * n[s2, 2]), accumulate=True)
        corr = corr.index_put((s1, col[1]), -(n[s0, 0] * n[s2, 2]), accumulate=True)
        corr = corr.index_put((s2, col[2]), -(n[s0, 0] * n[s1, 1]), accumulate=True)
        return n * corr / d

    obs_t = torch.as_tensor(obs, dtype=torch.float64, device=device)

    def objective(params):
        n = torch.stack([_stick_break(params[f"p{k}"]) for k in range(3)], dim=1)
        err = implied(n) - obs_t
        return -torch.sum(err * err)

    specs = {f"p{k}": ParamSpec(init=0.25, lower=0.0, upper=1.0, shape=(3,)) for k in range(3)}
    init = {
        f"p{k}": torch.as_tensor(_stick_init(obs[:, k]), dtype=torch.float64, device=device)
        for k in range(3)
    }
    best, _, _ = maximize(objective, specs, init, precision=1e-14, device=device)
    n = np.stack(
        [_stick_break(best[f"p{k}"]).detach().cpu().numpy() for k in range(3)], axis=1
    )
    return n, _codon_from_corners(n, gc)

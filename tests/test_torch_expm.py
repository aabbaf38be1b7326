"""The port's propagators (``hyphy_tpu_torch/ops/expm.py``) against the JAX
package's on the same generators and times."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu.ops import expm as jexpm
from hyphy_tpu_torch.ops import expm as texpm

torch.set_num_threads(2)


def _gtr_generator(rng):
    pi = rng.dirichlet(np.ones(4))
    ex = rng.uniform(0.2, 2.0, size=(4, 4))
    q = (ex + ex.T) * pi[None, :]
    np.fill_diagonal(q, 0.0)
    np.fill_diagonal(q, -q.sum(1))
    return q, pi


def _mg94_generator(rng):
    from hyphy_tpu.data.genetic_code import GeneticCode
    from hyphy_tpu.models.base import fill_diagonal_from_rows
    from hyphy_tpu.models.codon import MG94xREVPartitionedOmega
    from hyphy_tpu.models.frequencies import _codon_from_corners

    gc = GeneticCode("Universal")
    corners = rng.dirichlet(np.ones(4), size=3).T
    pi = _codon_from_corners(corners, gc)
    model = MG94xREVPartitionedOmega(
        gc, corners, pi, np.ones(3), np.zeros(3, np.int32), 1, free_lengths=True
    )
    thetas = {f"theta_{p}": jnp.asarray(rng.uniform(0.2, 2.0))
              for p in ("AC", "AT", "CG", "CT", "GT")}
    q_syn, q_non = model.basis_matrices(thetas)
    return np.asarray(fill_diagonal_from_rows(q_syn + 0.4 * q_non)), pi


GENERATORS = {"gtr4": _gtr_generator, "mg94_61": _mg94_generator}


@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("dtype, atol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_shared_taylor_propagators(name, dtype, atol):
    rng = np.random.default_rng(3)
    q, _ = GENERATORS[name](rng)
    t = np.concatenate([rng.uniform(1e-4, 1.0, size=6), [3.0]])
    if dtype == np.float64:
        # long and saturating times too: in fp32 the squaring ladder
        # amplifies round-off there to ~1e-5 in both packages alike
        t = np.concatenate([t, [50.0, 1e5]])
    torch_dtype = getattr(torch, np.dtype(dtype).name)
    ref = np.asarray(jexpm.shared_taylor_propagators(
        jnp.asarray(q, dtype), jnp.asarray(t, dtype)))
    ours = texpm.shared_taylor_propagators(
        torch.tensor(q, dtype=torch_dtype), torch.tensor(t, dtype=torch_dtype)
    ).numpy()
    assert ours.dtype == dtype
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_spectral_propagators(name):
    rng = np.random.default_rng(4)
    q, pi = GENERATORS[name](rng)
    t = rng.uniform(1e-3, 2.0, size=7)
    left, lam, right = jexpm.reversible_spectral(jnp.asarray(q), jnp.asarray(pi))
    ref = np.asarray(jexpm.spectral_propagators(left, lam, right, jnp.asarray(t)))
    tl, tlam, tr = texpm.reversible_spectral(torch.tensor(q), torch.tensor(pi))
    ours = texpm.spectral_propagators(tl, tlam, tr, torch.tensor(t)).numpy()
    np.testing.assert_allclose(tlam.numpy(), np.asarray(lam), atol=1e-10, rtol=0)
    np.testing.assert_allclose(ours, ref, atol=1e-10, rtol=0)


def test_row_renormalize():
    p = np.random.default_rng(5).uniform(size=(3, 5, 5))
    ours = texpm.row_renormalize(torch.tensor(p)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jexpm.row_renormalize(jnp.asarray(p))),
                               atol=1e-15)
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-14)

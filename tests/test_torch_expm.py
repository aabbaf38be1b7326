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


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_deep_ladders_stay_stochastic(dtype, atol):
    """Ladders past the default depth (``expm.ladder_depth`` at ||Q t|| ~
    1e9) keep their squares row-stochastic: the propagators equal the
    chain's stationary rows, where unrenormalised fp32 squares overflow."""
    rng = np.random.default_rng(3)
    q, pi = _mg94_generator(rng)
    qt = torch.tensor(q * 1e3, dtype=dtype)
    t = torch.tensor([1e6, 2.5e5], dtype=dtype)
    depth = texpm.ladder_depth(qt, t, 11, radius=2.0)
    assert depth > 25
    p = texpm.shared_taylor_propagators(qt, t, depth)
    np.testing.assert_allclose(p.double().numpy(), np.broadcast_to(pi, p.shape), rtol=0,
                               atol=atol)
    qn, m2p, r, j = texpm.taylor_action_factors(qt[None], t,
                                                texpm.ladder_depth(qt, t, 12, maximum=31))
    assert torch.isfinite(m2p).all()
    np.testing.assert_allclose(m2p[0, -1].double().numpy().sum(axis=1), 1.0, atol=atol)


@pytest.mark.parametrize("omega", [0.0, 1.0, 1e4])
def test_settled_zero_modes_reach_the_stationary_limit(omega):
    """``settle_zero_modes`` takes the round-off off a generator's zero
    modes, so that the spectral propagators at t = 1e17 equal the chain's
    limit: the stationary rows, or at omega 0, where the codon chain is
    reducible with one zero mode per amino acid, ``expm(Q 1e4)``."""
    import scipy.linalg

    from hyphy_tpu.data.genetic_code import GeneticCode as JCode
    from hyphy_tpu.models.frequencies import _codon_from_corners
    from hyphy_tpu_torch.data.genetic_code import GeneticCode
    from hyphy_tpu_torch.models.base import fill_diagonal_from_rows
    from hyphy_tpu_torch.models.codon import MG94Base

    corners = np.random.default_rng(3).dirichlet(np.ones(4), size=3).T
    pi = np.asarray(_codon_from_corners(corners, JCode("Universal")))
    model = MG94Base(GeneticCode("Universal"), corners, pi, device="cpu")
    thetas = {f"theta_{p}": torch.tensor(v, dtype=torch.float64)
              for p, v in zip(("AC", "AT", "CG", "CT", "GT"), (0.3, 0.2, 0.25, 1.1, 0.4))}
    q_syn, q_non = model.basis_matrices(thetas)
    q = fill_diagonal_from_rows(q_syn + omega * q_non)
    left, lam, right = texpm.reversible_spectral(q, torch.tensor(pi))
    settled = texpm.settle_zero_modes(lam)
    assert int((settled == 0).sum()) == (21 if omega == 0 else 1)
    assert torch.equal(settled[settled != 0], lam[settled != 0])
    p = texpm.spectral_propagators(left, settled, right, torch.tensor([1e17], dtype=torch.float64))
    ref = scipy.linalg.expm(q.numpy() * 1e4) if omega == 0 else np.broadcast_to(pi, p[0].shape)
    np.testing.assert_allclose(p[0].numpy(), ref, rtol=0, atol=1e-10)
    # at an ordinary time the settled modes move P by the round-off they
    # carried (lam 1.8e-12 at omega 1e4)
    t = torch.tensor([0.05, 0.7], dtype=torch.float64)
    np.testing.assert_allclose(texpm.spectral_propagators(left, settled, right, t).numpy(),
                               texpm.spectral_propagators(left, lam, right, t).numpy(),
                               rtol=0, atol=1e-11)


def _nonreversible_generators(rng, n, s):
    """``n`` random non-reversible generators of ``s`` states, with rows of
    very different speeds (norms from ~0.01 to ~3e3, so the squaring
    ladder runs from 0 to 14 steps)."""
    q = rng.exponential(1.0, size=(n, s, s)) * rng.uniform(0.0, 1.0, size=(n, s, s)) ** 3
    q *= 10.0 ** rng.uniform(-3, 2, size=(n, 1, 1))
    idx = np.arange(s)
    q[:, idx, idx] = 0.0
    q[:, idx, idx] = -q.sum(-1)
    return q


@pytest.mark.parametrize("s, n", [(4, 16), (61, 8)])
def test_expm_and_transition_matrix(s, n):
    """``expm`` and ``transition_matrix`` against ``scipy.linalg.expm`` (the
    exact exponential, 1e-10 on every entry, absolute) and against the JAX
    package's functions (the same scaling, series and ladder: 1e-12) on
    non-reversible generators, the route of a non-reversible model."""
    import scipy.linalg as sla

    rng = np.random.default_rng(5)
    q = _nonreversible_generators(rng, n, s)
    t = rng.uniform(0.01, 2.0, size=n)
    ours_e = texpm.expm(torch.from_numpy(q)).numpy()
    ours_p = texpm.transition_matrix(torch.from_numpy(q), torch.from_numpy(t)).numpy()
    jax_e = np.asarray(jexpm.expm(jnp.asarray(q)))
    jax_p = np.asarray(jexpm.transition_matrix(jnp.asarray(q), jnp.asarray(t)))
    exact_e = np.stack([sla.expm(m) for m in q])
    exact_p = np.stack([sla.expm(m * tt) for m, tt in zip(q, t)])
    np.testing.assert_allclose(ours_e, exact_e, atol=1e-10, rtol=0)
    np.testing.assert_allclose(ours_p, exact_p, atol=1e-10, rtol=0)
    np.testing.assert_allclose(ours_e, jax_e, atol=1e-12, rtol=0)
    np.testing.assert_allclose(ours_p, jax_p, atol=1e-12, rtol=0)
    np.testing.assert_allclose(ours_p.sum(-1), 1.0, atol=1e-14)


def test_nonreversible_model_takes_the_transition_matrix_route():
    """A non-reversible model of more than 20 states builds its propagators
    by ``transition_matrix`` (the JAX package's ``models/base.py:90``),
    where the port raised before; at 20 states or fewer every model takes
    the shared-power Taylor route."""
    import scipy.linalg as sla

    from hyphy_tpu_torch.models.base import SubstitutionModel

    class Irreversible(SubstitutionModel):
        reversible = False

    rng = np.random.default_rng(6)
    q = _nonreversible_generators(rng, 1, 24)[0]
    t = np.array([0.05, 0.3, 1.2])
    p = Irreversible()._propagate(torch.from_numpy(q), None, torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(p, np.stack([sla.expm(q * tt) for tt in t]), atol=1e-10, rtol=0)

"""The port's ``MG94xREV`` (one omega) and ``MG94xREVLocal`` (per-branch
alpha and beta, ``MG94Base.propagators_local``) and ``frequencies.f1x4``
against the JAX package's, on a 6-taxon codon fixture.

fp64 lnL and gradients at well-conditioned branch lengths (ROADMAP 3.5:
the spectral route's round-off grows at short branches) to 1e-6 relative;
``f1x4`` equal; the fp32 per-branch route (the batched Taylor series, where
the JAX package takes an fp32 ``eigh``) against ``scipy.linalg.expm``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyphy_tpu as ht
from hyphy_tpu.data.genetic_code import GeneticCode as JGeneticCode
from hyphy_tpu.likelihood import LikelihoodFunction as JLikelihoodFunction
from hyphy_tpu.likelihood import Partition as JPartition
from hyphy_tpu.models import codon as jcodon
from hyphy_tpu.models import frequencies as jfreq
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.data.alignment import read_alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.data.genetic_code import GeneticCode
from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
from hyphy_tpu_torch.models import codon as tcodon
from hyphy_tpu_torch.models import frequencies as tfreq
from hyphy_tpu_torch.tree.topology import Tree
from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED = 6, 20, 13


@pytest.fixture(autouse=True)
def _on_cpu():
    saved = settings.device
    settings.device = "cpu"
    yield
    settings.device = saved


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    aln = synthetic_codon_alignment(N_TAXA, N_CODONS, seed=SEED)
    fa = tmp_path_factory.mktemp("codon_local") / "c.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    newick = random_tree_newick(N_TAXA, seed=SEED)
    jgc, gc = JGeneticCode("Universal"), GeneticCode("Universal")
    jfilt = ht.DataFilter.from_alignment(ht.read_alignment(str(fa)), "codon", genetic_code=jgc)
    filt = DataFilter.from_alignment(read_alignment(str(fa)), "codon", genetic_code=gc)
    return dict(jgc=jgc, gc=gc, jfilt=jfilt, filt=filt,
                jtree=ht.Tree.from_newick(newick, leaf_order=jfilt.names),
                tree=Tree.from_newick(newick, leaf_order=filt.names))


def test_f1x4_equal(data):
    jc, jp = jfreq.f1x4(data["jfilt"], data["jgc"])
    tc, tp = tfreq.f1x4(data["filt"], data["gc"])
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tp, jp)
    assert tp.sum() == pytest.approx(1.0, abs=1e-14)


def _pair(data, name, freqs):
    j = getattr(jfreq, freqs)(data["jfilt"], data["jgc"])
    t = getattr(tfreq, freqs)(data["filt"], data["gc"])
    jm = getattr(jcodon, name)(data["jgc"], *j)
    tm = getattr(tcodon, name)(data["gc"], *t, device="cpu")
    jlf = JLikelihoodFunction([JPartition(data["jfilt"], data["jtree"], jm)])
    lf = LikelihoodFunction([Partition(data["filt"], data["tree"], tm)], device="cpu")
    return jlf, lf


@pytest.mark.parametrize("name, freqs", [("MG94xREV", "f1x4"), ("MG94xREVLocal", "f3x4"),
                                         ("MG94xREVLocal", "f1x4")])
def test_lnl_gradient_and_lengths_match_jax(data, name, freqs):
    jlf, lf = _pair(data, name, freqs)
    assert sorted(jlf.specs) == sorted(lf.specs)
    rng = np.random.default_rng(5)
    point = {k: rng.uniform(0.08, 0.6, size=s.shape) if len(s.shape) else
             np.asarray(rng.uniform(0.3, 2.0)) for k, s in lf.specs.items()}
    jp = {k: jnp.asarray(v) for k, v in point.items()}
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in point.items()}
    jl, jg = jax.value_and_grad(jlf.loglik)(jp)
    tl = lf.loglik(tp)
    grads = torch.autograd.grad(tl, list(tp.values()))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    for (k, v), g in zip(tp.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-6, atol=1e-8)
    jm, tm = jlf.partitions[0].model, lf.partitions[0].model
    np.testing.assert_allclose(
        tm.branch_lengths({k: v.detach() for k, v in tp.items()}).numpy(),
        np.asarray(jm.branch_lengths(jp)), rtol=1e-12)


def test_local_propagators_fp32_route_is_taylor(data):
    """In fp32 ``propagators_local`` takes the batched Taylor series: held
    to ``scipy.linalg.expm`` of the fp64 generators (1e-5 absolute), where
    an fp32 eigendecomposition loses ~1e-2 on 61-state generators; in fp64
    the spectral route holds 1e-10."""
    import scipy.linalg as sla

    _, corners, freqs = (None, *tfreq.f3x4(data["filt"], data["gc"]))
    model = tcodon.MG94xREVLocal(data["gc"], corners, freqs, device="cpu")
    rng = np.random.default_rng(6)
    thetas = {f"theta_{p}": torch.tensor(rng.uniform(0.3, 2.0), dtype=torch.float64)
              for p in ("AC", "AT", "CG", "CT", "GT")}
    alpha = rng.uniform(0.01, 1.5, size=7)
    beta = rng.uniform(0.01, 3.0, size=7)
    q_syn, q_non = (m.numpy() for m in model.basis_matrices(thetas))
    exact = []
    for a, b in zip(alpha, beta):
        q = a * q_syn + b * q_non
        np.fill_diagonal(q, -q.sum(1))
        exact.append(sla.expm(q))
    exact = np.stack(exact)
    p64 = model.propagators_local(model.basis_matrices(thetas), torch.tensor(alpha),
                                  torch.tensor(beta)).numpy()
    np.testing.assert_allclose(p64, exact, atol=1e-10, rtol=0)
    t32 = {k: v.float() for k, v in thetas.items()}
    p32 = model.propagators_local(model.basis_matrices(t32), torch.tensor(alpha).float(),
                                  torch.tensor(beta).float())
    assert p32.dtype == torch.float32
    np.testing.assert_allclose(p32.double().numpy(), exact, atol=1e-5, rtol=0)


def test_local_fit_leaves_its_initial_point_in_fp32(data):
    """At MG94xREVLocal's initial point (alpha = beta on every branch, the
    thetas equal) the generators' spectra are degenerate, and the gradient
    of an eigendecomposition divides by eigenvalue gaps: the JAX package's
    gradient is NaN there and its fit ends where it starts (ROADMAP 3.26).
    The port's fp32 route, the batched Taylor series, has a finite gradient
    at that point (its fp64 route keeps the JAX package's spectral one)."""
    jlf, lf = _pair(data, "MG94xREVLocal", "f1x4")
    init = {k: v for k, v in jlf.initial_parameters().items()}
    jg = jax.grad(jlf.loglik)(init)
    assert not all(bool(jnp.isfinite(g).all()) for g in jg.values())
    lf32 = LikelihoodFunction(lf.partitions, dtype=torch.float32, device="cpu")
    p = {k: v.clone().requires_grad_() for k, v in lf32.initial_parameters().items()}
    grads = torch.autograd.grad(lf32.loglik(p), list(p.values()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert max(float(g.abs().max()) for g in grads) > 0

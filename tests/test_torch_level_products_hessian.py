"""Second derivatives through K1's wrapper.

The wrapper's backward takes the VJP of the plain version; under
``create_graph`` it must keep a graph back to the level's inputs, or every
second derivative through the pruning is silently 0 (and
``LikelihoodFunction.covariance_matrix`` inverts a zero information
matrix).  Held here: the Hessian through ``level_products`` against the
Hessian through ``level_products_reference`` (fp64, 1e-10 relative), and a
Hessian of ``LikelihoodFunction.loglik`` against central differences of
its autograd gradient.
"""

import numpy as np
import pytest
import torch

from hyphy_tpu_torch.ops.level_products import level_products, level_products_reference

torch.set_num_threads(2)


def _scalar_of_level(fn, cc0, cp0):
    """A smooth scalar of three parameters through one level step: the
    children's vectors and propagators depend on them nonlinearly."""
    def f(x):
        cc = (cc0 * torch.exp(x[0] * cc0) + x[2] ** 2).contiguous()
        cp = (cp0 * x[1] + cp0.square() * x[0] * x[2]).contiguous()
        return torch.log(fn(cc, cp)).sum()
    return f


@pytest.mark.parametrize("states", [61, 20, 4, 2])
@pytest.mark.parametrize("arity", [2, 5])
def test_hessian_equals_the_plain_versions(states, arity):
    rng = np.random.default_rng(states * 10 + arity)
    cc0 = torch.from_numpy(rng.uniform(0.1, 1.0, size=(3, arity, 17, states)))
    cp0 = torch.from_numpy(rng.uniform(0.0, 0.2, size=(3, arity, states, states)))
    x = torch.tensor([0.3, 1.2, 0.4], dtype=torch.float64)
    ours = torch.autograd.functional.hessian(_scalar_of_level(level_products, cc0, cp0), x)
    plain = torch.autograd.functional.hessian(
        _scalar_of_level(level_products_reference, cc0, cp0), x)
    assert torch.count_nonzero(plain) == plain.numel()
    rel = float((ours - plain).abs().max() / plain.abs().max())
    assert rel <= 1e-10, rel


def test_loglik_hessian_matches_central_differences():
    """A GTR likelihood on 6 taxa: the autograd Hessian over two exchange-
    abilities and three branch times, through every pruning level's K1,
    equals central differences of the autograd gradient (step 1e-5,
    relative to the Hessian's largest entry: 1e-6)."""
    from hyphy_tpu_torch.data.filter import DataFilter
    from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
    from hyphy_tpu_torch.models.dna import GTR
    from hyphy_tpu_torch.tree.topology import Tree
    from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment

    aln = synthetic_codon_alignment(6, 30, seed=7)
    filt = DataFilter.from_alignment(aln, "nucleotide")
    tree = Tree.from_newick(random_tree_newick(6, seed=7), leaf_order=filt.names)
    model = GTR(filt.harvest_frequencies(1, 1, False)[:, 0], device="cpu")
    lf = LikelihoodFunction([Partition(filt, tree, model)], device="cpu")
    rng = np.random.default_rng(8)
    base = {k: torch.as_tensor(rng.uniform(0.3, 1.5, size=s.shape) * (0.2 if k == "t" else 1.0))
            for k, s in lf.specs.items()}

    def loglik(x):
        p = dict(base)
        p["theta_AC"], p["theta_CT"] = x[0], x[1]
        p["t"] = torch.cat([x[2:], base["t"][3:]])
        return lf.loglik(p)

    x0 = torch.cat([base["theta_AC"][None], base["theta_CT"][None], base["t"][:3]])
    hess = torch.autograd.functional.hessian(loglik, x0).numpy()

    def grad(x):
        x = x.clone().requires_grad_(True)
        return torch.autograd.grad(loglik(x), x)[0].numpy()

    h = 1e-5
    fd = np.stack([(grad(x0 + h * e) - grad(x0 - h * e)) / (2 * h)
                   for e in torch.eye(len(x0), dtype=torch.float64)])
    scale = np.abs(hess).max()
    assert scale > 1.0
    np.testing.assert_allclose(hess, hess.T, atol=1e-10 * scale, rtol=0)
    np.testing.assert_allclose(hess, fd, atol=1e-6 * scale, rtol=0)

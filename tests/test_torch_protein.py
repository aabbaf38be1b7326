"""The port's protein models and the protein gene path against the JAX
package's.

* The port's own copy of the 14 empirical matrices (byte for byte the JAX
  package's files, read from the port's ``resources/``), and every model's
  ``q_matrix`` and propagators equal to the JAX package's (1e-12); the
  general REV model's at a random point.
* ``frequencies.empirical_character`` equal on a simulated alignment.
* The protein gene lnL through ``LikelihoodFunction`` at a carried point
  (1e-9 relative) and its gradient, and the baseline fit with free branch
  lengths within 0.15 lnL (``tests/test_optimizer_parity.py``'s tolerance).
* K1's launch plan, the level plans and the grid sizing at 20 states.

The fixture is an alignment of 8 taxa x 40 residues simulated under WAG
with the port's ``simulate_states``."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu.data.filter import DataFilter as JDataFilter
from hyphy_tpu.likelihood import LikelihoodFunction as JLikelihoodFunction
from hyphy_tpu.likelihood import Partition as JPartition
from hyphy_tpu.models import frequencies as jfreq
from hyphy_tpu.models import protein as jprotein
from hyphy_tpu.tree.topology import Tree as JTree
from hyphy_tpu_torch.convert import params_from_numpy
from hyphy_tpu_torch.data.alignment import Alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
from hyphy_tpu_torch.models import frequencies as tfreq
from hyphy_tpu_torch.models import protein
from hyphy_tpu_torch.ops import level_products as lp
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.tree.topology import Tree
from tests.torch_carry import protein_alignment

torch.set_num_threads(2)

N_TAXA, N_SITES, SEED = 8, 40, 3
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def aln():
    names, seqs, newick = protein_alignment(N_TAXA, N_SITES, SEED)
    a = Alignment(names=names, sequences=seqs)
    # every residue present: the +F frequencies have no zero
    assert (tfreq.empirical_character(DataFilter.from_alignment(a, "protein")) > 0).all()
    return {"aln": a, "newick": newick}


def test_resources_are_the_ports_own_copy():
    ours = sorted((REPO / "hyphy_tpu_torch" / "resources" / "protein").glob("*.json"))
    theirs = sorted((REPO / "hyphy_tpu" / "resources" / "protein").glob("*.json"))
    assert [p.name for p in ours] == [p.name for p in theirs]
    assert len(ours) == len(protein.EMPIRICAL_MODELS) == 14
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes(), a.name
    resource_dir = pathlib.Path(protein.RESOURCE_DIR).resolve()
    assert resource_dir == (REPO / "hyphy_tpu_torch" / "resources" / "protein").resolve()
    assert "hyphy_tpu_torch" in resource_dir.parts


@pytest.mark.parametrize("name", protein.EMPIRICAL_MODELS)
def test_empirical_model_matches(name):
    rng = np.random.default_rng(3)
    t = rng.uniform(0.001, 2.0, size=9)
    freqs = rng.dirichlet(np.ones(20))
    for f in (None, freqs):
        ours = protein.EmpiricalProtein(name, frequencies=f, device="cpu")
        ref = jprotein.EmpiricalProtein(name, frequencies=f)
        np.testing.assert_array_equal(ours.exchangeabilities, ref.exchangeabilities)
        np.testing.assert_array_equal(ours.frequencies.numpy(), np.asarray(ref.frequencies))
        tp = {"t": torch.tensor(t)}
        np.testing.assert_allclose(ours.q_matrix(tp).numpy(),
                                   np.asarray(ref.q_matrix({"t": jnp.asarray(t)})),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(ours.build(tp, 9).p_matrices.numpy(),
                                   np.asarray(ref.build({"t": jnp.asarray(t)}, 9).p_matrices),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(ours.branch_lengths(tp).numpy(),
                                   np.asarray(ref.branch_lengths({"t": jnp.asarray(t)})),
                                   rtol=1e-12)


def test_protein_rev_matches():
    rng = np.random.default_rng(5)
    freqs = rng.dirichlet(np.ones(20))
    ours = protein.ProteinREV(freqs, device="cpu")
    ref = jprotein.ProteinREV(freqs)
    specs = ours.parameter_specs(5)
    ref_specs = ref.parameter_specs(5)
    assert list(specs) == list(ref_specs)
    assert all((s.init, s.lower, s.upper, s.shape) == (r.init, r.lower, r.upper, r.shape)
               for s, r in zip(specs.values(), ref_specs.values()))
    point = {k: rng.uniform(0.1, 3.0, size=s.shape) for k, s in specs.items()}
    ours_p = params_from_numpy(point, "cpu")
    ref_p = {k: jnp.asarray(v) for k, v in point.items()}
    np.testing.assert_allclose(ours.q_matrix(ours_p).numpy(), np.asarray(ref.q_matrix(ref_p)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.build(ours_p, 5).p_matrices.numpy(),
                               np.asarray(ref.build(ref_p, 5).p_matrices), rtol=0, atol=1e-12)


def test_empirical_character_matches(aln):
    ours = DataFilter.from_alignment(aln["aln"], "protein")
    ref = JDataFilter.from_alignment(aln["aln"], "protein")
    np.testing.assert_array_equal(tfreq.empirical_character(ours),
                                  jfreq.empirical_character(ref))
    np.testing.assert_array_equal(ours.leaf_partials(), ref.leaf_partials())


def _both(aln, name="LG"):
    filt = DataFilter.from_alignment(aln["aln"], "protein")
    jfilt = JDataFilter.from_alignment(aln["aln"], "protein")
    tree = Tree.from_newick(aln["newick"], leaf_order=filt.names)
    jtree = JTree.from_newick(aln["newick"], leaf_order=jfilt.names)
    freqs = tfreq.empirical_character(filt)
    lf = LikelihoodFunction([Partition(filt, tree, protein.EmpiricalProtein(
        name, frequencies=freqs, device="cpu"))], device="cpu")
    jlf = JLikelihoodFunction([JPartition(jfilt, jtree, jprotein.EmpiricalProtein(
        name, frequencies=freqs))])
    return lf, jlf, tree


@pytest.mark.parametrize("name", ["LG", "WAG", "JTT"])
def test_gene_loglik_matches(aln, name):
    lf, jlf, tree = _both(aln, name)
    t = np.asarray(tree.input_lengths[:-1]) * np.linspace(0.5, 1.5, tree.n_branches)
    params = {"t": torch.tensor(t, requires_grad=True)}
    ours = lf.loglik(params)
    want = float(jlf.loglik({"t": jnp.asarray(t)}))
    assert abs(float(ours.detach()) - want) <= 1e-9 * abs(want)
    np.testing.assert_allclose(lf.site_log_likelihoods(params)[0].detach().numpy(),
                               np.asarray(jlf.site_log_likelihoods({"t": jnp.asarray(t)})[0]),
                               rtol=1e-9)
    grad, = torch.autograd.grad(ours, params["t"])
    import jax

    jgrad = jax.grad(lambda x: jlf.loglik({"t": x}))(jnp.asarray(t))
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-9)


def test_gene_fit_matches(aln):
    lf, jlf, tree = _both(aln)
    init = np.maximum(tree.input_lengths[:-1], 1e-6)
    ours = lf.fit(init={"t": torch.tensor(init)}, precision=1e-5)
    want = jlf.fit(init={"t": jnp.asarray(init)}, precision=1e-5)
    assert abs(ours.loglik - want.loglik) <= 0.15
    assert ours.n_free_parameters == want.n_free_parameters == tree.n_branches


def test_launch_plan_and_grid_sizing_at_20_states(aln):
    """K1 at S = 20 takes 4 state groups of 8 in fp32 and 8 of 4 in fp64
    (32 state rows either way), runs its plain version on the CPU, and the
    grid form's sizing walks the protein tree's levels."""
    assert lp._launch_plan(320, 2, 2048, 20, torch.float32)[:3] == (4, 8, 512)
    assert lp._launch_plan(320, 2, 2048, 20, torch.float64)[:3] == (8, 8, 256)
    gen = torch.Generator().manual_seed(0)
    cc = torch.rand((5, 2, 33, 20), generator=gen, dtype=torch.float64)
    cp = torch.rand((5, 2, 20, 20), generator=gen, dtype=torch.float64)
    np.testing.assert_allclose(lp.level_products(cc, cp).numpy(),
                               np.einsum("wkij,wkpj->wkpi", cp.numpy(), cc.numpy()).prod(1),
                               rtol=1e-12)
    filt = DataFilter.from_alignment(aln["aln"], "protein")
    tree = Tree.from_newick(aln["newick"], leaf_order=filt.names)
    data = pruning.build_pruning_data(tree, "cpu")
    widest = max(len(lv) for lv in tree.levels())
    assert pruning.max_grid_points(data) == lp._MAX_NODES // widest
    per_point = pruning.grid_point_bytes(data, filt.n_patterns, 20, 4)
    assert per_point == pruning.grid_point_bytes(data, filt.n_patterns, 61, 4) * 20 / 61
    # grid points folded into K1's node axis give each point's one-set value
    lf, _, _ = _both(aln)
    t = torch.tensor(np.asarray(tree.input_lengths[:-1]))
    model = lf.partitions[0].model
    p = torch.stack([model.build({"t": t * s}, tree.n_branches).p_matrices for s in (0.5, 2.0)])
    leaves = torch.as_tensor(filt.leaf_partials())
    folded = pruning.site_log_likelihoods(p, leaves, model.frequencies, data)
    for g, s in enumerate((0.5, 2.0)):
        alone = lf.site_log_likelihoods({"t": t * s})[0]
        np.testing.assert_allclose(folded[g].numpy(), alone.numpy(), rtol=1e-12)

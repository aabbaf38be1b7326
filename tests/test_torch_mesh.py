"""The device mesh of the port (``hyphy_tpu_torch/parallel/mesh.py``) on
the CPU, as ``("cpu",) * k``: the pattern axis of every likelihood and the
items of FEL's per-site solves split over ``k`` blocks give the numbers of
one device, and the port under a mesh gives the JAX package's numbers
under its own 8-device mesh (``tests/conftest.py``).  The automatic mesh's
rule (every card only for a likelihood one card cannot hold) is held on a
host of cards that the tests make up.

The fixture is ``tests/test_mesh_analysis.py``'s: 6 taxa x 21 codons,
seed 3 (21 codon and 31 nucleotide patterns: 7/7/7 and 11/10/10 over
three blocks, 6/5/5/5 and 8/8/8/7 over four).

A whole analysis run sharded is not bit-equal to one unsharded: the
gradient of a gene fit sums each block's contribution apart, so L-BFGS
ends a few ulps elsewhere, and every later stage starts from there (the
JAX package's ``test_mesh_analysis.py`` says the same of its ``psum``).
FEL's per-site stage is therefore held on the sharded run's own global
fit, and the gene fits within the fit's own precision."""

import numpy as np
import pytest
import torch

import hyphy_tpu as ht
from hyphy_tpu.likelihood import LikelihoodFunction as JLikelihoodFunction
from hyphy_tpu.likelihood import Partition as JPartition
from hyphy_tpu.models import frequencies as jfreq
from hyphy_tpu.models.bsrel import BSRELEngine as JBSRELEngine
from hyphy_tpu.models.codon import MG94Base as JMG94Base
from hyphy_tpu.models.codon import MG94xREVPartitionedOmega as JMG94
from hyphy_tpu.models.dna import GTR as JGTR
from hyphy_tpu.ops import pruning as jpruning
import hyphy_tpu_torch.methods.common as tcommon
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.data.alignment import read_alignment
from hyphy_tpu_torch.data.filter import DataFilter
from hyphy_tpu_torch.data.genetic_code import GeneticCode
from hyphy_tpu_torch.likelihood import LikelihoodFunction, Partition
from hyphy_tpu_torch.methods import fel
from hyphy_tpu_torch.models import frequencies as tfreq
from hyphy_tpu_torch.models.bsrel import BSRELEngine
from hyphy_tpu_torch.models.codon import (
    MG94Base, MG94xREVMultiHitGDD, MG94xREVPartitionedOmega,
)
from hyphy_tpu_torch.models.dna import GTR
from hyphy_tpu_torch.ops import pruning
from hyphy_tpu_torch.optimize import batched
from hyphy_tpu_torch.parallel import mesh as mesh_mod
from hyphy_tpu_torch.tree.topology import Tree
from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment

torch.set_num_threads(2)

N_TAXA, N_CODONS, SEED = 6, 21, 3
THREE = ("cpu",) * 3
LNL_REL, GRAD_REL, SITE_ATOL = 1e-12, 1e-10, 1e-9


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setattr(settings, "mesh", None)
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    monkeypatch.delenv("HYPHY_TPU_MESH", raising=False)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    aln = synthetic_codon_alignment(N_TAXA, N_CODONS, seed=SEED)
    fa = tmp_path_factory.mktemp("mesh_tiny") / "tiny.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    return {"fasta": str(fa), "tree": random_tree_newick(N_TAXA, seed=SEED)}


# -- the mesh itself --------------------------------------------------------------


def test_default_mesh_rules(monkeypatch):
    assert settings.default_mesh("cpu") is None            # no card: no mesh
    monkeypatch.setattr(settings, "mesh", THREE)
    assert settings.default_mesh("cpu") == (torch.device("cpu"),) * 3
    monkeypatch.setenv("HYPHY_TPU_MESH", "off")
    assert settings.default_mesh("cpu") is None
    monkeypatch.delenv("HYPHY_TPU_MESH")
    monkeypatch.setattr(settings, "mesh", ("cpu",))
    assert settings.default_mesh("cpu") is None            # one device is no mesh


GB = 1e9


@pytest.mark.parametrize("n_cards,device,nbytes,expected", [
    (4, "cuda:0", 10 * GB, None),                          # fits on one card
    (4, "cuda:0", 50 * GB, (0, 1, 2, 3)),                  # past half its free 80 GB
    (4, "cuda:0", 100 * GB, (0, 1, 2, 3)),
    (4, "cuda:0", None, None),                             # a per-site solve
    (1, "cuda:0", 100 * GB, None),                         # one card
    (2, "cuda:1", 100 * GB, (1, 0)),                       # the analysis's card first
])
def test_auto_mesh_only_where_one_card_cannot_hold(monkeypatch, n_cards, device, nbytes,
                                                   expected):
    """The automatic mesh on a made-up host of cards with 80 GB free each:
    every card, the analysis's first, only for a working set past half of
    one card's free memory; ``HYPHY_TPU_MESH=off`` and a one-card
    ``settings.mesh`` keep it off."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (80 * GB, 85 * GB))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    want = None if expected is None else tuple(torch.device("cuda", i) for i in expected)
    assert settings.default_mesh(device, nbytes) == want
    assert mesh_mod.resolve_mesh("auto", device, nbytes) == want
    monkeypatch.setenv("HYPHY_TPU_MESH", "off")
    assert settings.default_mesh(device, nbytes) is None
    monkeypatch.delenv("HYPHY_TPU_MESH")
    monkeypatch.setattr(settings, "mesh", (device,))
    assert settings.default_mesh(device, nbytes) is None


def test_mesh_naming_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(settings, "mesh", ("cpu", "cuda:0"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        settings.default_mesh("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_mod.data_mesh(["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="starts on"):
        mesh_mod.resolve_mesh(("cpu",) * 2, "meta")


@pytest.mark.parametrize("n_items,k,sizes", [(21, 3, [7, 7, 7]), (21, 4, [6, 5, 5, 5]),
                                              (31, 3, [11, 10, 10]), (2, 3, [1, 1])])
def test_shards_are_contiguous_and_near_equal(n_items, k, sizes):
    blocks = mesh_mod.shards(n_items, mesh_mod.data_mesh(["cpu"] * k))
    assert [hi - lo for _, lo, hi in blocks] == sizes
    assert blocks[0][1] == 0 and blocks[-1][2] == n_items
    assert all(a[2] == b[1] for a, b in zip(blocks, blocks[1:]))


def test_sharded_site_solve_joins_in_item_order(monkeypatch):
    seen = []

    def make_solver(dev):
        def solver(idx):
            seen.append(idx.tolist())
            return {"sq": idx.double() ** 2, "row": torch.stack([idx, -idx], dim=1)}
        return solver

    monkeypatch.setattr(settings, "mesh", THREE)
    out = mesh_mod.sharded_site_solve(make_solver, 10, 1.0, "cpu")
    # the blocks run from threads of their own, in no set order
    assert sorted(seen) == [[0, 1, 2, 3], [4, 5, 6], [7, 8, 9]]
    np.testing.assert_array_equal(out["sq"].numpy(), np.arange(10) ** 2)
    np.testing.assert_array_equal(out["row"].numpy(),
                                  np.stack([np.arange(10), -np.arange(10)], axis=1))


# -- the gene likelihood ----------------------------------------------------------


def _gene(tiny, kind):
    aln = read_alignment(tiny["fasta"])
    gc = GeneticCode("Universal")
    if kind == "gtr":
        filt = DataFilter.from_alignment(aln, "nucleotide")
        jfilt = ht.DataFilter.from_alignment(ht.read_alignment(tiny["fasta"]), "nucleotide")
        freqs = filt.harvest_frequencies(1, 1, False)[:, 0]
        model, jmodel = GTR(freqs, device="cpu"), JGTR(freqs)
    else:
        filt = DataFilter.from_alignment(aln, "codon", genetic_code=gc)
        jfilt = ht.DataFilter.from_alignment(ht.read_alignment(tiny["fasta"]), "codon",
                                             genetic_code=ht.GeneticCode("Universal"))
        corners, codon_freqs = tfreq.f3x4(filt, gc)
    tree = Tree.from_newick(tiny["tree"], leaf_order=filt.names)
    jtree = ht.Tree.from_newick(tiny["tree"], leaf_order=jfilt.names)
    nb = tree.n_branches
    if kind == "mg94":
        args = (corners, codon_freqs, np.maximum(tree.input_lengths[:-1], 1e-3),
                np.zeros(nb, np.int32), 1)
        model = MG94xREVPartitionedOmega(gc, *args, free_lengths=True, device="cpu")
        jmodel = JMG94(ht.GeneticCode("Universal"), *args, free_lengths=True)
    # distinct thetas and branches of 0.2-0.5: the spectral route is well
    # conditioned there (equal thetas make its eigh backward divide by ~0
    # gaps, and short branches part the two packages' eigensolvers,
    # ROADMAP 3.5)
    point = {f"theta_{p}": v for p, v in zip(("AC", "AT", "CG", "CT", "GT"),
                                             (0.4, 0.3, 0.6, 1.4, 0.5))}
    if kind == "gtr":
        point["t"] = np.maximum(tree.input_lengths[:-1], 1e-3)
    else:
        point.update(alpha=np.linspace(0.2, 0.5, nb), omega=np.array([0.3]))
    return filt, tree, model, (jfilt, jtree, jmodel), point


def _value_and_grad(lf, point):
    params = {k: torch.as_tensor(np.asarray(v, np.float64)) for k, v in point.items()}
    for k, s in lf.specs.items():
        params.setdefault(k, s.initial("cpu"))
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    value = lf.loglik(params)
    value.backward()
    return value.item(), {k: v.grad.numpy() for k, v in params.items()}, params


def _hold_grads(got, ref, rel):
    """The whole gradient (every key's entries as one vector) within ``rel``
    of ``ref`` in norm: the blocks' contributions are summed apart, and
    the spectral route's gradient amplifies that round-off (its eigh
    backward divides by eigenvalue gaps), so a small entry is held to the
    gradient's scale, not to its own."""
    a = np.concatenate([np.ravel(got[k]) for k in sorted(ref)])
    b = np.concatenate([np.ravel(ref[k]) for k in sorted(ref)])
    assert np.linalg.norm(a - b) <= rel * np.linalg.norm(b), (
        np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("kind", ["gtr", "mg94"])
def test_lf_sharded_equals_unsharded(tiny, kind, k):
    filt, tree, model, _, point = _gene(tiny, kind)
    lf0 = LikelihoodFunction([Partition(filt, tree, model)], mesh=None)
    lfk = LikelihoodFunction([Partition(filt, tree, model)], mesh=("cpu",) * k)
    assert lf0.mesh is None and len(lfk.mesh) == k
    v0, g0, params = _value_and_grad(lf0, point)
    vk, gk, _ = _value_and_grad(lfk, point)
    assert abs(vk - v0) <= LNL_REL * abs(v0)
    _hold_grads(gk, g0, GRAD_REL)
    with torch.no_grad():
        (s0,), (sk,) = lf0.site_log_likelihoods(params), lfk.site_log_likelihoods(params)
    assert sk.shape == (filt.n_patterns,)                   # the true width
    np.testing.assert_allclose(sk.numpy(), s0.numpy(), rtol=0, atol=1e-12)


def test_lf_auto_mesh_follows_settings(tiny, monkeypatch):
    filt, tree, model, _, point = _gene(tiny, "gtr")
    monkeypatch.setattr(settings, "mesh", THREE)
    assert len(LikelihoodFunction([Partition(filt, tree, model)]).mesh) == 3
    monkeypatch.setenv("HYPHY_TPU_MESH", "off")
    assert LikelihoodFunction([Partition(filt, tree, model)]).mesh is None


def test_auto_mesh_reads_the_working_set(tiny, monkeypatch):
    """``mesh="auto"`` hands ``default_mesh`` the value-and-gradient
    working set of its partitions, a class mixture's once per class; so
    does the BS-REL engine, once per synonymous-rate class."""
    seen = []
    monkeypatch.setattr(settings, "default_mesh",
                        lambda device=None, nbytes=None: seen.append(nbytes))
    filt, tree, model, _, _ = _gene(tiny, "gtr")
    assert LikelihoodFunction([Partition(filt, tree, model)]).mesh is None
    pdata = pruning.build_pruning_data(tree, "cpu")
    assert seen[-1] == pruning.gene_bytes(pdata, filt.n_patterns, 4, 8) > 0
    gc, cfilt, ctree, corners, codon_freqs, group, _ = _bsrel_inputs(tiny)
    gdd = MG94xREVMultiHitGDD(gc, corners, codon_freqs, np.zeros(ctree.n_branches, np.int64),
                              1, hits="Double", rate_classes=3, device="cpu")
    LikelihoodFunction([Partition(cfilt, ctree, gdd)])
    cdata = pruning.build_pruning_data(ctree, "cpu")
    one = pruning.gene_bytes(cdata, cfilt.n_patterns, 61, 8)
    assert seen[-1] == 3 * one
    BSRELEngine(MG94Base(gc, corners, codon_freqs, device="cpu"), cdata, cfilt.leaf_partials(),
                cfilt.pattern_weights, group, srv_classes=2)
    assert seen[-1] == 2 * one


@pytest.mark.parametrize("kind", ["gtr", "mg94"])
def test_lf_matches_jax_under_its_mesh(tiny, kind):
    import jax.numpy as jnp

    filt, tree, model, (jfilt, jtree, jmodel), point = _gene(tiny, kind)
    jlf = JLikelihoodFunction([JPartition(jfilt, jtree, jmodel)])     # mesh="auto": 8 devices
    assert jlf.mesh is not None and jlf.mesh.devices.size == 8
    lf = LikelihoodFunction([Partition(filt, tree, model)], mesh=THREE)
    full = {k: np.asarray(s.initial(), np.float64) for k, s in jlf.specs.items()}
    full.update(point)
    ref = float(jlf.loglik({k: jnp.asarray(v) for k, v in full.items()}))
    value, _, _ = _value_and_grad(lf, full)
    assert abs(value - ref) <= 1e-8


def test_class_mixture_and_covariance_sharded(tiny):
    """The class mixture (FitMultiModel's GDD: 3 classes folded into K1's
    node axis) and the autograd Hessian through the blocks' copies."""
    aln = read_alignment(tiny["fasta"])
    gc = GeneticCode("Universal")
    filt = DataFilter.from_alignment(aln, "codon", genetic_code=gc)
    tree = Tree.from_newick(tiny["tree"], leaf_order=filt.names)
    corners, codon_freqs = tfreq.f3x4(filt, gc)
    model = MG94xREVMultiHitGDD(gc, corners, codon_freqs, np.zeros(tree.n_branches, np.int64),
                                1, hits="Double", rate_classes=3, device="cpu")
    lf0 = LikelihoodFunction([Partition(filt, tree, model)], mesh=None)
    lf3 = LikelihoodFunction([Partition(filt, tree, model)], mesh=THREE)
    point = {"alpha": np.linspace(0.05, 0.4, tree.n_branches),
             "omega_c": np.array([0.1, 0.8, 3.0]), "omega_w": np.array([0.5, 0.6])}
    v0, g0, params = _value_and_grad(lf0, point)
    v3, g3, _ = _value_and_grad(lf3, point)
    assert abs(v3 - v0) <= 1e-9 * abs(v0)
    _hold_grads(g3, g0, 1e-9)
    keys = ["theta_AC", "omega_c", "delta"]
    params = {k: v.detach() for k, v in params.items()}
    cov0, labels0 = lf0.covariance_matrix(params, keys)
    cov3, labels3 = lf3.covariance_matrix(params, keys)
    assert labels0 == labels3 and cov0.shape == (5, 5)
    np.testing.assert_allclose(cov3, cov0, rtol=1e-9, atol=1e-9 * np.abs(cov0).max())


# -- the BS-REL engine ------------------------------------------------------------


def _bsrel_inputs(tiny):
    aln = read_alignment(tiny["fasta"])
    gc = GeneticCode("Universal")
    filt = DataFilter.from_alignment(aln, "codon", genetic_code=gc)
    tree = Tree.from_newick(tiny["tree"], leaf_order=filt.names)
    corners, codon_freqs = tfreq.f3x4(filt, gc)
    group = np.zeros(tree.n_branches, dtype=np.int64)
    point = dict(
        params={f"theta_{p}": v for p, v in zip(("AC", "AT", "CG", "CT", "GT"),
                                                 (0.4, 0.3, 0.6, 1.4, 0.5))},
        omegas=np.array([[0.2, 1.0, 3.0]]), weights=np.array([[0.6, 0.3, 0.1]]),
        t_b=np.linspace(0.03, 0.2, tree.n_branches), srv_rates=np.array([0.5, 1.5]),
        srv_weights=np.array([0.4, 0.6]))
    return gc, filt, tree, corners, codon_freqs, group, point


def _engine_value(engine, point):
    args = {k: (torch.tensor(v, requires_grad=True) if k == "t_b" else
                {n: torch.tensor(x, requires_grad=True) for n, x in v.items()} if k == "params"
                else torch.tensor(v)) for k, v in point.items()}
    value = engine.loglik(args["params"], args["omegas"], args["weights"], args["t_b"],
                          args["srv_rates"], args["srv_weights"])
    value.backward()
    grads = {n: x.grad.numpy() for n, x in args["params"].items()}
    grads["t_b"] = args["t_b"].grad.numpy()
    return value.item(), grads


def test_bsrel_engine_sharded(tiny):
    import jax.numpy as jnp

    gc, filt, tree, corners, codon_freqs, group, point = _bsrel_inputs(tiny)
    mg94 = MG94Base(gc, corners, codon_freqs, device="cpu")
    args = (mg94, pruning.build_pruning_data(tree, "cpu"), filt.leaf_partials(),
            filt.pattern_weights, group)
    e0 = BSRELEngine(*args, srv_classes=2, mesh=None)
    e3 = BSRELEngine(*args, srv_classes=2, mesh=THREE)
    assert e0.mesh is None and len(e3.mesh) == 3
    v0, g0 = _engine_value(e0, point)
    v3, g3 = _engine_value(e3, point)
    assert abs(v3 - v0) <= LNL_REL * abs(v0)
    _hold_grads(g3, g0, GRAD_REL)
    # the JAX engine under its 8-device mesh (patterns padded to 24)
    jfilt = ht.DataFilter.from_alignment(ht.read_alignment(tiny["fasta"]), "codon",
                                         genetic_code=ht.GeneticCode("Universal"))
    jtree = ht.Tree.from_newick(tiny["tree"], leaf_order=jfilt.names)
    jcorners, jcodon = jfreq.f3x4(jfilt, ht.GeneticCode("Universal"))
    je = JBSRELEngine(JMG94Base(ht.GeneticCode("Universal"), jcorners, jcodon),
                      jpruning.build_pruning_data(jtree), jfilt.leaf_partials(),
                      jfilt.pattern_weights, group.astype(np.int32), srv_classes=2)
    assert je.mesh is not None
    p = point
    ref = float(je.loglik({k: jnp.asarray(v) for k, v in p["params"].items()},
                          jnp.asarray(p["omegas"]), jnp.asarray(p["weights"]),
                          jnp.asarray(p["t_b"]), jnp.asarray(p["srv_rates"]),
                          jnp.asarray(p["srv_weights"])))
    assert abs(v3 - ref) <= 1e-8 * abs(ref)


# -- the per-site stages ------------------------------------------------------------


def test_fel_run_sharded(tiny, monkeypatch):
    """FEL as a user runs it under ``settings.mesh``: every gene fit and the
    per-site stage over three blocks.  The gene fits land within their
    precision of the unsharded run's; the site table equals the unsharded
    per-site stage's on the sharded run's own global fit."""
    ref = fel.run(tiny["fasta"], tree=tiny["tree"])
    monkeypatch.setattr(settings, "mesh", THREE)
    res = fel.run(tiny["fasta"], tree=tiny["tree"])
    assert abs(res.gtr.loglik - ref.gtr.loglik) <= 1e-6
    assert abs(res.mg94.loglik - ref.mg94.loglik) <= 1e-6
    monkeypatch.setattr(settings, "mesh", None)
    one, _ = fel.solve_partition(res.data, res.mg94)
    assert res.site_table.shape == one.shape
    np.testing.assert_allclose(res.site_table, one, rtol=0, atol=SITE_ATOL)


def test_fel_options_sharded_equal_the_same_blocks_chunked(tiny, monkeypatch):
    """``--ci`` and ``--resample`` over three blocks: the mesh's blocks give
    what one device gives in chunks of the same items (capped fits:
    ``warmup``; without SRV the profile has no nuisance to refit, so its
    steps are single batched evaluations).  (The CPU's fp64
    spectral route rounds a site's last bits by its batch's size, which a
    CI bisection at its threshold amplifies: one device's single batch is
    not the reference here, its 7-item chunks are.)"""
    monkeypatch.setattr(settings, "warmup", True)
    data = tcommon.load_codon_data(tiny["fasta"], tree_newick=tiny["tree"])
    gtr = tcommon.fit_gtr(data)
    mg = tcommon.fit_partitioned_mg94(data, gtr)
    assert data.codon_filter.n_patterns == 21
    monkeypatch.setattr(settings, "mesh", THREE)
    sharded, headers = fel.solve_partition(data, mg, srv=False, ci=True, resample=2,
                                           resample_seed=5)
    monkeypatch.setattr(settings, "mesh", None)
    monkeypatch.setattr(batched, "site_chunk", lambda n_items, bytes_per_item, device, free=None: 7)
    chunked, _ = fel.solve_partition(data, mg, srv=False, ci=True, resample=2, resample_seed=5)
    assert [h[0] for h in headers][6:] == ["dN/dS LB", "dN/dS MLE", "dN/dS UB", "p-asmp"]
    np.testing.assert_array_equal(sharded, chunked)

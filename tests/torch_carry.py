"""Helpers of the port's tests: carry the JAX package's global fits into
the port, so that both packages fit sites from the same global point; and
write the fixtures both packages read (a partitioned NEXUS, an alignment
simulated under the multi-hit model)."""

import numpy as np

import hyphy_tpu_torch.methods.common as tcommon
from hyphy_tpu_torch.convert import params_from_numpy
from hyphy_tpu_torch.data.genetic_code import GeneticCode
from hyphy_tpu_torch.models import frequencies as tfreq
from hyphy_tpu_torch.models.codon import MG94xREVPartitionedOmega
from hyphy_tpu_torch.models.dna import GTR
from hyphy_tpu_torch.tree.topology import Tree
from hyphy_tpu_torch.utils.simulate import simulate_states, states_to_alignment
from hyphy_tpu_torch.utils.synth import random_tree_newick, synthetic_codon_alignment


def _params(jparams):
    return params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu")


def carried_gtr(jgtr):
    """The JAX run's (joint) GTR fit as the port's."""
    parts = [
        tcommon.GTRFit(
            loglik=g.loglik, params=_params(g.params),
            branch_lengths=np.asarray(g.branch_lengths), frequencies=np.asarray(g.frequencies),
            n_parameters=g.n_parameters, model=GTR(np.asarray(g.frequencies), device="cpu"))
        for g in jgtr.parts
    ]
    return tcommon.MultiGTRFit(loglik=jgtr.loglik, parts=parts, n_parameters=jgtr.n_parameters)


def carried_mg94(jmg, md):
    """The JAX run's (joint) MG94 fit as the port's, on the port's
    (collapsed) data: each partition's model rebuilt from the JAX fit's
    frequencies, branch rates (free, or its scaler times the GTR lengths
    when the fit kept them proportional, as SLAC's does) and multiple-hit
    option."""
    parts = []
    for m, data in zip(jmg.parts, md.parts):
        free = m.model.free_lengths
        model = MG94xREVPartitionedOmega(
            data.genetic_code, m.corner_freqs, m.codon_freqs,
            nuc_lengths=np.array(m.alphas if free else m.model.nuc_lengths),
            branch_groups=data.branch_groups,
            n_groups=m.model.n_groups, free_lengths=free,
            multiple_hits=m.model.multiple_hits, device="cpu")
        parts.append(tcommon.MG94Fit(
            loglik=m.loglik, params=_params(m.params),
            branch_lengths=np.array(m.branch_lengths), alphas=np.array(m.alphas),
            betas=np.asarray(m.betas), omegas=np.asarray(m.omegas),
            corner_freqs=np.asarray(m.corner_freqs), codon_freqs=np.asarray(m.codon_freqs),
            n_parameters=m.n_parameters, model=model))
    return tcommon.MultiMG94Fit(loglik=jmg.loglik, parts=parts, omegas=parts[0].omegas,
                                n_parameters=jmg.n_parameters)


def spy_fits(jcommon, mp, seen):
    """Record the JAX run's ``fit_gtr_multi`` (before the zero-length
    collapse) and ``fit_partitioned_mg94_multi`` results in ``seen``."""
    for name in ("fit_gtr_multi", "fit_partitioned_mg94_multi"):
        original = getattr(jcommon, name)

        def wrapped(*args, _original=original, _name=name, **kwargs):
            seen[_name] = _original(*args, **kwargs)
            return seen[_name]

        mp.setattr(jcommon, name, wrapped)


def carry_into(monkeypatch, seen):
    """Replace the port's global fits by the JAX run's recorded ones."""
    monkeypatch.setattr(tcommon, "fit_gtr_multi",
                        lambda md, precision=1e-5: carried_gtr(seen["fit_gtr_multi"]))
    monkeypatch.setattr(
        tcommon, "fit_partitioned_mg94_multi",
        lambda md, gtr, precision=1e-5, **options:
            carried_mg94(seen["fit_partitioned_mg94_multi"], md))


def calls(table):
    """Site calls: p <= 0.1, with the sign of beta - alpha."""
    return np.where(table[:, 4] <= 0.1, np.sign(table[:, 1] - table[:, 0]), 0)


# The partitioned fixture: 30 codons in three CHARSETs, the second ending
# mid-codon (nucleotide 62), so that codon 21 is snapped into it and the
# third starts at nucleotide 64; one TREE per partition, in order.
CHARSETS = [("one", "1-30"), ("two", "31-62"), ("three", "63-90")]


def write_partitioned_nexus(path, n_taxa=6, n_codons=30, seed=11, charsets=CHARSETS):
    aln = synthetic_codon_alignment(n_taxa, n_codons, seed=seed)
    lines = ["#NEXUS", "BEGIN DATA;", f"DIMENSIONS NTAX={n_taxa} NCHAR={3 * n_codons};",
             "FORMAT DATATYPE=DNA;", "MATRIX"]
    lines += [f"{n} {s}" for n, s in zip(aln.names, aln.sequences)]
    lines += [";", "END;", "BEGIN ASSUMPTIONS;"]
    lines += [f"CHARSET {name} = {span};" for name, span in charsets]
    lines += ["END;", "BEGIN TREES;"]
    lines += [f"TREE tree{k} = {random_tree_newick(n_taxa, seed=seed + k)};"
              for k in range(len(charsets))]
    lines += ["END;", ""]
    path.write_text("\n".join(lines))
    return str(path)


def write_simulated_fasta(path, n_taxa, n_codons, seed):
    """A codon alignment simulated under MG94xREV with double and triple
    hits (omega 0.3, delta 0.2, psi 0.1) on ``random_tree_newick(n_taxa,
    seed, mean_branch=0.15)``: unlike ``synthetic_codon_alignment``'s random
    codon replacements, its multi-hit fit has a well-defined optimum.
    Returns (fasta path, newick)."""
    gc = GeneticCode("Universal")
    newick = random_tree_newick(n_taxa, seed=seed, mean_branch=0.15)
    tree = Tree.from_newick(newick)
    corners = np.array([[0.3, 0.2, 0.25, 0.25], [0.25, 0.3, 0.2, 0.25],
                        [0.2, 0.25, 0.3, 0.25]]).T
    codon_freqs = tfreq._codon_from_corners(corners, gc)
    nb = tree.n_branches
    model = MG94xREVPartitionedOmega(
        gc, corners, codon_freqs, nuc_lengths=np.full(nb, 0.1),
        branch_groups=np.zeros(nb, dtype=np.int64), n_groups=1, free_lengths=True,
        multiple_hits="Double+Triple", device="cpu")
    point = {"theta_AC": 0.5, "theta_AT": 0.4, "theta_CG": 0.6, "theta_CT": 2.0,
             "theta_GT": 0.5, "omega": [0.3], "delta": 0.2, "psi": 0.1,
             "alpha": 3.0 * np.array(tree.input_lengths[:-1])}
    params = params_from_numpy({k: np.asarray(v, dtype=np.float64) for k, v in point.items()},
                               "cpu")
    p = model.build(params, nb).p_matrices.numpy()
    states = simulate_states(tree, p, codon_freqs, n_codons, np.random.default_rng(seed))
    names, seqs = states_to_alignment(states, tree, "codon", gc)
    path.write_text("".join(f">{n}\n{s}\n" for n, s in zip(names, seqs)))
    return str(path), newick

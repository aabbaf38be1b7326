"""Helpers of the port's tests: carry the JAX package's global fits into
the port, so that both packages fit sites from the same global point; and
write the fixtures both packages read (a partitioned NEXUS, an alignment
simulated under the multi-hit model, a nucleotide alignment with a planted
recombination breakpoint)."""

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
    parts = [carried_mg94_fit(m, data) for m, data in zip(jmg.parts, md.parts)]
    return tcommon.MultiMG94Fit(loglik=jmg.loglik, parts=parts, omegas=parts[0].omegas,
                                n_parameters=jmg.n_parameters)


def carried_mg94_fit(m, data):
    """One JAX MG94 fit as the port's, on the port's ``data``."""
    free = m.model.free_lengths
    model = MG94xREVPartitionedOmega(
        data.genetic_code, m.corner_freqs, m.codon_freqs,
        nuc_lengths=np.array(m.alphas if free else m.model.nuc_lengths),
        branch_groups=data.branch_groups,
        n_groups=m.model.n_groups, free_lengths=free,
        multiple_hits=m.model.multiple_hits, device="cpu")
    return tcommon.MG94Fit(
        loglik=m.loglik, params=_params(m.params),
        branch_lengths=np.array(m.branch_lengths), alphas=np.array(m.alphas),
        betas=np.asarray(m.betas), omegas=np.asarray(m.omegas),
        corner_freqs=np.asarray(m.corner_freqs), codon_freqs=np.asarray(m.codon_freqs),
        n_parameters=m.n_parameters, model=model)


def carried_busted(jparams, jmg, data):
    """A JAX BUSTED parameter dict (named scalars and the ``t`` vector) and
    its MG94 fit as the port's: (params, MG94Fit), so that both packages
    evaluate the same point."""
    return _params(jparams), carried_mg94_fit(jmg, data)


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


def _clade_members(tree, node):
    """Node ids of the subtree under ``node`` (``node`` included)."""
    out, stack = [], [node]
    while stack:
        nd = stack.pop()
        out.append(nd)
        stack.extend(tree.children[nd])
    return out


def pick_clades(tree, sizes):
    """Disjoint clades, one per target leaf count in ``sizes``: for each in
    turn, the non-root node whose leaf count is nearest (lowest id on
    ties) among those outside and not above the clades already taken.
    Returns the clades' node lists."""
    leaves = {nd: sum(1 for m in _clade_members(tree, nd) if tree.is_leaf(m))
              for nd in range(tree.n_nodes) if nd != tree.root}
    taken, clades = set(), []
    for size in sizes:
        free = [nd for nd in leaves
                if not set(_clade_members(tree, nd)) & taken
                and not any(nd in _clade_members(tree, c[0]) for c in clades)]
        best = min(free, key=lambda nd: (abs(leaves[nd] - size), nd))
        clades.append(_clade_members(tree, best))
        taken |= set(clades[-1])
    return clades


def labelled_newick(tree, lengths, node_labels):
    """``tree`` as newick with ``lengths`` per branch and ``{label}`` after
    the name of every node in ``node_labels`` (node id -> label)."""
    def fmt(nd):
        base = tree.names[nd] if tree.is_leaf(nd) else (
            "(" + ",".join(fmt(c) for c in tree.children[nd]) + ")" + tree.names[nd])
        if nd in node_labels:
            base += "{" + node_labels[nd] + "}"
        if nd != tree.root:
            base += f":{lengths[nd]:.6f}"
        return base

    return fmt(tree.root)


def contrast_alignment(n_taxa, n_codons, seed, clade_sizes, labels, planted,
                       fg_omega=5.0, omega=0.3, kappa=2.5, mean_branch=0.05):
    """A codon alignment for the contrast methods: disjoint clades of
    ``random_tree_newick(n_taxa, seed, mean_branch)`` near ``clade_sizes`` leaves
    labelled ``labels`` (every branch of a clade, its stem included; the
    other branches are background), codons simulated along it with
    ``utils/simulate.py::simulate_states`` under MG94-style propagators
    (``synth._mg94_generator``'s unit-rate generator at omega ``omega``)
    everywhere, except omega ``fg_omega`` at the same synonymous rate on the
    first label's branches at the ``planted`` codons.
    Returns (names, sequences, labelled newick)."""
    import scipy.linalg as sla

    from hyphy_tpu_torch.utils import synth

    gc = GeneticCode("Universal")
    tree = Tree.from_newick(random_tree_newick(n_taxa, seed=seed, mean_branch=mean_branch))
    lengths = np.maximum(np.asarray(tree.input_lengths[:-1]), 1e-6)
    clades = pick_clades(tree, clade_sizes)
    node_labels = {nd: lbl for lbl, clade in zip(labels, clades) for nd in clade}
    pi = np.full(gc.n_states, 1.0 / gc.n_states)
    slow = synth._mg94_generator(gc, kappa, omega)
    # omega fg_omega at the same synonymous rate: the non-synonymous entries
    # of the unit-rate omega generator scaled by fg_omega / omega
    amino = np.array(list(gc.translation))[np.asarray(gc.sense_codons)]
    nonsyn = amino[:, None] != amino[None, :]
    fast = np.where(nonsyn, slow * (fg_omega / omega), slow)
    np.fill_diagonal(fast, 0.0)
    fast -= np.diag(fast.sum(axis=1))
    base = np.stack([sla.expm(slow * t) for t in lengths])
    selected = base.copy()
    for nd in clades[0]:
        selected[nd] = sla.expm(fast * lengths[nd])
    rng = np.random.default_rng(seed)
    cols = np.setdiff1d(np.arange(n_codons), planted)
    states = np.zeros((tree.n_nodes, n_codons), dtype=np.int32)
    states[:, cols] = simulate_states(tree, base, pi, len(cols), rng)
    states[:, list(planted)] = simulate_states(tree, selected, pi, len(planted), rng)
    names, seqs = states_to_alignment(states, tree, "codon", gc)
    return names, seqs, labelled_newick(tree, lengths, node_labels)


def fade_generator(q_unit, pi, target, rate, bias):
    """FADE's biased generator (``fade.rate.modifier``, FADE.bf:359-377) of
    the unit-rate generator ``q_unit`` with stationary ``pi``, toward residue
    index ``target``: numpy, for simulating a planted block."""
    toward, away = bias / -np.expm1(-bias), bias / np.expm1(bias)
    off = q_unit - np.diag(np.diag(q_unit))
    mult = np.ones_like(off)
    mult[:, target] = toward
    mult[target, :] = away
    mult[target, target] = 1.0
    q = rate * off * mult
    return q - np.diag(q.sum(axis=1))


def protein_alignment(n_taxa, n_sites, seed, model="WAG", mean_branch=0.2,
                      planted=(), clade=None, target="K", rate=1.0, bias=10.0):
    """A protein alignment simulated with ``utils/simulate.py::
    simulate_states`` along ``random_tree_newick(n_taxa, seed, mean_branch)``
    under the empirical ``model`` at unit mean rate (``scipy.linalg.expm``),
    except that at the ``planted`` sites the branches of ``clade`` (node ids)
    evolve under FADE's biased generator toward ``target`` at ``rate`` and
    ``bias``.  Returns (names, sequences, newick)."""
    import scipy.linalg as sla

    from hyphy_tpu_torch.data.genetic_code import AMINO_ACIDS
    from hyphy_tpu_torch.models.protein import load_empirical, rate_matrix_from_pairs

    newick = random_tree_newick(n_taxa, seed=seed, mean_branch=mean_branch)
    tree = Tree.from_newick(newick)
    data = load_empirical(model)
    pi = np.asarray(data["frequencies"], dtype=np.float64)
    pi = pi / pi.sum()
    q = rate_matrix_from_pairs(data["rates"]) * pi[None, :]
    q -= np.diag(q.sum(axis=1))
    q /= -(pi * np.diag(q)).sum()
    times = np.asarray(tree.input_lengths[:-1])
    p = np.stack([sla.expm(q * t) for t in times])
    rng = np.random.default_rng(seed)
    states = simulate_states(tree, p, pi, n_sites, rng)
    planted = list(planted)
    if planted:
        qb = fade_generator(q, pi, AMINO_ACIDS.index(target), rate, bias)
        pb = p.copy()
        for nd in clade:
            if nd != tree.root:
                pb[nd] = sla.expm(qb * times[nd])
        states[:, planted] = simulate_states(tree, pb, pi, len(planted), rng)
    names, seqs = states_to_alignment(states, tree, "protein")
    return names, seqs, newick


def write_recombinant_fasta(path, n_taxa, half, seeds, mean_branch=0.05, seed=7):
    """A nucleotide alignment with one planted breakpoint: each half of
    ``half`` sites simulated under GTR (``utils/simulate.py``; AC, AG, AT,
    CG, CT, GT rates 1, 4, 1, 1, 4, 1, frequencies 0.3, 0.2, 0.25, 0.25)
    along its own ``random_tree_newick(n_taxa, seeds[k], mean_branch)``,
    the halves joined per taxon.  Returns the FASTA path."""
    import scipy.linalg as sla

    pi = np.array([0.3, 0.2, 0.25, 0.25])
    q = np.zeros((4, 4))
    for r, (i, j) in zip((1.0, 4.0, 1.0, 1.0, 4.0, 1.0),
                         [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]):
        q[i, j], q[j, i] = r * pi[j], r * pi[i]
    np.fill_diagonal(q, -q.sum(axis=1))
    q /= -(pi * np.diag(q)).sum()                  # unit expected rate
    rng = np.random.default_rng(seed)
    seqs = {}
    for tree_seed in seeds:
        tree = Tree.from_newick(random_tree_newick(n_taxa, seed=tree_seed,
                                                   mean_branch=mean_branch))
        lengths = np.maximum(np.asarray(tree.input_lengths[:-1]), 1e-6)
        p = np.stack([sla.expm(q * t) for t in lengths])
        names, part = states_to_alignment(simulate_states(tree, p, pi, half, rng), tree,
                                          "nucleotide")
        for name, s in zip(names, part):
            seqs[name] = seqs.get(name, "") + s
    order = sorted(seqs, key=lambda name: int(name[1:]))
    path.write_text("".join(f">{n}\n{seqs[n]}\n" for n in order))
    return str(path)

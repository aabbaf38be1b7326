"""The port's simulation against the JAX package's:
``simulated_codon_alignment`` gives the same alignment and tree for a
seed, and ``simulate.run`` with the JAX run's GTR and MG94 fits carried
across writes the same replicate alignments."""

import types

import numpy as np
import pytest
import torch

import hyphy_tpu.methods.common as jcommon
from hyphy_tpu.methods import simulate as jsimulate
from hyphy_tpu.utils import synth as jsynth
import hyphy_tpu_torch.methods.common as tcommon
from hyphy_tpu_torch.config import settings
from hyphy_tpu_torch.methods import simulate
from hyphy_tpu_torch.utils import synth
from torch_carry import carried_gtr, carried_mg94

torch.set_num_threads(2)


@pytest.mark.parametrize("planted", [False, True])
def test_simulated_codon_alignment_identical(planted):
    omegas = None
    if planted:
        omegas = np.full(24, 0.3)
        omegas[[3, 10, 17]] = 5.0
    ref, ref_newick = jsynth.simulated_codon_alignment(7, 24, seed=5, site_omegas=omegas)
    ours, newick = synth.simulated_codon_alignment(7, 24, seed=5, site_omegas=omegas)
    assert newick == ref_newick
    assert ours.names == ref.names and ours.sequences == ref.sequences
    assert len(ours.sequences[0]) == 3 * 24


def test_simulate_run_matches_with_carried_fits(tmp_path, monkeypatch):
    aln, newick = jsynth.simulated_codon_alignment(6, 20, seed=9, mean_branch=0.1)
    fasta = tmp_path / "in.fasta"
    fasta.write_text("".join(f">{n}\n{s}\n" for n, s in zip(aln.names, aln.sequences)))
    monkeypatch.setenv("HYPHY_TPU_PROGRESS", "0")
    seen = {}
    for name in ("fit_gtr", "fit_partitioned_mg94"):
        original = getattr(jcommon, name)

        def wrapped(*args, _original=original, _name=name, **kwargs):
            seen[_name] = _original(*args, **kwargs)
            return seen[_name]

        monkeypatch.setattr(jcommon, name, wrapped)
    ref = jsimulate.run(str(fasta), tree=newick, replicates=2, sites=15, seed=3,
                        output=str(tmp_path / "jax"))

    def one(fit):
        return types.SimpleNamespace(parts=[fit], loglik=fit.loglik,
                                     n_parameters=fit.n_parameters)

    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setattr(tcommon, "fit_gtr", lambda data, precision=1e-5:
                        carried_gtr(one(seen["fit_gtr"])).parts[0])
    monkeypatch.setattr(tcommon, "fit_partitioned_mg94", lambda data, gtr, precision=1e-5:
                        carried_mg94(one(seen["fit_partitioned_mg94"]),
                                     types.SimpleNamespace(parts=[data])).parts[0])
    ours = simulate.run(str(fasta), tree=newick, replicates=2, sites=15, seed=3,
                        output=str(tmp_path / "port"))
    assert [f.replace("port", "jax") for f in ours.files] == ref.files
    for a, b in zip(ours.files, ref.files):
        text = open(a).read()
        assert text == open(b).read()
        assert text.count(">") == 6 and len(text.splitlines()[1]) == 3 * 15
    assert ours.json["settings"] == ref.json["settings"]
    assert sorted(ours.json) == sorted(ref.json)

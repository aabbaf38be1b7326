"""``correct`` comes out false when the timed path is broken underneath: a
run of each cell (the chip check skipped, the port on the CPU at 12 taxa x
16 codons), with the cell's own limits, once per fault that the cell can
have: half of the batch left out and the mean of the rest put in its place,
and an answer altered where it is produced.  (The cells hold no training
state to leave unchanged and run on one chip, with no exchange to leave
out.)"""

import time

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import small


def _half_mean(fn):
    def broken(*a, **k):
        out = fn(*a, **k)
        half = out.shape[-1] // 2
        rest = out[..., :half].mean(-1, keepdim=True)
        return torch.cat([out[..., :half], rest.expand(out[..., half:].shape)], dim=-1)
    return broken


def _altered(fn):
    def broken(*a, **k):
        out = fn(*a, **k)
        return out + torch.nn.functional.one_hot(
            torch.tensor(out.shape[-1] // 3), out.shape[-1]).to(out.dtype).to(out.device)
    return broken


FAULTS = {"half_batch_mean": _half_mean, "answer_altered": _altered}
# where each cell's answers are produced: the per-site route (fp64 on the
# CPU) and the gene pruning
TARGETS = {"fel-codon.sites": "single_site_log_likelihood_spectral",
           "fel-codon.gene": "site_log_likelihoods",
           "busted-codon.gene": "site_log_likelihoods"}


def _run(manifest, workload):
    cell = small(manifest, workload)
    return harness.run(cell, 777, 1.5, False, time.perf_counter(), device="cpu")


@pytest.mark.parametrize("workload", sorted(TARGETS))
def test_sound_run_is_correct(manifest, workload):
    assert _run(manifest, workload)["correct"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(TARGETS))
def test_fault_is_caught(manifest, workload, fault, monkeypatch):
    from hyphy_tpu_torch.ops import pruning

    name = TARGETS[workload]
    monkeypatch.setattr(pruning, name, FAULTS[fault](getattr(pruning, name)))
    result = _run(manifest, workload)
    assert not result["correct"], result["checks"]

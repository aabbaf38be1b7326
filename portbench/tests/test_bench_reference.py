"""The plain reference against the port in fp64 on the CPU, at 12 taxa x 16
codons: the per-site objective at the window's Nelder-Mead points, and the
gene lnL and gradient of the MG94xREV and BUSTED fits at points the
optimizers visited.  Each cell is driven by the harness as on the card."""

import time

import pytest

from portbench import harness
from portbench.tests.conftest import small

FP64 = {"site_lnl_gap": 1e-9, "lnl_gap": 1e-6, "grad_gap": 1e-6}


@pytest.mark.parametrize("workload", ["fel-codon.sites", "fel-codon.gene", "busted-codon.gene"])
def test_reference_agrees_with_the_port_in_fp64(manifest, workload):
    cell = small(manifest, workload, limits=FP64)
    result = harness.run(cell, 20261019, 1.5, False, time.perf_counter(), device="cpu")
    assert result["attempted"] > 0 and result["failed"] == 0
    for name, check in result["checks"].items():
        assert check["value"] <= FP64[name], (name, check)
    assert result["correct"]

"""The global MG94xREV fit of every codon method
(``common.fit_partitioned_mg94``: CF3x4 frequencies, the stage with one
branch-length scaler, then one synonymous rate per branch; host L-BFGS-B
through ``optimize.core.maximize``), started from the generating GTR
point."""

from __future__ import annotations

from portbench import program

KIND = "gene"


class Stage:
    def __init__(self, inputs, device):
        self.data = program.load(inputs, device)
        self.gtr = program.gtr_point(inputs, device)

    def run(self, window) -> None:
        from hyphy_tpu_torch.methods import common
        from hyphy_tpu_torch.optimize import core

        def wrapped(original):
            return lambda objective, *a, **k: original(window.gene_objective(objective), *a, **k)

        with program.swapped(core, "maximize", wrapped):
            common.fit_partitioned_mg94(self.data, self.gtr)

    def release(self) -> None:
        self.data = self.gtr = None

"""FEL's per-site stage (``fel.solve_partition`` after the global fits):
the start grid, the alternative and the null Nelder-Mead over every pattern
of the gene at once, at the program's defaults (``--srv Yes``, all branches
tested), started from the generating MG94xREV point."""

from __future__ import annotations

from portbench import program

KIND = "site"


class Stage:
    def __init__(self, inputs, device):
        self.data = program.load(inputs, device)
        self.mg94 = program.mg94_point(inputs, self.data, device)

    def run(self, window) -> None:
        from hyphy_tpu_torch.methods import fel

        def wrapped(original):
            return lambda objective, *a, **k: original(window.site_objective(objective), *a, **k)

        with program.swapped(fel, "grid_best_starts", wrapped), \
                program.swapped(fel, "vmapped_nelder_mead", wrapped):
            fel.solve_partition(self.data, self.mg94)

    def release(self) -> None:
        self.data = self.mg94 = None

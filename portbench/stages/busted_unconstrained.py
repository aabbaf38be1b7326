"""BUSTED's unconstrained mixture fit (``busted.fit_unconstrained`` through
``optimize.core.maximize_jax``) at the port's defaults: 3 omega classes,
synonymous rate variation with 3 classes, 5 starting points.  The objective,
the parameter space and the candidates are the ones ``busted.run`` builds,
taken from it at the call; its GTR and MG94xREV stages are handed the
generating point instead of fitting it."""

from __future__ import annotations

from portbench import program

KIND = "gene"


class _Captured(Exception):
    pass


class Stage:
    def __init__(self, inputs, device):
        from hyphy_tpu_torch.methods import busted, common

        gtr = program.gtr_point(inputs, device)
        fit = {}

        def capture(original):
            def fit_unconstrained(loglik, specs, candidates, starting_points, precision):
                fit.update(loglik=loglik, specs=specs, candidates=candidates,
                           starting_points=starting_points, precision=precision)
                raise _Captured
            return fit_unconstrained

        with program.swapped(common, "fit_gtr", lambda _: lambda *a, **k: gtr), \
                program.swapped(common, "fit_partitioned_mg94",
                                lambda _: lambda data, *a, **k: program.mg94_point(
                                    inputs, data, device)), \
                program.swapped(busted, "fit_unconstrained", capture):
            try:
                busted.run(inputs.fasta, tree=inputs.data.newick,
                           seed=int(inputs.seed) % (1 << 32), device=device)
            except _Captured:
                pass
        self.fit = fit

    def run(self, window) -> None:
        from hyphy_tpu_torch.methods import busted

        f = self.fit
        busted.fit_unconstrained(window.gene_objective(f["loglik"]), f["specs"],
                                 f["candidates"], f["starting_points"], f["precision"])

    def release(self) -> None:
        self.fit = None

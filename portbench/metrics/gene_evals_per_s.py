"""gene_evals_per_s: gene-likelihood evaluations (one pruning over every
pattern, with its gradient where the fit takes one) completed in the
window, over the window's wall time."""


def read(ctx):
    n = sum(1 for c in ctx.window.calls if c.kind == "gene")
    return n / ctx.window.wall_s if n else None

"""site_evals_per_s: the items of every batched per-site objective
evaluation completed in the window, summed, over the window's wall time."""


def read(ctx):
    items = sum(c.items for c in ctx.window.calls if c.kind == "site")
    return items / ctx.window.wall_s if items else None

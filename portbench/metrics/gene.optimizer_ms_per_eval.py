"""gene.optimizer_ms_per_eval: the window's wall milliseconds not covered by
the evaluations' own device spans (``gene.eval_ms``'s events), per
evaluation: the fit's host work between evaluations and what waits on it."""


def read(ctx):
    calls = [c for c in ctx.window.calls if c.kind == "gene"]
    spans = [c.start.elapsed_time(c.end) for c in calls
             if c.start is not None and c.end is not None]
    if not calls or len(spans) != len(calls):
        return None
    return (ctx.window.wall_s * 1e3 - sum(spans)) / len(calls)

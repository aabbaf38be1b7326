"""sites.objective_roofline: the least work of one batched per-site
evaluation (``roofline.site_objective`` at the window's mean item count)
at the card's peaks, over ``sites.objective_ms``, in percent."""

from portbench import roofline


def read(ctx):
    calls = [c for c in ctx.window.calls
             if c.kind == "site" and c.start is not None and c.end is not None]
    if not calls:
        return None
    ms = sum(c.start.elapsed_time(c.end) for c in calls) / len(calls)
    items = sum(c.items for c in calls) / len(calls)
    s = ctx.shapes
    count = roofline.site_objective(items, s["branches"], s["groups"], s["states"], s["taxa"],
                                    s["itemsize"])
    return roofline.share(count, ms * 1e-3)

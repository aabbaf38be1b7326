"""k1.roofline: the least work of K1's level products for every gene
evaluation of the traced window (``roofline.level_products``: the tree's
children, the patterns, the states, the classes folded into K1's node
axis), at the card's peaks, over K1's kernel time summed by name in the
profiler, in percent."""

from portbench import roofline

KERNEL = "level_products_kernel"


def read(ctx):
    n = sum(1 for c in ctx.window.calls if c.kind == "gene")
    if ctx.trace is None or not n:
        return None
    seconds = ctx.trace.seconds_of(KERNEL)
    if seconds <= 0.0:
        return None
    s = ctx.shapes
    count = roofline.level_products(s["children"], s["patterns"], s["states"], s["classes"],
                                    s["itemsize"])
    return roofline.share({k: v * n for k, v in count.items()}, seconds)

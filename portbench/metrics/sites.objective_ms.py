"""sites.objective_ms: device milliseconds between the CUDA events recorded
before and after each batched per-site evaluation, mean over the window."""


def read(ctx):
    ms = [c.start.elapsed_time(c.end) for c in ctx.window.calls
          if c.kind == "site" and c.start is not None and c.end is not None]
    return sum(ms) / len(ms) if ms else None

"""sites.host_ms_per_eval: host milliseconds to issue one batched per-site
evaluation (host clock around the objective call, no synchronize), mean
over the window."""


def read(ctx):
    ms = [c.host_s * 1e3 for c in ctx.window.calls if c.kind == "site"]
    return sum(ms) / len(ms) if ms else None

"""idle_share.sites: percent of the traced window of a per-site cell in
which no operation ran on the device (torch.profiler)."""


def read(ctx):
    if ctx.trace is None or not any(c.kind == "site" for c in ctx.window.calls):
        return None
    return 100.0 * ctx.trace.idle_share

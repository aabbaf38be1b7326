"""gene.eval_ms: device milliseconds from the CUDA event recorded as a gene
evaluation starts to the one recorded when its gradient reached the last
parameter (the value's end where no gradient is taken), mean."""


def read(ctx):
    ms = [c.start.elapsed_time(c.end) for c in ctx.window.calls
          if c.kind == "gene" and c.start is not None and c.end is not None]
    return sum(ms) / len(ms) if ms else None

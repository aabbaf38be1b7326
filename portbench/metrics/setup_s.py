"""setup_s: seconds from the start of the process to the first instant of
the window (imports, inputs, the program's set-up, warm-up)."""


def read(ctx):
    return ctx.setup_s

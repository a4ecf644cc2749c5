"""setup_s: seconds from the process's start to the window's start (imports,
the kernel library, the data, the warm-up job)."""


def read(ctx):
    return ctx.setup_s

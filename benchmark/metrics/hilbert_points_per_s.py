"""hilbert_points_per_s: the coreset points (M a build) of the window's
completed Hilbert builds over the window's seconds."""


def read(ctx):
    return ctx.window.rate() if ctx.job.kind == "hilbert" else None

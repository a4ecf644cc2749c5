"""hilbert.construct_ms: mean wall ms of ``HilbertCoreset(...)`` per build of
the traced run's window (the projection and the constants, or the streamed
chunks, their projection and quantization), from the benchmark's spans, each
ended by a synchronize."""


def read(ctx):
    spans = getattr(ctx.job, "spans", None)
    if ctx.job.kind != "hilbert" or not spans:
        return None
    return 1e3 * sum(s["construct_s"] for s in spans) / len(spans)

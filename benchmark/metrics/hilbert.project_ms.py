"""hilbert.project_ms: mean ms per build of the device interval of the
program's span ``hilbert.project`` (the projection through b and the valid
mask; streamed: the sentinel probe and the chunks' copies, projection and
quantization), over the spans' jobs (:mod:`benchmark.program_spans`)."""

from benchmark import program_spans as ps


def read(ctx):
    got = ps.collect(ctx)
    if got is None:
        return None
    spans = ps.named(got["spans"], "hilbert.project")
    return 1e3 * ps.device_s(spans) / got["jobs"] if spans else None

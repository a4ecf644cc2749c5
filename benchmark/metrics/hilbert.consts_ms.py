"""hilbert.consts_ms: mean ms per build of the device interval of the
program's span ``hilbert.consts`` (``make_consts`` or
``make_consts_quantized``, the selection copy, and the solver's
construction), over the spans' jobs (:mod:`benchmark.program_spans`)."""

from benchmark import program_spans as ps


def read(ctx):
    got = ps.collect(ctx)
    if got is None:
        return None
    spans = ps.named(got["spans"], "hilbert.consts")
    return 1e3 * ps.device_s(spans) / got["jobs"] if spans else None

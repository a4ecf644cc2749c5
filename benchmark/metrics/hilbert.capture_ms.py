"""hilbert.capture_ms: mean host ms per build in the program's
``graphs.capture`` spans under ``hilbert.solve`` (graphs captured and
instantiated again: int8-resident constants keep graph sets of their own),
over the spans' jobs (:mod:`benchmark.program_spans`).  None where no graph
was replayed (on the CPU)."""

from benchmark import program_spans as ps

CARD_ONLY = True            # only the card captures graphs


def read(ctx):
    got = ps.collect(ctx)
    if got is None or not ps.named(got["spans"], "graphs.replay"):
        return None
    return 1e3 * ps.host_s(ps.under(got["spans"], "graphs.capture", "hilbert.solve")) / got["jobs"]

"""hilbert.off_graph_pct: the share of the builds' ``hilbert.solve`` device
intervals that lies outside the replayed graphs (its ``graphs.replay``
spans): the host reads after the segments, the launches between pieces, the
copy-ins, the captures and the active set's read, in percent, measured with
the program's CUDA events and no profiler (:mod:`benchmark.program_spans`).
None where no graph was replayed (on the CPU)."""

from benchmark import program_spans as ps

CARD_ONLY = True            # only the card replays graphs


def read(ctx):
    got = ps.collect(ctx)
    if got is None:
        return None
    solve = ps.device_s(ps.named(got["spans"], "hilbert.solve"))
    replays = ps.under(got["spans"], "graphs.replay", "hilbert.solve")
    if not replays or solve <= 0:
        return None
    return 100.0 * (1.0 - ps.device_s(replays) / solve)

"""hilbert.replay_itr_ms: device ms inside replayed graphs per solver
iteration: the device intervals of the program's ``graphs.replay`` spans
under ``hilbert.solve``, summed, over the iterations run (``snnls.itrs_run``),
over the spans' jobs (:mod:`benchmark.program_spans`).  In-graph time, where
``hilbert.itr_ms`` is the wall time of ``build(M)``.  None where no graph was
replayed (on the CPU)."""

from benchmark import program_spans as ps

CARD_ONLY = True            # only the card replays graphs


def read(ctx):
    got = ps.collect(ctx)
    if got is None or not got["itrs"]:
        return None
    replays = ps.under(got["spans"], "graphs.replay", "hilbert.solve")
    return 1e3 * ps.device_s(replays) / got["itrs"] if replays else None

"""hilbert.step_mfu: the least time the card needs for one GIGA iteration's
work, counted from shapes (``roofline.giga_iteration_work``: the selection
copy read once, the O(S) vectors, the dots), over the measured
``hilbert.itr_ms``, in percent."""

from benchmark import roofline
from benchmark.harness import reader


def read(ctx):
    itr_ms = reader("hilbert.itr_ms")(ctx)
    if itr_ms is None:
        return None
    sh = ctx.job.shapes()
    nbytes, ops = roofline.giga_iteration_work(sh["n"], sh["Sp"], sh["S"], sh["select_dtype"])
    least_s, _ = roofline.bound(nbytes, ops, sh["select_dtype"])
    return 100.0 * least_s / (1e-3 * itr_ms)

"""hilbert.itr_ms: wall ms of ``build(M)`` over the solver iterations it ran
(the program's counter ``snnls.itrs_run``), over the traced run's window."""


def read(ctx):
    spans = getattr(ctx.job, "spans", None)
    if ctx.job.kind != "hilbert" or not spans:
        return None
    itrs = sum(s["itrs"] for s in spans)
    return 1e3 * sum(s["build_s"] for s in spans) / itrs if itrs else None

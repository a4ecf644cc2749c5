"""select_roofline: the GIGA select kernel's least time
(``roofline.select_work``: its bytes read once at the HBM rate) over its mean
device time per launch in the traced stretch, by kernel name, in percent."""

from benchmark import roofline

KERNEL = "giga_select"      # giga_select_kernel and giga_select_wide_kernel
CARD_ONLY = True            # the select kernel's launches are read from the card's trace


def read(ctx):
    if ctx.trace is None or ctx.job.kind != "hilbert":
        return None
    k = ctx.trace.matching(KERNEL)
    if not k.count or k.seconds <= 0:
        return None
    sh = ctx.job.shapes()
    nbytes, ops = roofline.select_work(sh["n"], sh["Sp"], sh["S"], sh["select_dtype"])
    least_s, _ = roofline.bound(nbytes, ops, sh["select_dtype"])
    return 100.0 * least_s / (k.seconds / k.count)

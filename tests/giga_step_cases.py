"""States of a GIGA build that decide each branch of one iteration, for the
fused step's tests (``tests/test_torch_giga_step.py`` on the CPU,
``tests/test_torch_cuda.py`` on the card).  Made on the CPU from numpy data
with the port's own build; imports no JAX."""

import numpy as np
import torch

from bayesian_coresets_tpu_torch.ops import fold_scale as fs
from bayesian_coresets_tpu_torch.ops import giga_select as gs
from bayesian_coresets_tpu_torch.ops import giga_step, snnls

TOL = 1e-6

CASES = ["fold", "mid", "fold_mid", "repeat", "overflow", "monotone", "gA", "not_live", "done",
         "int8_resident"]


def _consts(kind, seed=1, n=600, S=64):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(S, n)).astype(np.float32)
    A *= rng.uniform(0.2, 3.0, size=n).astype(np.float32)
    if kind == "gA":            # every row points away from b
        b = rng.normal(size=S).astype(np.float32)
        A = (-b[:, None] + 0.1 * A).astype(np.float32)
        return snnls.make_consts(torch.as_tensor(A), torch.as_tensor(b),
                                 select_dtype=torch.int8)
    if kind == "int8_resident":
        from bayesian_coresets_tpu_torch.parallel import quantize_chunk
        q, nrm, bsum = quantize_chunk(torch.as_tensor(A.T.copy()), n)
        return snnls.make_consts_quantized(q, nrm, bsum.float())
    return snnls.make_consts(torch.as_tensor(A), torch.as_tensor(A.sum(axis=1)),
                             select_dtype=torch.int8)


def problem(consts):
    return snnls._Problem(consts, "giga", TOL, 1024, None, None, None, None, None)


def _carry(consts, K, itrs):
    s = snnls.build(consts, snnls.init_state(consts, K), itrs, TOL) if itrs else \
        snnls.init_state(consts, K)
    return snnls._carry(consts, s, int(s.itr) + 1000)


def _step(p, c):
    """The carry after one iteration of the plain route, on copies."""
    return snnls._iteration(p, clone(c), False)[0]


def _first(p, c, hit, limit=200):
    """The carry before the first iteration from ``c`` whose result meets
    ``hit(before, after)``."""
    for _ in range(limit):
        nxt = _step(p, c)
        if hit(c, nxt):
            return c
        c = nxt
    raise AssertionError("no iteration met the case's condition")


def clone(c):
    return type(c)(*(t.clone() for t in c))


def case(name):
    """(problem, carry) of the case ``name``, CPU tensors."""
    consts = _consts(name)
    p = problem(consts)
    if name in ("fold", "gA"):
        return p, _carry(consts, 64, 0)
    if name == "repeat":        # the selected atom already holds a slot
        return p, _first(p, _carry(consts, 64, 5),
                         lambda a, b: int(b.itr) > int(a.itr) and int(b.size) == int(a.size)
                         and int(b.fail) == 0)
    if name == "overflow":      # a new atom with every slot taken
        return p, _first(p, _carry(consts, 4, 0), lambda a, b: bool(b.done) and not bool(a.done))
    c = _carry(consts, 64, 30)
    if name == "fold_mid":      # a carried scale that the step takes below the floor
        ws = torch.tensor(np.float32(5e-11))
        c = c._replace(w=c.w / ws, wscale=ws)
    elif name == "monotone":    # a cached error the step cannot stay under
        c = c._replace(err=c.err * 0.5)
    elif name == "not_live":
        c = c._replace(itr_end=c.itr.clone())
    elif name == "done":
        c = c._replace(done=torch.ones_like(c.done))
    return p, c


def on(p, c, dev):
    """The problem and carry on ``dev``."""
    consts = snnls.SNNLSConsts(*(t.to(dev) for t in p.consts))
    return p._replace(consts=consts), type(c)(*(t.to(dev) for t in c))


def fused(p, c, plain):
    """One iteration of the fused route from a copy of ``c``: a
    :class:`giga_step.Step` (the kernels on a card), or (``plain``) the plain
    versions, around the select and the fold.  Returns (carry, work)."""
    c = clone(c)
    if not plain:
        step = giga_step.Step(p.consts, c, p.tol)
        step.iterate()
        return c, step.work
    k, work = p.consts, giga_step.work(c.xw)
    giga_step.directions_ref(k, c, work)
    gs.giga_select_into(k.Vsel, work.dirs, k.norms, k.valid, work.f, work.score)
    giga_step.update_ref(k, c, p.tol, work)
    fs.fold_scale(c.w, work.fold, work.ws2)
    giga_step.finish_ref(k, c, work)
    return c, work


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(a, b, names=snnls._Carry._fields):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(bits(x), bits(y)), name


def assert_case(name, before, after, work):
    """The branch that names the case was taken."""
    moved = int(after.itr) - int(before.itr)
    committed = bool(work.commit)
    expect = {
        "fold": moved == 1 and committed and bool(work.fold),
        "mid": moved == 1 and committed and not bool(work.fold),
        "fold_mid": moved == 1 and committed and bool(work.fold),
        "repeat": committed and int(after.size) == int(before.size),
        "overflow": not committed and bool(after.done) and int(after.size) == 4,
        "monotone": not committed and int(after.fail) == int(before.fail) + 1,
        "gA": not committed and int(after.fail) == 1,
        "not_live": moved == 0 and not committed,
        "done": moved == 0 and not committed,
        "int8_resident": moved == 1 and committed,
    }[name]
    assert expect, name
